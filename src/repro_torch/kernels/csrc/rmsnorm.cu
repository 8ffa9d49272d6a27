// Fused RMSNorm: out = x·rsqrt(mean(x²) + eps)·w over the last dim of
// x(R, D), in f32, written in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm -> _rmsnorm_kernel (the
// Pallas kernel that keeps a block of whole rows in one VMEM tile, so x
// is read from HBM once).
//
// What bounds it on an H100: bytes.  Each element costs about four flops
// against a read and a write, so R·D·bytes in and out at 3.35 TB/s is the
// floor; the kernel's job is to read x once, 16 bytes at a time, with
// enough rows in flight to cover the memory's latency.  Rows are short
// next to the TPU's VMEM tile: a model's d_model (2560) or a head (128).
//
// Two forms, chosen here in the C launch (rmsnorm.py::rmsnorm_form
// mirrors the rule):
//
// warp: rows whose bytes and both base pointers (x, out) lie on the
// 16-byte grid, up to WARP_UNITS 16-byte units a row (bf16 D <= 3072,
// f32 D <= 1536).  A group of G lanes takes a row, G the smallest power
// of two >= the row's units up to a warp (qwen3-4b's qk-norm, D = 128
// bf16, is 16 units: 16 lanes a row, two rows a warp; its d_model 2560 is
// 320: a warp, 10 units a lane).  No __syncthreads.
// scalar: any other row (off the 16-byte grid, or longer): a warp a row
// up to 1024 values, else a block; scalar loads.
//
// In the warp form a group takes one row, or, where rows are short, a
// few (about BLOCK_BYTES of x a thread block), issuing the next row's
// loads before it reduces the current one; loads and stores carry the
// streaming (evict-first) hint, since no byte is read twice.  w is read
// once a thread and kept in registers as f32 where the lane's share is
// at most 16 values, else read through L1 for each row.
//
// Order: lane t of a group takes units t, t+G, ... and adds their
// elements in index order, then a shuffle tree over the group (the
// scalar form: then the warps in order), so the order is fixed by the
// launch shape and a repeated call is bit-equal.  rsqrtf (2 ulp) and the
// reassociated f32 sum put the result within rtol=1e-5, atol=1e-5 of a
// plain f32 version in f32; in bf16 the final rounding may move one ulp
// (rtol=atol=1e-2).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over one group of GROUP threads, on every thread of it.  A
// block-wide group (one row per block) goes through shared memory.
template <int GROUP>
__device__ __forceinline__ float group_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (GROUP == 32) {
    return v;
  } else {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[w];
    return t;
  }
}

// The scalar form.  GROUP threads per row (32 or THREADS); VPT values a
// thread keeps in registers, or 0 to read the row twice (rows longer
// than THREADS·32).  Thread t of a group takes elements t, t+G, ...
template <typename T, typename W, int GROUP, int VPT>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, int64_t R, int64_t D, float eps) {
  static_assert(GROUP == 32 || GROUP == THREADS, "a warp or a block a row");
  __shared__ float red[WARPS];
  constexpr int ROWS = THREADS / GROUP;
  const int lane = threadIdx.x % GROUP;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * ROWS + threadIdx.x / GROUP;
  if (r >= R) return;  // only whole warps of the warp-per-row form leave
  const T* row = x + r * D;
  T* orow = out + r * D;

  float v[VPT > 0 ? VPT : 1];
  float sq = 0.0f;
  if constexpr (VPT > 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int64_t i = lane + static_cast<int64_t>(j) * GROUP;
      v[j] = i < D ? to_f32(row[i]) : 0.0f;
      sq = fmaf(v[j], v[j], sq);
    }
  } else {
    for (int64_t i = lane; i < D; i += GROUP) {
      const float a = to_f32(row[i]);
      sq = fmaf(a, a, sq);
    }
  }
  sq = group_sum<GROUP>(sq, red);
  const float inv = rsqrtf(sq / static_cast<float>(D) + eps);

  if constexpr (VPT > 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int64_t i = lane + static_cast<int64_t>(j) * GROUP;
      if (i < D) orow[i] = from_f32<T>(v[j] * inv * to_f32(w[i]));
    }
  } else {
    for (int64_t i = lane; i < D; i += GROUP)
      orow[i] = from_f32<T>(to_f32(row[i]) * inv * to_f32(w[i]));
  }
}

template <typename T, typename W, int GROUP, int VPT>
void launch(const void* x, const void* w, void* out, int64_t R, int64_t D,
            float eps, cudaStream_t s) {
  constexpr int ROWS = THREADS / GROUP;
  const unsigned blocks = static_cast<unsigned>((R + ROWS - 1) / ROWS);
  rmsnorm_kernel<T, W, GROUP, VPT><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), R, D, eps);
}

// The smallest register cache that holds a row: a warp a row up to 1024
// values, a block a row up to 8192, then a block reading twice.
template <typename T, typename W>
void dispatch(const void* x, const void* w, void* out, int64_t R, int64_t D,
              float eps, cudaStream_t s) {
  if (D <= 32 * 4) {
    launch<T, W, 32, 4>(x, w, out, R, D, eps, s);
  } else if (D <= 32 * 8) {
    launch<T, W, 32, 8>(x, w, out, R, D, eps, s);
  } else if (D <= 32 * 16) {
    launch<T, W, 32, 16>(x, w, out, R, D, eps, s);
  } else if (D <= 32 * 32) {
    launch<T, W, 32, 32>(x, w, out, R, D, eps, s);
  } else if (D <= THREADS * 8) {
    launch<T, W, THREADS, 8>(x, w, out, R, D, eps, s);
  } else if (D <= THREADS * 16) {
    launch<T, W, THREADS, 16>(x, w, out, R, D, eps, s);
  } else if (D <= THREADS * 32) {
    launch<T, W, THREADS, 32>(x, w, out, R, D, eps, s);
  } else {
    launch<T, W, THREADS, 0>(x, w, out, R, D, eps, s);
  }
}

constexpr long long WARP_UNITS = 32 * 12;  // longest row of the warp form
// x a thread block of the warp form aims for: groups take several short
// rows each (the qk-norm's 256-byte rows: 8), a d_model row or longer one
constexpr long long BLOCK_BYTES = 32 << 10;

// f32 values as 16 bytes of T
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ uint4 pack<float>(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // round to nearest even, lower address low
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The warp form: G lanes a row (G <= 32: part of a warp or a warp), each
// holding up to VPL 16-byte units of the row.  Group g of the grid takes
// rows g, g + groups, ... (rows_per_group of them).
template <typename T, typename W, int G, int VPL>
__global__ void __launch_bounds__(THREADS, 1)
rms_vec(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
        int64_t R, int64_t D, float eps, int rows_per_group) {
  static_assert(G <= 32 && VPL > 0, "a group within a warp, a unit a lane");
  constexpr int V = 16 / sizeof(T);  // elements a unit
  constexpr int GROUPS = THREADS / G;
  constexpr bool W_REGS = VPL * V <= 16;
  const int lane = threadIdx.x % G;
  // the group's lanes of its warp: groups of one warp leave the row loop
  // apart, so a shuffle names only its own group
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) / G * G);
  const int64_t nv = D / V;  // units a row
  const int64_t groups = static_cast<int64_t>(gridDim.x) * GROUPS;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * GROUPS + threadIdx.x / G;

  float wr[W_REGS ? VPL * V : 1];
  if constexpr (W_REGS) {
#pragma unroll
    for (int s = 0; s < VPL; ++s) {
      const int64_t c = lane + static_cast<int64_t>(s) * G;
#pragma unroll
      for (int j = 0; j < V; ++j) wr[s * V + j] = c < nv ? to_f32(w[c * V + j]) : 0.0f;
    }
  }

  uint4 a[VPL], b[VPL];
  auto load = [&](uint4 (&u)[VPL], int64_t r) {
    const uint4* row = reinterpret_cast<const uint4*>(x + r * D);
#pragma unroll
    for (int s = 0; s < VPL; ++s) {
      const int64_t c = lane + static_cast<int64_t>(s) * G;
      u[s] = c < nv ? __ldcs(row + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // sum of x² over a unit, in index order
  auto add_sq = [&](const uint4& u, float sq) {
    float f[V];
    unpack16(u, f);
#pragma unroll
    for (int j = 0; j < V; ++j) sq = fmaf(f[j], f[j], sq);
    return sq;
  };
  auto scale = [&](const uint4& u, int64_t c, int s, float inv) {
    float f[V];
    unpack16(u, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float wj;
      if constexpr (W_REGS) wj = wr[s * V + j];
      else wj = to_f32(__ldg(w + c * V + j));
      f[j] = f[j] * inv * wj;
    }
    return pack<T>(f);
  };

  if (g0 < R) load(a, g0);
  for (int i = 0; i < rows_per_group; ++i) {
    const int64_t r = g0 + i * groups;
    if (r >= R) break;  // whole groups leave together
    const int64_t rn = r + groups;
    if (i + 1 < rows_per_group && rn < R) load(b, rn);
    float sq = 0.0f;
#pragma unroll
    for (int s = 0; s < VPL; ++s) sq = add_sq(a[s], sq);
    // the group's sum: a shuffle tree inside its G lanes
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      sq += __shfl_xor_sync(gmask, sq, off);
    const float inv = rsqrtf(sq / static_cast<float>(D) + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + r * D);
#pragma unroll
    for (int s = 0; s < VPL; ++s) {
      const int64_t c = lane + static_cast<int64_t>(s) * G;
      if (c < nv) __stcs(orow + c, scale(a[s], c, s, inv));
    }
#pragma unroll
    for (int s = 0; s < VPL; ++s) a[s] = b[s];
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

template <typename T, typename W, int G, int VPL>
int launch_vec(const void* x, const void* w, void* out, int64_t R, int64_t D,
               float eps, cudaStream_t s) {
  constexpr int GROUPS = THREADS / G;
  static const int occupancy = [] {
    int blocks = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rms_vec<T, W, G, VPL>,
                                                  THREADS, 0);
    return blocks > 0 ? blocks : 1;
  }();
  // Rows a group: one for rows of BLOCK_BYTES / 8 and more (short-lived
  // blocks the hardware schedules beat persistent groups there); else
  // enough for BLOCK_BYTES a block, but no more than one wave of groups on
  // the card would take.
  const int64_t most = static_cast<int64_t>(sm_count()) * occupancy * GROUPS;
  const int64_t fill = (R + most - 1) / most;
  const int64_t want = BLOCK_BYTES / (GROUPS * D * static_cast<int64_t>(sizeof(T)));
  const int64_t per = want < 1 ? 1 : (want < fill ? want : fill);
  const int64_t blocks = (R + GROUPS * per - 1) / (GROUPS * per);
  rms_vec<T, W, G, VPL><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out),
      R, D, eps, static_cast<int>(per));
  return launch_status();
}

// units a lane: the smallest compiled count that holds ceil(nv / G)
template <typename T, typename W, int G>
int warp_units(const void* x, const void* w, void* out, int64_t R, int64_t D,
               float eps, cudaStream_t s, int64_t per_lane) {
  if (per_lane <= 1) return launch_vec<T, W, G, 1>(x, w, out, R, D, eps, s);
  if (per_lane <= 2) return launch_vec<T, W, G, 2>(x, w, out, R, D, eps, s);
  if (per_lane <= 4) return launch_vec<T, W, G, 4>(x, w, out, R, D, eps, s);
  if (per_lane <= 6) return launch_vec<T, W, G, 6>(x, w, out, R, D, eps, s);
  if (per_lane <= 8) return launch_vec<T, W, G, 8>(x, w, out, R, D, eps, s);
  if (per_lane <= 10) return launch_vec<T, W, G, 10>(x, w, out, R, D, eps, s);
  return launch_vec<T, W, G, 12>(x, w, out, R, D, eps, s);
}

bool on_grid(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the form's rule (mirrored by rmsnorm.py::rmsnorm_form): warp or scalar
template <typename T, typename W>
int run(const void* x, const void* w, void* out, int64_t R, int64_t D,
        float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int64_t nv = D / V;
  if (D % V != 0 || nv > WARP_UNITS || !on_grid(x) || !on_grid(out)) {
    dispatch<T, W>(x, w, out, R, D, eps, s);
    return launch_status();
  }
  if (nv <= 4) return launch_vec<T, W, 4, 1>(x, w, out, R, D, eps, s);
  if (nv <= 8) return launch_vec<T, W, 8, 1>(x, w, out, R, D, eps, s);
  if (nv <= 16) return launch_vec<T, W, 16, 1>(x, w, out, R, D, eps, s);
  return warp_units<T, W, 32>(x, w, out, R, D, eps, s, (nv + 31) / 32);
}

}  // namespace

extern "C" int repro_rmsnorm(int dtype, int wdtype, const void* x,
                             const void* w, void* out, long long R,
                             long long D, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && wdtype == kFloat32) {
    return run<float, float>(x, w, out, R, D, eps, s);
  } else if (dtype == kFloat32 && wdtype == kBFloat16) {
    return run<float, __nv_bfloat16>(x, w, out, R, D, eps, s);
  } else if (dtype == kBFloat16 && wdtype == kFloat32) {
    return run<__nv_bfloat16, float>(x, w, out, R, D, eps, s);
  } else if (dtype == kBFloat16 && wdtype == kBFloat16) {
    return run<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, eps, s);
  }
  return -1;
}
