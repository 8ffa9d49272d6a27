// Fused RMSNorm: out = x·rsqrt(mean(x²) + eps)·w over the last dim of
// x(R, D), in f32, written in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm -> _rmsnorm_kernel (the
// Pallas kernel that keeps a block of whole rows in one VMEM tile, so x
// is read from HBM once).
//
// What bounds it on an H100: bytes.  Each element costs about four flops
// against a read and a write, so R·D·bytes in and out at 3.35 TB/s is the
// floor; the kernel's job is to read x once.  Rows are short next to the
// TPU's VMEM tile: a model's d_model (2560) or a head (128).
//
// Design: a group of threads per row keeps its row in registers between
// the sum of squares and the scaling, so x is read once.  Rows up to 1024
// take one warp each (8 rows to a 256-thread block, up to 32 values a
// lane); rows up to 8192 take a whole block (up to 32 values a thread).
// Longer rows are still right: the block reads its row a second time for
// the scaling instead of holding it.  Thread t of a group takes elements
// t, t+G, ... (coalesced); its squares are summed in index order, then a
// shuffle tree, then the warps in order, so the order is fixed by the
// launch shape.  rsqrtf (2 ulp) and the reassociated f32 sum put the
// result within rtol=1e-5, atol=1e-5 of a plain f32 version in f32; in
// bf16 the final rounding may move one ulp (rtol=atol=1e-2).
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

// GROUP threads per row (32 or THREADS); VPT values a thread keeps in
// registers, or 0 to read the row twice (rows longer than THREADS·32).
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

}  // namespace

extern "C" int repro_rmsnorm(int dtype, int wdtype, const void* x,
                             const void* w, void* out, long long R,
                             long long D, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && wdtype == kFloat32) {
    dispatch<float, float>(x, w, out, R, D, eps, s);
  } else if (dtype == kFloat32 && wdtype == kBFloat16) {
    dispatch<float, __nv_bfloat16>(x, w, out, R, D, eps, s);
  } else if (dtype == kBFloat16 && wdtype == kFloat32) {
    dispatch<__nv_bfloat16, float>(x, w, out, R, D, eps, s);
  } else if (dtype == kBFloat16 && wdtype == kBFloat16) {
    dispatch<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, eps, s);
  } else {
    return -1;
  }
  return launch_status();
}
