// Per-row f32 (mean, mean of squares) over the last dim of x(R, D).
//
// Replaces: src/repro/kernels/rmsnorm.py, row_moments -> _moments_kernel
// (the Pallas fused reduction that keeps a whole row in one VMEM tile).
//
// What bounds it on an H100: bytes, once the input is large.  Each
// element is read once and costs two flops, so the read of R·D·bytes at
// 3.35 TB/s is the floor.  On the Statistics motif's path the kernel sees
// the transposed (dim, rows) layout, and there the inputs are small: the
// tuned K-means proxy gives it (1024, 57), 233 KB, a 0.07-µs read.  At
// that size a call costs what its launches cost, so the design counts
// launches first and bytes second.
//
// Two forms, chosen by the wrapper through `splits`:
//
// One launch (splits == 1), for every input up to the wrapper's
// ONE_LAUNCH_BYTES (4 MiB), every row up to its ONE_LAUNCH_ROW_BYTES
// (512 KiB: a block reads a row at ~85 GB/s, so such a row costs about
// what the second launch and the scratch buffer cost the host), and any
// input with enough rows to fill the card:
// `moments_rows` writes mean and msq directly, a warp per row up to
// WARP_D elements (8 rows to a 256-thread block), a 256-thread block per
// row above it.  No scratch buffer.
//
// Split rows, two launches (splits > 1), for a few long rows that would
// leave most of the 132 SMs idle: pass 1 (`moments_partial`) launches an
// (R, splits) grid, each block reducing one contiguous segment of one row
// into a float2 partial; pass 2 (`moments_combine`) has one warp per row
// add its splits' partials (lane-strided, then a shuffle tree) and divide
// by D.  Segments are whole 16-byte units, so vector loads stay aligned.
//
// Loads: 16 bytes a thread (4 f32 or 8 bf16) when every row starts on the
// 16-byte grid (x's base and D·bytes both multiples of 16), scalar
// otherwise; four loads in flight a thread in the long loops.
//
// Order: thread t of a group takes units t, t+G, ... and adds their
// elements in index order, then a shuffle tree, then the warps in order,
// then (split form) the segments in order.  The order depends on the
// launch shape and on the alignment test alone, so the same input gives
// the same bits call after call; against a plain f32 mean the results
// differ by reassociation only (rtol=1e-4, atol=1e-5 in the tests).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long WARP_D = 1024;  // longest row a warp takes alone

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
struct Acc {
  static constexpr int V = 16 / sizeof(T);  // elements a 16-byte unit
  float sum = 0.0f;
  float sq = 0.0f;

  __device__ __forceinline__ void add(float v) {
    sum += v;
    sq = fmaf(v, v, sq);
  }
  __device__ __forceinline__ void add(const uint4& u) {
    float f[V];
    unpack16(u, f);
#pragma unroll
    for (int j = 0; j < V; ++j) add(f[j]);
  }

  // elements [lo, hi) of row, thread `lane` of a group of `group`; with
  // VEC, lo is a multiple of V and row + lo lies on the 16-byte grid
  template <bool VEC>
  __device__ __forceinline__ void range(const T* __restrict__ row, int64_t lo,
                                        int64_t hi, int lane, int group) {
    if constexpr (VEC) {
      const uint4* p = reinterpret_cast<const uint4*>(row + lo);
      const int64_t n = (hi - lo + V - 1) / V;  // hi is D or a unit edge
      int64_t i = lane;
      for (; i + 3 * group < n; i += 4 * group) {
        const uint4 u0 = __ldg(p + i);
        const uint4 u1 = __ldg(p + i + group);
        const uint4 u2 = __ldg(p + i + 2 * group);
        const uint4 u3 = __ldg(p + i + 3 * group);
        add(u0);
        add(u1);
        add(u2);
        add(u3);
      }
      for (; i < n; i += group) add(__ldg(p + i));
    } else {
      for (int64_t i = lo + lane; i < hi; i += group) add(to_f32(row[i]));
    }
  }

  // the group's totals, on lane 0 of a warp group or thread 0 of a block
  template <int GROUP>
  __device__ __forceinline__ void reduce() {
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    if constexpr (GROUP == THREADS) {
      __shared__ float ws[WARPS];
      __shared__ float wq[WARPS];
      if ((threadIdx.x & 31) == 0) {
        ws[threadIdx.x >> 5] = sum;
        wq[threadIdx.x >> 5] = sq;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        sum = 0.0f;
        sq = 0.0f;
        for (int w = 0; w < WARPS; ++w) {
          sum += ws[w];
          sq += wq[w];
        }
      }
    }
  }
};

// One launch: GROUP threads per row (a warp, or the whole block).
template <typename T, int GROUP, bool VEC>
__global__ void __launch_bounds__(THREADS)
moments_rows(const T* __restrict__ x, float* __restrict__ mean,
             float* __restrict__ msq, int64_t R, int64_t D) {
  constexpr int ROWS = THREADS / GROUP;
  const int lane = threadIdx.x % GROUP;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * ROWS + threadIdx.x / GROUP;
  if (r >= R) return;  // only whole warps of the warp-per-row form leave
  Acc<T> acc;
  acc.template range<VEC>(x + r * D, 0, D, lane, GROUP);
  acc.template reduce<GROUP>();
  if (lane == 0) {
    mean[r] = acc.sum / static_cast<float>(D);
    msq[r] = acc.sq / static_cast<float>(D);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
moments_partial(const T* __restrict__ x, float2* __restrict__ partial,
                int64_t D, int64_t seg, int splits) {
  const int64_t r = blockIdx.x;
  const int s = blockIdx.y;
  const int64_t lo = static_cast<int64_t>(s) * seg;
  const int64_t hi = lo + seg < D ? lo + seg : D;
  Acc<T> acc;
  if (lo < hi) acc.template range<VEC>(x + r * D, lo, hi, threadIdx.x, THREADS);
  acc.template reduce<THREADS>();
  if (threadIdx.x == 0) partial[r * splits + s] = make_float2(acc.sum, acc.sq);
}

__global__ void moments_combine(const float2* __restrict__ partial,
                                float* __restrict__ mean,
                                float* __restrict__ msq, int64_t R,
                                int splits, float d) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                    threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // whole warps leave together
  float a = 0.0f;
  float b = 0.0f;
  for (int s = lane; s < splits; s += 32) {
    const float2 p = partial[r * splits + s];
    a += p.x;
    b += p.y;
  }
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    mean[r] = a / d;
    msq[r] = b / d;
  }
}

template <typename T, bool VEC>
int launch(const T* x, float2* partial, float* mean, float* msq, long long R,
           long long D, int splits, cudaStream_t s) {
  if (splits == 1) {
    if (D <= WARP_D) {
      const unsigned blocks = static_cast<unsigned>((R + WARPS - 1) / WARPS);
      moments_rows<T, 32, VEC><<<blocks, THREADS, 0, s>>>(x, mean, msq, R, D);
    } else {
      moments_rows<T, THREADS, VEC><<<static_cast<unsigned>(R), THREADS, 0, s>>>(
          x, mean, msq, R, D);
    }
    return launch_status();
  }
  constexpr long long V = 16 / sizeof(T);
  long long seg = (D + splits - 1) / splits;
  seg = (seg + V - 1) / V * V;  // whole 16-byte units
  const dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>(splits));
  moments_partial<T, VEC><<<grid, THREADS, 0, s>>>(x, partial, D, seg, splits);
  const int status = launch_status();
  if (status != 0) return status;
  const unsigned blocks = static_cast<unsigned>((R + WARPS - 1) / WARPS);
  moments_combine<<<blocks, THREADS, 0, s>>>(partial, mean, msq, R, splits,
                                             static_cast<float>(D));
  return launch_status();
}

template <typename T>
int launch_typed(const void* x, void* partial, void* mean, void* msq, long long R,
           long long D, int splits, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  float2* part = static_cast<float2*>(partial);
  float* m = static_cast<float*>(mean);
  float* q = static_cast<float*>(msq);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (D * static_cast<long long>(sizeof(T))) % 16 == 0;
  return vec ? launch<T, true>(xt, part, m, q, R, D, splits, s)
             : launch<T, false>(xt, part, m, q, R, D, splits, s);
}

}  // namespace

// splits == 1: one launch, `partial` unread (may be null); splits > 1:
// partial holds R·splits float2.
extern "C" int repro_row_moments(int dtype, const void* x, void* partial,
                                 void* mean, void* msq, long long R,
                                 long long D, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1) return -1;
  switch (dtype) {
    case kFloat32:
      return launch_typed<float>(x, partial, mean, msq, R, D, splits, s);
    case kBFloat16:
      return launch_typed<__nv_bfloat16>(x, partial, mean, msq, R, D, splits, s);
    default:
      return -1;
  }
}
