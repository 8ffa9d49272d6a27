// Per-row f32 (mean, mean of squares) over the last dim of x(R, D).
//
// Replaces: src/repro/kernels/rmsnorm.py, row_moments -> _moments_kernel
// (the Pallas fused reduction that keeps a whole row in one VMEM tile).
//
// What bounds it on an H100: bytes.  Each element is read once and costs
// two flops, so the read of R·D·bytes at 3.35 TB/s is the floor.  On the
// Statistics motif's path the kernel sees the transposed (dim, rows)
// layout: R is small (8..1024) and a row holds up to 2^23 elements, so a
// whole row never fits in shared memory, and one block per row would
// leave most of the 132 SMs idle.
//
// Design: split-row, two passes, deterministic.  Pass 1 launches an
// (R, splits) grid; each block reduces one contiguous segment of one row:
// per-thread f32 partial sums in index order (thread t takes elements
// t, t+256, ...), a warp-shuffle tree, then the 8 warp sums in warp
// order, into a float2 partial.  Pass 2 has one warp per row add its
// splits' partials (lane-strided, then a shuffle tree) and divide by D.
// The order is fixed by the launch shape alone, so results repeat bit for
// bit; against a plain f32 mean they differ by reassociation only, which
// the tests cover with rtol=1e-4, atol=1e-5.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
moments_partial(const T* __restrict__ x, float2* __restrict__ partial,
                int64_t D, int64_t seg, int splits) {
  const int64_t r = blockIdx.x;
  const int s = blockIdx.y;
  const int64_t lo = static_cast<int64_t>(s) * seg;
  const int64_t hi = lo + seg < D ? lo + seg : D;
  const T* row = x + r * D;
  float sum = 0.0f;
  float sq = 0.0f;
  for (int64_t i = lo + threadIdx.x; i < hi; i += THREADS) {
    const float v = to_f32(row[i]);
    sum += v;
    sq = fmaf(v, v, sq);
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  __shared__ float ws[WARPS];
  __shared__ float wq[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = sum;
    wq[warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f;
    float b = 0.0f;
    for (int w = 0; w < WARPS; ++w) {
      a += ws[w];
      b += wq[w];
    }
    partial[r * splits + s] = make_float2(a, b);
  }
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

}  // namespace

extern "C" int repro_row_moments(int dtype, const void* x, void* partial,
                                 void* mean, void* msq, long long R,
                                 long long D, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long seg = (D + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>(splits));
  float2* part = static_cast<float2*>(partial);
  switch (dtype) {
    case kFloat32:
      moments_partial<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), part, D, seg, splits);
      break;
    case kBFloat16:
      moments_partial<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), part, D, seg, splits);
      break;
    default:
      return -1;
  }
  const int status = launch_status();
  if (status != 0) return status;
  constexpr int kRowsPerBlock = 8;  // 8 warps of 32 lanes
  const unsigned blocks = static_cast<unsigned>((R + kRowsPerBlock - 1) / kRowsPerBlock);
  moments_combine<<<blocks, kRowsPerBlock * 32, 0, s>>>(
      part, static_cast<float*>(mean), static_cast<float*>(msq), R, splits,
      static_cast<float>(D));
  return launch_status();
}
