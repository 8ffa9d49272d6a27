// Tiled SIMT matrix product: c(M,N) = a(M,K) @ b(K,N), f32 accumulation.
//
// Replaces: src/repro/kernels/matmul.py, matmul -> _matmul_kernel (the
// Pallas tiled-MXU kernel with an f32 VMEM accumulator).
//
// What bounds it on an H100: on the Matrix motif's path K is the matrix
// dim (8..2048) and N the centroid count (2..1024, often 8..32), so the
// product has low arithmetic intensity, (2·M·N·K) flops over
// (M·K + K·N + M·N)·bytes, and the reading of a(M,K) bounds it; at wide N
// it turns into an f32-FMA-bound product (67 TFLOP/s without tensor
// cores; TF32 is off because the reference is a full-f32 product).
//
// Design: one 256-thread block per 64x64 output tile; a K loop over
// 16-wide slabs staged in shared memory as f32 (bf16 converted on load);
// each thread holds a 4x4 register tile and accumulates with fmaf in K
// order.  Ragged M/N/K edges are masked in the loads and the store, so no
// padded operand copy is made.  The result is cast to the input type on
// the store.  No wgmma/TMA yet: a simple kernel that is right first.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int ROWS = BM / TM;  // 16 thread rows
constexpr int COLS = BN / TN;  // 16 thread columns
constexpr int THREADS = ROWS * COLS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int64_t M, int64_t N, int64_t K) {
  __shared__ float as[BK][BM + 4];
  __shared__ float bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % COLS;
  const int ty = tid / COLS;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK;
      const int kk = e % BK;
      const int64_t gm = row0 + m;
      const int64_t gk = k0 + kk;
      as[kk][m] = (gm < M && gk < K) ? to_f32(a[gm * K + gk]) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int n = e % BN;
      const int64_t gk = k0 + kk;
      const int64_t gn = col0 + n;
      bs[kk][n] = (gk < K && gn < N) ? to_f32(b[gk * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + i * ROWS];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * COLS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = row0 + ty + i * ROWS;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = col0 + tx + j * COLS;
      if (gn < N) c[gm * N + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int repro_matmul(int dtype, const void* a, const void* b, void* c,
                            long long M, long long N, long long K,
                            void* stream) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      matmul_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(c), M, N, K);
      break;
    case kBFloat16:
      matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(b),
          static_cast<__nv_bfloat16*>(c), M, N, K);
      break;
    default:
      return -1;
  }
  return launch_status();
}
