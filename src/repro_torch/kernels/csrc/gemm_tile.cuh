// The tiled SIMT product loop of moe_dispatch.cu's f32 form (matmul.cu
// has its own forms).
//
// One 256-thread block computes one 64x64 tile of c(M, N) = a(M, K) @
// b(K, N): a K loop over 16-wide slabs staged in shared memory as f32
// (bf16 converted on load), each thread holding a 4x4 register tile and
// accumulating with fmaf in K order.  Ragged M/N/K edges are masked in
// the loads and the store, so no padded operand copy is made; offsets are
// 64-bit.  The result is cast to c's type on the store.
//
// a(m, k) is a[m·lda + k] (row-major) or a[m + k·lda] (A_M_CONTIG, a
// column-major view such as the MoE mask stripe mask[:, e, :]ᵀ); each
// layout is loaded with neighbouring threads on neighbouring addresses.
// b is row-major with row stride ldb, c with row stride ldc.  When a's
// type differs from b's, each a value is first rounded to b's type: the
// reference casts its operand to the other's type before the product.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gemm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int ROWS = BM / TM;  // 16 thread rows
constexpr int COLS = BN / TN;  // 16 thread columns
constexpr int THREADS = ROWS * COLS;

template <typename TA, typename TB>
__device__ __forceinline__ float load_a(TA v) {
  if constexpr (std::is_same_v<TA, TB>) {
    return to_f32(v);
  } else {
    return to_f32(from_f32<TB>(to_f32(v)));
  }
}

template <typename TA, typename TB, typename TC, bool A_M_CONTIG>
__device__ __forceinline__ void tile(const TA* __restrict__ a, int64_t lda,
                                     const TB* __restrict__ b, int64_t ldb,
                                     TC* __restrict__ c, int64_t ldc,
                                     int64_t M, int64_t N, int64_t K,
                                     int64_t row0, int64_t col0) {
  __shared__ float as[BK][BM + 4];
  __shared__ float bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % COLS;
  const int ty = tid / COLS;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = A_M_CONTIG ? e % BM : e / BK;
      const int kk = A_M_CONTIG ? e / BM : e % BK;
      const int64_t gm = row0 + m;
      const int64_t gk = k0 + kk;
      float v = 0.0f;
      if (gm < M && gk < K)
        v = load_a<TA, TB>(A_M_CONTIG ? a[gm + gk * lda] : a[gm * lda + gk]);
      as[kk][m] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN;
      const int n = e % BN;
      const int64_t gk = k0 + kk;
      const int64_t gn = col0 + n;
      bs[kk][n] = (gk < K && gn < N) ? to_f32(b[gk * ldb + gn]) : 0.0f;
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
      if (gn < N) c[gm * ldc + gn] = from_f32<TC>(acc[i][j]);
    }
  }
}

}  // namespace gemm
