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
// Design: the tile loop of gemm_tile.cuh on row-major operands, one
// block per 64x64 output tile.  No wgmma/TMA yet: a simple kernel that is
// right first.
#include "gemm_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(gemm::THREADS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int64_t M, int64_t N, int64_t K) {
  gemm::tile<T, T, T, false>(a, K, b, N, c, N, M, N, K,
                             static_cast<int64_t>(blockIdx.x) * gemm::BM,
                             static_cast<int64_t>(blockIdx.y) * gemm::BN);
}

}  // namespace

extern "C" int repro_matmul(int dtype, const void* a, const void* b, void* c,
                            long long M, long long N, long long K,
                            void* stream) {
  const dim3 grid(static_cast<unsigned>((M + gemm::BM - 1) / gemm::BM),
                  static_cast<unsigned>((N + gemm::BN - 1) / gemm::BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      matmul_kernel<float><<<grid, gemm::THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(c), M, N, K);
      break;
    case kBFloat16:
      matmul_kernel<__nv_bfloat16><<<grid, gemm::THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(b),
          static_cast<__nv_bfloat16*>(c), M, N, K);
      break;
    default:
      return -1;
  }
  return launch_status();
}
