// MoE dispatch: out[e, c, :] = Σ_t mask[t, e, c]·x[t, :], that is
// out[e] = mask[:, e, :]ᵀ @ x for every expert, f32 accumulation, in x's
// dtype.
//
// Replaces: src/repro/kernels/moe_dispatch.py, moe_dispatch ->
// _dispatch_kernel (the Pallas kernel that contracts the whole token
// block against one expert's mask stripe on the MXU, grid over experts).
//
// What bounds it on an H100: operations.  The dense contraction costs
// 2·T·E·C·D flops against (T·E·C + T·D + E·C·D)·bytes; at a model's
// group (T=4096, E=64, C=480, D=2048) that is about 650 operations a byte
// in f32, far past the 20 where the f32 FMA rate (67 TFLOP/s, no tensor
// cores: the reference product is full f32) becomes the limit.
//
// Design: a batched tiled contraction over tokens with the tile loop of
// gemm_tile.cuh, grid (C tiles, D tiles, E).  The A operand
// mask[:, e, :]ᵀ is read in place through its strides (1 along c, E·C
// along t), loaded c-fastest so neighbouring threads read neighbouring
// slots; no transposed copy is made.  Each mask value is rounded to x's
// type on load, as the reference casts the mask to x.dtype before the
// product, so no cast pass over the mask runs either.  It is the general
// contraction, right for any mask: for a one-hot mask each output is one
// product with 1.0 plus exact zeros, so it equals the plain version
// bit for bit.
#include "gemm_tile.cuh"

namespace {

template <typename MaskT, typename T>
__global__ void __launch_bounds__(gemm::THREADS)
dispatch_kernel(const MaskT* __restrict__ mask, const T* __restrict__ x,
                T* __restrict__ out, int64_t Tok, int64_t E, int64_t C,
                int64_t D) {
  const int64_t e = blockIdx.z;
  gemm::tile<MaskT, T, T, true>(mask + e * C, E * C, x, D, out + e * C * D, D,
                             C, D, Tok,
                             static_cast<int64_t>(blockIdx.x) * gemm::BM,
                             static_cast<int64_t>(blockIdx.y) * gemm::BN);
}

template <typename MaskT, typename T>
void launch(const void* mask, const void* x, void* out, int64_t Tok,
            int64_t E, int64_t C, int64_t D, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((C + gemm::BM - 1) / gemm::BM),
                  static_cast<unsigned>((D + gemm::BN - 1) / gemm::BN),
                  static_cast<unsigned>(E));
  dispatch_kernel<MaskT, T><<<grid, gemm::THREADS, 0, s>>>(
      static_cast<const MaskT*>(mask), static_cast<const T*>(x),
      static_cast<T*>(out), Tok, E, C, D);
}

}  // namespace

extern "C" int repro_moe_dispatch(int mask_dtype, int dtype, const void* mask,
                                  const void* x, void* out, long long T,
                                  long long E, long long C, long long D,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask_dtype == kFloat32 && dtype == kFloat32) {
    launch<float, float>(mask, x, out, T, E, C, D, s);
  } else if (mask_dtype == kFloat32 && dtype == kBFloat16) {
    launch<float, __nv_bfloat16>(mask, x, out, T, E, C, D, s);
  } else if (mask_dtype == kBFloat16 && dtype == kFloat32) {
    launch<__nv_bfloat16, float>(mask, x, out, T, E, C, D, s);
  } else if (mask_dtype == kBFloat16 && dtype == kBFloat16) {
    launch<__nv_bfloat16, __nv_bfloat16>(mask, x, out, T, E, C, D, s);
  } else {
    return -1;
  }
  return launch_status();
}
