// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function (loaded with ctypes): tensors
// arrive as raw pointers, the stream as PyTorch's current CUDA stream,
// and the function returns cudaGetLastError() after its launches so the
// Python wrapper can raise on a refused launch.  Kernels allocate
// nothing: the wrapper owns every output and scratch buffer.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes, mirrored by repro_torch/kernels/_build.py::DTYPE_CODES
enum ReproDtype : int {
  kFloat32 = 0,
  kBFloat16 = 1,
  kUInt32 = 2,
  kInt32 = 3,
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// The 16 / sizeof(T) values of one 16-byte unit of f32 (4) or bf16 (8),
// as f32, in address order.
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);              // lower address
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);  // upper address
  }
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
