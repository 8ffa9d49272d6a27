// Bitonic sort of every power-of-two block of a 1-D array.
//
// Replaces: src/repro/kernels/bitonic_sort.py, bitonic_sort_blocks ->
// _sort_kernel -> _bitonic_block (the Pallas compare-exchange network
// over one VMEM-resident block per grid step).
//
// What bounds it on an H100: bytes, and the number of passes over them.
// The function reads n keys and writes n keys; the network does
// log2(B)·(log2(B)+1)/2 compare-exchange stages on a block of B, which
// stays cheap only while a stage's partner lies in shared memory.  Blocks
// on the quick path are <= 4096 keys; the merge path sorts runs of up to
// 2^20 keys, far beyond one SM's 227 KB.
//
// Design: the network of _bitonic_block, stage for stage.  Stage k
// (block size 2^k) with substeps j = k-1..0 compares i with i + 2^j and
// sorts ascending where bit k of the block-local index i is 0, so every
// block ends ascending.  A tile of T = min(B, 8192) keys (32 KB for
// four-byte keys) is sorted in shared memory by one thread block; every
// substep whose stride is >= T runs as a global-memory pass over the
// whole array, and the remaining substeps of that stage finish inside
// each tile.  The Python wrapper (bitonic_sort.py::bitonic_schedule)
// owns the pass order.  The first tile pass reads the unpadded input and
// substitutes the dtype's sentinel (integer max or +inf) past its end,
// so no padded copy is made.
#include <climits>

#include "common.cuh"

namespace {

template <typename T>
struct Key;

template <>
struct Key<uint32_t> {
  static __device__ __forceinline__ uint32_t sentinel() { return 0xFFFFFFFFu; }
  static __device__ __forceinline__ bool less(uint32_t a, uint32_t b) { return a < b; }
};

template <>
struct Key<int32_t> {
  static __device__ __forceinline__ int32_t sentinel() { return INT_MAX; }
  static __device__ __forceinline__ bool less(int32_t a, int32_t b) { return a < b; }
};

template <>
struct Key<float> {
  static __device__ __forceinline__ float sentinel() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ bool less(float a, float b) { return a < b; }
};

template <>
struct Key<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 sentinel() {
    return __float2bfloat16(__int_as_float(0x7f800000));
  }
  static __device__ __forceinline__ bool less(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __bfloat162float(a) < __bfloat162float(b);
  }
};

template <typename T>
__device__ __forceinline__ void compare_exchange(T* lo, T* hi, bool ascending) {
  const T a = *lo;
  const T b = *hi;
  if (ascending ? Key<T>::less(b, a) : Key<T>::less(a, b)) {
    *lo = b;
    *hi = a;
  }
}

// Stages k_lo..k_hi of the network inside each tile of 2^log2_tile keys;
// a stage's substeps with stride >= the tile were done by global passes.
template <typename T>
__global__ void bitonic_tile(const T* __restrict__ src, T* __restrict__ dst,
                             int64_t n_src, int log2_block, int log2_tile,
                             int k_lo, int k_hi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tile = 1 << log2_tile;
  const int half = tile >> 1;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t block_mask = (int64_t{1} << log2_block) - 1;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int64_t g = base + i;
    s[i] = g < n_src ? src[g] : Key<T>::sentinel();
  }
  __syncthreads();
  for (int k = k_lo; k <= k_hi; ++k) {
    const int jtop = (k < log2_tile ? k : log2_tile) - 1;
    for (int j = jtop; j >= 0; --j) {
      const int d = 1 << j;
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = ((p >> j) << (j + 1)) | (p & (d - 1));
        const bool ascending = ((((base + i) & block_mask) >> k) & 1) == 0;
        compare_exchange(&s[i], &s[i + d], ascending);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) dst[base + i] = s[i];
}

// One substep (stage k, stride 2^j >= the tile) over the whole array.
template <typename T>
__global__ void bitonic_global(T* __restrict__ buf, int64_t n_pad,
                               int log2_block, int k, int j) {
  const int64_t half = n_pad >> 1;
  const int64_t d = int64_t{1} << j;
  const int64_t block_mask = (int64_t{1} << log2_block) - 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < half; p += stride) {
    const int64_t i = ((p >> j) << (j + 1)) | (p & (d - 1));
    const bool ascending = (((i & block_mask) >> k) & 1) == 0;
    compare_exchange(&buf[i], &buf[i + d], ascending);
  }
}

template <typename T>
int launch_tile(const void* src, void* dst, long long n_src, long long n_pad,
                int log2_block, int log2_tile, int k_lo, int k_hi,
                cudaStream_t s) {
  const long long tiles = n_pad >> log2_tile;
  const int pairs = (1 << log2_tile) >> 1;
  const int threads = pairs < 1024 ? pairs : 1024;
  const size_t smem = (size_t{1} << log2_tile) * sizeof(T);
  bitonic_tile<T><<<static_cast<unsigned>(tiles), threads, smem, s>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), n_src, log2_block,
      log2_tile, k_lo, k_hi);
  return launch_status();
}

template <typename T>
int launch_global(void* buf, long long n_pad, int log2_block, int k, int j,
                  cudaStream_t s) {
  constexpr int kThreads = 256;
  const long long pairs = n_pad >> 1;
  long long blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  bitonic_global<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<T*>(buf), n_pad, log2_block, k, j);
  return launch_status();
}

}  // namespace

extern "C" int repro_bitonic_tile(int dtype, const void* src, void* dst,
                                  long long n_src, long long n_pad,
                                  int log2_block, int log2_tile, int k_lo,
                                  int k_hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_tile<float>(src, dst, n_src, n_pad, log2_block, log2_tile, k_lo, k_hi, s);
    case kBFloat16:
      return launch_tile<__nv_bfloat16>(src, dst, n_src, n_pad, log2_block, log2_tile, k_lo, k_hi, s);
    case kUInt32:
      return launch_tile<uint32_t>(src, dst, n_src, n_pad, log2_block, log2_tile, k_lo, k_hi, s);
    case kInt32:
      return launch_tile<int32_t>(src, dst, n_src, n_pad, log2_block, log2_tile, k_lo, k_hi, s);
    default:
      return -1;
  }
}

extern "C" int repro_bitonic_global(int dtype, void* buf, long long n_pad,
                                    int log2_block, int k, int j,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_global<float>(buf, n_pad, log2_block, k, j, s);
    case kBFloat16:
      return launch_global<__nv_bfloat16>(buf, n_pad, log2_block, k, j, s);
    case kUInt32:
      return launch_global<uint32_t>(buf, n_pad, log2_block, k, j, s);
    case kInt32:
      return launch_global<int32_t>(buf, n_pad, log2_block, k, j, s);
    default:
      return -1;
  }
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
