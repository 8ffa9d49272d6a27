// Bitonic sort of every power-of-two block of a 1-D array.
//
// Replaces: src/repro/kernels/bitonic_sort.py, bitonic_sort_blocks ->
// _sort_kernel -> _bitonic_block (the Pallas compare-exchange network
// over one VMEM-resident block per grid step).
//
// What bounds it on an H100: latency, not bytes.  The function reads n
// keys and writes n keys (the main path sorts 9,830 keys in blocks of
// 2048: 40 KB, 0.02 µs of HBM time), while the network on a block of B
// keys is log2(B)·(log2(B)+1)/2 dependent compare-exchange substeps (66
// at B = 2048).  A substep costs what moving its partners costs: a
// register move, a warp shuffle, or a shared-memory round trip with a
// barrier.  So the design puts each substep where its partners already
// are, and counts barriers.
//
// Design.  Keys become the order-preserving uint32 image of their type
// on load (int32: flip the sign bit; f32 and bf16: flip the sign bit of
// positives and every bit of negatives), so one unsigned min/max network
// sorts all four types, and map back on store.  The padding past the
// input's end is the image of the dtype's sentinel (integer max, +inf).
// The network is _bitonic_block's, stage for stage: stage k compares i
// with i + 2^j for j = k-1..0 and sorts ascending where bit k of the
// block-local index i is 0, so every block ends ascending.  Keys of a
// descending run are held complemented for the stage, so every substep
// is one ascending min/max and no key carries a direction with it
// (directions held per key cost the 32-key tile its registers).
//
// One thread block sorts a tile of T = 2^11..2^15 keys (the wrapper picks
// T from the block: at least 2048, so blocks <= 1024 share a tile, and at
// most 32,768, 132 KB of shared memory).  Each of its 32·W threads holds
// E keys in registers (T = 32·E·W, E = W or 2W), in one of two layouts:
//   L: thread (warp w, lane l) holds positions w·32E + l·E + e.  Strides
//      below E are register exchanges; strides E..32E-1 are
//      __shfl_xor_sync between lanes; no barrier for either.
//   H: thread t holds positions h·32E + t·(E/W) + e' (h < W, e' < E/W):
//      the strides of 32E and above, which cross warps, become register
//      exchanges too.
// A stage with strides >= 32E moves its keys L -> H and back through
// shared memory, one barrier each way; every other stage stays in
// registers.  Block 2048 (E = W = 8) is 11 stages: stages 1-8 touch no
// barrier, stages 9-11 two each, plus one after the load and one before
// the store: 8 barriers where the step-by-step network had 66.  Shared
// memory holds one padded word a 32 (index p + p/32), so both layouts
// read and write it without bank conflicts.  The tile is loaded and
// stored through shared memory in index order, so global accesses are
// coalesced whatever the type.
//
// Blocks beyond the tile: stage k's strides >= T run as global passes,
// each thread taking 2^r keys spaced by r consecutive strides (r <= 4) and
// doing those r substeps in registers, so a pass reads and writes the
// array once for up to four strides; the stage's remaining strides finish
// inside each tile.  The Python wrapper (bitonic_sort.py::
// bitonic_schedule) owns the pass order.
//
// NaN keys with the sign bit set sort first (their image is small); the
// port's sorts see no NaN.
#include <type_traits>

#include "common.cuh"

namespace {

// Keys by dtype (a template argument, so a loop over keys has no branch
// on the type): the order-preserving uint32 image of key i, the key back
// from its image, and the image of the dtype's sentinel (integer max,
// +inf), which pads the input.
template <int DT>
__device__ __forceinline__ uint32_t load_key(const void* p, int64_t i) {
  if constexpr (DT == kBFloat16) {
    const uint32_t u = static_cast<const uint16_t*>(p)[i];
    return u ^ ((u & 0x8000u) ? 0xFFFFu : 0x8000u);
  } else {
    const uint32_t u = static_cast<const uint32_t*>(p)[i];
    if constexpr (DT == kUInt32) return u;
    if constexpr (DT == kInt32) return u ^ 0x80000000u;
    return u ^ (static_cast<uint32_t>(static_cast<int32_t>(u) >> 31) | 0x80000000u);
  }
}

template <int DT>
__device__ __forceinline__ void store_key(void* p, int64_t i, uint32_t k) {
  if constexpr (DT == kBFloat16) {
    static_cast<uint16_t*>(p)[i] =
        static_cast<uint16_t>(k ^ ((k & 0x8000u) ? 0x8000u : 0xFFFFu));
  } else if constexpr (DT == kUInt32) {
    static_cast<uint32_t*>(p)[i] = k;
  } else if constexpr (DT == kInt32) {
    static_cast<uint32_t*>(p)[i] = k ^ 0x80000000u;
  } else {
    static_cast<uint32_t*>(p)[i] = k ^ (((k >> 31) - 1u) | 0x80000000u);
  }
}

template <int DT>
__device__ __forceinline__ uint32_t pad_key() {
  return DT == kFloat32 ? 0xFF800000u : DT == kBFloat16 ? 0xFF80u : 0xFFFFFFFFu;
}

// Call f with the dtype code as a compile-time constant.
template <class F>
__device__ __forceinline__ void with_dtype(int dtype, F&& f) {
  switch (dtype) {
    case kUInt32:
      f(std::integral_constant<int, kUInt32>{});
      break;
    case kInt32:
      f(std::integral_constant<int, kInt32>{});
      break;
    case kFloat32:
      f(std::integral_constant<int, kFloat32>{});
      break;
    default:
      f(std::integral_constant<int, kBFloat16>{});
  }
}

// min to a, max to b
__device__ __forceinline__ void order(uint32_t& a, uint32_t& b) {
  const uint32_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// All ones where stage k sorts block-local index i descending (bit k of
// i is 1, and k is not the block's last stage), else 0; 0 for k < 0.
// Keys of descending runs are held complemented, so every substep is an
// ascending min/max and no key carries a direction through it.
// i is the index's low 32 bits, which hold every stage bit (k < 31).
__device__ __forceinline__ uint32_t flip(uint32_t i, int k, int log2_block) {
  if (k < 0 || k >= log2_block) return 0u;
  return 0u - ((i >> k) & 1u);
}

// One stride between lanes: each key against the key of lane ^ m in the
// same register, the lower lane keeping the min.  Every shuffle needs a
// register for its partner; with 32 keys a thread (1024 threads, 64
// registers) ptxas spills when all 32 are in flight, so CHUNK < E keeps
// CHUNK of them in flight: a loop that ptxas does not unroll takes the
// first CHUNK keys and rotates the array by CHUNK (register moves, four
// times cheaper than the shuffles), E / CHUNK times.
template <int E, int CHUNK>
__device__ __forceinline__ void shuffle_substep(uint32_t (&v)[E], int m,
                                                bool upper) {
  if constexpr (CHUNK == E) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint32_t other = __shfl_xor_sync(0xffffffffu, v[e], m);
      v[e] = upper ? max(v[e], other) : min(v[e], other);
    }
  } else {
#pragma unroll 1
    for (int c = 0; c < E / CHUNK; ++c) {
      uint32_t r[CHUNK];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const uint32_t other = __shfl_xor_sync(0xffffffffu, v[i], m);
        r[i] = upper ? max(v[i], other) : min(v[i], other);
      }
#pragma unroll
      for (int i = 0; i < E - CHUNK; ++i) v[i] = v[i + CHUNK];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) v[E - CHUNK + i] = r[i];
    }
  }
}

// Complement, in layout L, the keys whose run direction differs between
// stage k and the stage before it in this pass (kp, or -1 for the
// pass's first).  pos holds the low 32 bits of the thread's first index
// and is a multiple of E, so bits from LOG_E up give one mask for all
// the thread's keys; bits below LOG_E, those of e, decide only in stages
// k <= LOG_E, where the loop over kk makes them known at compile time.
// A key costs one XOR a stage, three in the first LOG_E stages.
template <int LOG_E>
__device__ __forceinline__ void toggle(uint32_t (&v)[1 << LOG_E], uint32_t pos,
                                       int k, int kp, int log2_block) {
  const uint32_t t = flip(pos, k, log2_block) ^ flip(pos, kp, log2_block);
  if (k > LOG_E) {
#pragma unroll
    for (int e = 0; e < (1 << LOG_E); ++e) v[e] ^= t;
    return;
  }
  const uint32_t ma = k < log2_block ? ~0u : 0u;             // e's bit k
  const uint32_t mb = kp >= 0 && kp < log2_block ? ~0u : 0u;  // e's bit k-1
#pragma unroll
  for (int kk = 1; kk <= LOG_E; ++kk) {
    if (kk != k) continue;
#pragma unroll
    for (int e = 0; e < (1 << LOG_E); ++e) {
      uint32_t x = t;
      if (kk < LOG_E && ((e >> kk) & 1)) x ^= ma;
      if ((e >> (kk - 1)) & 1) x ^= mb;
      v[e] ^= x;
    }
  }
}

// shared-memory word of tile position p: one pad word a 32
__device__ __forceinline__ int padded(int p) { return p + (p >> 5); }

template <int LOG_E, int LOG_W>
struct TileShape {
  static constexpr int E = 1 << LOG_E;          // keys a thread
  static constexpr int W = 1 << LOG_W;          // warps
  static constexpr int THREADS = 32 * W;
  static constexpr int LOG_T = LOG_E + LOG_W + 5;
  static constexpr int T = 1 << LOG_T;          // keys a thread block
  static constexpr int LOG_L = LOG_E + 5;       // strides below 2^LOG_L stay in a warp
  static constexpr int EL = E / W;              // layout H: keys a thread per 32E span
  static constexpr int CHUNK = E > 16 ? 16 : E;  // shuffles in flight
  static constexpr size_t SMEM = (T + T / 32) * sizeof(uint32_t);
  static_assert(LOG_E >= LOG_W, "layout H needs E >= W");
};

// Stages k_lo..k_hi of the network inside each tile; a stage's strides
// >= the tile were done by global passes.  src may equal dst.  One block
// an SM is enough (the 2048-key tiles of the main path are five): told
// so, ptxas stops capping registers for occupancy and keeps more
// shuffles in flight.
template <int LOG_E, int LOG_W>
__global__ void __launch_bounds__(TileShape<LOG_E, LOG_W>::THREADS, 1)
bitonic_tile(const void* src, void* dst, int dtype, int64_t n_src,
             int64_t n_pad, int log2_block, int k_lo, int k_hi) {
  using S = TileShape<LOG_E, LOG_W>;
  constexpr int E = S::E, EL = S::EL, LOG_T = S::LOG_T, LOG_L = S::LOG_L;
  extern __shared__ uint32_t s[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * S::T;

  // Each layout's words lie at one base a thread plus offsets known at
  // compile time (a run of E keys, of E/W keys, or index order never
  // crosses a pad word), so no address a key is held in a register.
  constexpr int SPAN = 32 * E + E;  // padded words of 32E positions
  const int l0 = (tid >> 5) * (32 * E) + lane * E;  // layout L: l0 + e
  const int h0 = tid * EL;  // layout H: h·32E + h0 + e', e = h·EL + e'
  uint32_t* const sl = s + padded(l0);
  uint32_t* const sh = s + padded(h0);
  uint32_t* const sc = s + padded(tid);  // index order: tid + e·THREADS
  // the low 32 bits of the index of the thread's first key in layout L
  // (a stage's direction bit k < 31 lies there)
  const uint32_t pos = static_cast<uint32_t>(base) + static_cast<uint32_t>(l0);
  with_dtype(dtype, [&](auto dt) {
    constexpr int DT = decltype(dt)::value;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t g = base + tid + e * S::THREADS;
      sc[e * (S::THREADS + S::THREADS / 32)] =
          g < n_src ? load_key<DT>(src, g) : pad_key<DT>();
    }
  });
  __syncthreads();
  uint32_t v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = sl[e];

  for (int k = k_lo; k <= k_hi; ++k) {
    const int j_top = (k < LOG_T ? k : LOG_T) - 1;
    // from the last stage's complemented runs to this stage's
    const int k_prev = k == k_lo ? -1 : k - 1;
    toggle<LOG_E>(v, pos, k, k_prev, log2_block);
    if (j_top >= LOG_L) {  // strides across warps: layout H
#pragma unroll
      for (int e = 0; e < E; ++e) sl[e] = v[e];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = sh[(e / EL) * SPAN + e % EL];
#pragma unroll
      for (int jj = LOG_T - 1; jj >= LOG_L; --jj) {
        if (jj > j_top) continue;
        const int m = (1 << (jj - LOG_L)) * EL;  // partner register offset
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (!(e & m)) order(v[e], v[e + m]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sh[(e / EL) * SPAN + e % EL] = v[e];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = sl[e];
    }
#pragma unroll
    for (int jj = LOG_L - 1; jj >= LOG_E; --jj) {  // strides within a warp
      if (jj > j_top) continue;
      const int m = 1 << (jj - LOG_E);  // partner lane offset
      shuffle_substep<E, S::CHUNK>(v, m, lane & m);
    }
#pragma unroll
    for (int jj = LOG_E - 1; jj >= 0; --jj) {  // strides within a thread
      if (jj > j_top) continue;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & (1 << jj))) order(v[e], v[e + (1 << jj)]);
    }
  }

  // the last stage's runs: one direction a tile (k_hi >= LOG_T) or
  // the block's last stage (no complement)
  const uint32_t last = flip(pos, k_hi, log2_block);
#pragma unroll
  for (int e = 0; e < E; ++e) sl[e] = v[e] ^ last;
  __syncthreads();
  with_dtype(dtype, [&](auto dt) {
    constexpr int DT = decltype(dt)::value;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t g = base + tid + e * S::THREADS;
      if (g < n_pad) store_key<DT>(dst, g, sc[e * (S::THREADS + S::THREADS / 32)]);
    }
  });
}

// Stage k's substeps of strides 2^(j_lo+R-1) down to 2^j_lo (all >= the
// tile) over the whole array: each thread takes 2^R keys spaced by 2^j_lo.
template <int R>
__global__ void __launch_bounds__(256)
bitonic_global(void* buf, int dtype, int64_t n_pad, int log2_block, int k,
               int j_lo) {
  constexpr int N = 1 << R;
  const int64_t groups = n_pad >> R;
  const int64_t low = (int64_t{1} << j_lo) - 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t q = ((g >> j_lo) << (j_lo + R)) | (g & low);
    const uint32_t f = flip(static_cast<uint32_t>(q), k, log2_block);  // one a thread
    with_dtype(dtype, [&](auto dt) {
      constexpr int DT = decltype(dt)::value;
      uint32_t v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = load_key<DT>(buf, q + (int64_t{i} << j_lo)) ^ f;
#pragma unroll
      for (int jj = R - 1; jj >= 0; --jj) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (!(i & (1 << jj))) order(v[i], v[i + (1 << jj)]);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) store_key<DT>(buf, q + (int64_t{i} << j_lo), v[i] ^ f);
    });
  }
}

template <int LOG_E, int LOG_W>
int launch_tile(int dtype, const void* src, void* dst, long long n_src,
                long long n_pad, int log2_block, int k_lo, int k_hi,
                cudaStream_t s) {
  using S = TileShape<LOG_E, LOG_W>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      bitonic_tile<LOG_E, LOG_W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = (n_pad + S::T - 1) / S::T;
  bitonic_tile<LOG_E, LOG_W><<<static_cast<unsigned>(tiles), S::THREADS, S::SMEM, s>>>(
      src, dst, dtype, n_src, n_pad, log2_block, k_lo, k_hi);
  return launch_status();
}

template <int R>
int launch_global(int dtype, void* buf, long long n_pad, int log2_block, int k,
                  int j_lo, cudaStream_t s) {
  constexpr int kThreads = 256;
  const long long groups = n_pad >> R;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond this
  bitonic_global<R><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      buf, dtype, n_pad, log2_block, k, j_lo);
  return launch_status();
}

bool known_dtype(int dtype) {
  return dtype == kFloat32 || dtype == kBFloat16 || dtype == kUInt32 ||
         dtype == kInt32;
}

}  // namespace

// Tile pass: stages k_lo..k_hi inside each tile of 2^log2_tile keys
// (2^11..2^15), reading n_src keys of src (the dtype's sentinel past
// them) and writing n_pad keys of dst.
extern "C" int repro_bitonic_tile(int dtype, const void* src, void* dst,
                                  long long n_src, long long n_pad,
                                  int log2_block, int log2_tile, int k_lo,
                                  int k_hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!known_dtype(dtype)) return -1;
  switch (log2_tile) {
    case 11:
      return launch_tile<3, 3>(dtype, src, dst, n_src, n_pad, log2_block, k_lo, k_hi, s);
    case 12:
      return launch_tile<4, 3>(dtype, src, dst, n_src, n_pad, log2_block, k_lo, k_hi, s);
    case 13:
      return launch_tile<4, 4>(dtype, src, dst, n_src, n_pad, log2_block, k_lo, k_hi, s);
    case 14:
      return launch_tile<5, 4>(dtype, src, dst, n_src, n_pad, log2_block, k_lo, k_hi, s);
    case 15:
      return launch_tile<5, 5>(dtype, src, dst, n_src, n_pad, log2_block, k_lo, k_hi, s);
    default:
      return -1;
  }
}

// Global pass: stage k's strides 2^j_hi down to 2^j_lo (1..4 of them) in
// one read and write of buf.
extern "C" int repro_bitonic_global(int dtype, void* buf, long long n_pad,
                                    int log2_block, int k, int j_hi, int j_lo,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!known_dtype(dtype)) return -1;
  switch (j_hi - j_lo + 1) {
    case 1:
      return launch_global<1>(dtype, buf, n_pad, log2_block, k, j_lo, s);
    case 2:
      return launch_global<2>(dtype, buf, n_pad, log2_block, k, j_lo, s);
    case 3:
      return launch_global<3>(dtype, buf, n_pad, log2_block, k, j_lo, s);
    case 4:
      return launch_global<4>(dtype, buf, n_pad, log2_block, k, j_lo, s);
    default:
      return -1;
  }
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
