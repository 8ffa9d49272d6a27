// Matrix product c(M,N) = a(M,K) @ b(K,N), f32 accumulation, cast to the
// operands' type (f32 or bf16) on the store.
//
// Replaces: src/repro/kernels/matmul.py, matmul -> _matmul_kernel (the
// Pallas tiled-MXU kernel with an f32 VMEM accumulator).
//
// What bounds it on an H100: on the Matrix motif's path K is the matrix
// dim (8..2048) and N the centroid or batch count (2..1024, often 8..32
// or 128).  The reference's products are full f32, so TF32 stays off and
// the work is f32 FMA at 67 TFLOP/s.  At wide N that rate bounds it
// ((12288,2048)@(2048,128): 6.44 GFLOP, 0.096 ms); at narrow N the
// product has a few flops a byte and reading a(M,K) bounds it
// ((65536,2048)@(2048,8): 0.54 GB, 0.161 ms); at few rows and long K,
// the AI proxies' fully_connected ((32,2048)@(2048,2048)), reading b
// (16.8 MB, 0.005 ms) and the FMAs (0.004 ms) weigh about the same.
// Three forms, chosen in the launch: the narrow one where a's rows lie on
// the 16-byte grid and N <= SMALL_M_N (16), or N <= MAX_N (NARROW_N, 32)
// from FULL_M rows on (a 256-row block for each of 132 SMs); else the
// split one where M <= split::MAX_M (128) and K cuts into at least two
// slices (split::slices); the wide one otherwise.  repro_torch.bench.thresholds
// measured the bounds: at (65536, 2048) the narrow form beat the wide
// one at every N up to 32 (0.29-0.33 ms against 0.44); at (12288, 2048),
// 48 blocks, it won up to N = 16 and lost at 24 and 32 (0.18 ms against
// 0.13).
//
// Narrow: one pass over a.  A block of 128 threads owns 256 rows, two a
// thread, and walks K in 16-wide slabs through a 4-stage cp.async ring in
// shared memory: three slabs in flight under the FMAs, 48 KB a block, two
// blocks an SM.  a's rows are padded by 16 bytes, so a thread's 4-k reads
// of its own row are conflict-free.  b's slab (16 x N, zero-padded to
// NP = 8, 16 or 32 columns) rides the same ring, f32 by 4-byte cp.async
// (bf16 converted on its way in), and is read by the whole warp at one
// address, a broadcast.  Each thread keeps its rows' NP sums in
// registers and adds the products in k order, as torch.matmul's sgemm
// does at these shapes (its bits are equal wherever it does not split
// K); no sum crosses threads, so the order is fixed.
//
// Wide: the SIMT FMA tile loop.  A 256-thread block owns a
// BM x BN tile, each thread a (BM/16) x (BN/16) register tile (8 x 8 in
// the 128 x 128 tile): per k it reads BM/16 + BN/16 values of shared
// memory for (BM/16)·(BN/16) FMAs.  a is stored k-major (transposed on
// its way into shared memory), so a thread's rows come in as one float4
// or float2 read; b is stored as it lies.  K runs in 16-wide slabs
// through two shared-memory stages: the next slab's loads are issued
// before this slab's FMAs, a through registers (it is transposed), b by
// cp.async straight into shared memory where it is f32 with 16-byte rows
// (through registers otherwise), so one barrier a slab remains.  The
// tile is chosen at launch so the grid fills the SMs: of the tiles
//
//   BM x BN    thread tile
//   128 x 128  8 x 8
//    96 x 128  6 x 8
//    64 x 128  4 x 8
//   128 x  64  8 x 4
//    64 x  64  4 x 4
//
// it takes the one whose busiest SM has the least output to compute,
// ceil(blocks / SMs)·BM·BN, the larger tile on a tie.  On 132 SMs:
// (12288, ., 128) takes 96 x 128 (128 blocks, 97 % of one wave; 128 x 128
// gives 96 blocks, 73 %), (32768, ., 128) takes 128 x 128 (256 blocks,
// 1.94 waves), (300, ., 150) takes 64 x 64.
//
// Loads: 16 bytes (4 f32 or 8 bf16) when the rows allow it (K, and for
// the wide form N, a multiple of the unit) and the base pointers lie on
// the 16-byte grid; the wide form loads element by element with bounds
// checks otherwise, and takes every product the narrow form cannot.
// Ragged M, N and K edges are zero-filled in the loads and masked in the
// store, so no padded copy is made; offsets are 64-bit.  bf16 operands
// are converted to f32 on load and the result rounded once on the store.
//
// Split: for few rows and long K, where the wide form's grid would leave
// most SMs idle ((32, 2048, 2048) takes its 64 x 64 tile: 32 blocks on
// 132 SMs, each walking all of K, half its rows zero).  A 128-thread
// block owns a 32 x 64 tile, each thread 4 rows x 4 columns, and one of
// S slices of K, S = min(8, 396 / tiles, K / MIN_K) (split::slices), so
// tiles x S is up to three blocks an SM: 32 tiles x 8 slices = 256
// blocks at (32, 2048, 2048).  A block's slabs wait on one another, so
// more blocks an SM, not a deeper ring, hide the wait:
// repro_torch.bench.split_tiles timed a 32 x 128 tile of 256 threads,
// one block an SM, 1.25x slower, a ring of 3 slabs or 64-wide slabs
// within 3 %, and a ring of 8 slabs 1.5x slower (PERF.md §6).  A slice
// streams through a 4-stage ring of 32-wide slabs by 16-byte cp.async
// (value by value off the grid), a's slab as it lies, its rows padded by
// one unit, so a thread reads 4 k of each of its rows and 4 columns of b
// for each k as 8 vector loads for 64 FMAs; it sums in registers in k
// order.  The S blocks of a tile form a thread
// block cluster (S <= 8, the portable size): each writes its partial tile
// to its own shared memory, and after the cluster's barrier rank r adds
// its share of the tile from every rank's shared memory, in rank order,
// and stores it.  One launch, no atomics, no scratch buffer; the sums
// are not in k order, but two calls give the same bits.
//
// Lanes: repro_matmul_lanes runs L independent products in one launch
// (the population form's batched Matrix motif under torch.func.vmap).
// blockIdx.z picks the lane, whose a, b and c start sa, sb and sc
// elements past the lane before (0 for an operand all lanes share); each
// lane's tile, form and k order are those of its own one-lane launch, so
// a lane's bits equal that launch's.  One lane with strides 0 is the
// plain product.
//
// moe_dispatch.cu's f32 form is a loop of the same kind with its own
// tile: its A operand, the mask stripe, is read column-major in place.
#include <cooperative_groups.h>

#include <type_traits>

#include "wgmma.cuh"  // wg::cp_async16 and its commit / wait

namespace {

template <typename T>
constexpr int kUnit = 16 / static_cast<int>(sizeof(T));  // elements a unit

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte global -> shared copy; with `pred` false it writes zeros and
// reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// one 16-byte unit of T at p (on the 16-byte grid), as f32
template <typename T>
__device__ __forceinline__ void load_unit(const T* p, float (&f)[kUnit<T>]) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), f);
}

// lanes of one launch: n products, operand x of lane z at x + z * sx
struct Lanes {
  int64_t n, sa, sb, sc;
};

// ---------------------------------------------------------------------------
// narrow form
// ---------------------------------------------------------------------------
namespace narrow {

constexpr int THREADS = 128;
constexpr int ROWS = 2;  // rows a thread
constexpr int BM = THREADS * ROWS;
constexpr int BK = 16;
constexpr int STAGES = 4;
constexpr long long MAX_N = 32;  // matmul.py: NARROW_N
// rows from which the narrow form takes N up to MAX_N: a block for each of
// an H100's 132 SMs; below it only N <= SMALL_M_N (NARROW_FULL_M and
// NARROW_SMALL_M_N in matmul.py)
constexpr long long FULL_M = BM * 132;
constexpr long long SMALL_M_N = 16;

template <typename T>
constexpr int kStride = BK + kUnit<T>;  // a's row in shared memory

template <typename T, int NP>
constexpr int smem_bytes() {
  return STAGES * (BM * kStride<T> * static_cast<int>(sizeof(T)) + BK * NP * 4);
}

// 4 consecutive values of T at p, as f32 (p 16- or 8-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// A block's loads of one slab into one stage of the ring (a's rows lie on
// the 16-byte grid: the launch takes the wide form otherwise).
template <typename T, int NP>
struct Slabs {
  static constexpr int V = kUnit<T>;
  static constexpr int S = kStride<T>;
  static constexpr int UPR = BK / V;   // units of a row in a slab
  static constexpr int UA = BM * UPR;  // units of a in a slab
  static constexpr int EB = BK * NP;   // values of b in a slab
  static constexpr int NB = EB / THREADS;
  static_assert(UA % THREADS == 0 && EB % THREADS == 0, "slab shape");

  const T* a;
  const T* b;
  T* as;      // [STAGES][BM][S]
  float* bs;  // [STAGES][BK][NP]
  int64_t M, N, K, row0;
  int tid;

  // slab kt of a -> stage s: 16-byte cp.async, zero past M and K
  __device__ __forceinline__ void issue_a(int64_t kt, int s) const {
    T* dst = as + s * BM * S;
    const int64_t k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < UA / THREADS; ++i) {
      const int u = tid + i * THREADS;
      const int m = u / UPR, q = u % UPR;
      const int64_t gm = row0 + m, gk = k0 + q * V;
      const bool in = gm < M && gk < K;
      wg::cp_async16(smem_u32(dst + m * S + q * V), in ? a + gm * K + gk : a,
                     in);
    }
  }
  // slab kt of b -> stage s, zero past K and N: f32 by 4-byte cp.async,
  // so it lands under the FMAs like a; bf16 loaded, converted and stored
  // here (its values wait in no register across the FMAs)
  __device__ __forceinline__ void issue_b(int64_t kt, int s) const {
    const int64_t k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / NP, n = e % NP;
      const int64_t gk = k0 + kk;
      const bool in = gk < K && n < N;
      if constexpr (std::is_same_v<T, float>) {
        cp_async4(smem_u32(bs + s * EB + e), in ? b + gk * N + n : b, in);
      } else {
        bs[s * EB + e] = in ? to_f32(b[gk * N + n]) : 0.0f;
      }
    }
  }
};

template <typename T, int NP>
__global__ void __launch_bounds__(THREADS)
kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
       int64_t M, int64_t N, int64_t K, int64_t sa, int64_t sb, int64_t sc) {
  using L = Slabs<T, NP>;
  a += blockIdx.z * sa;  // this block's lane
  b += blockIdx.z * sb;
  c += blockIdx.z * sc;
  constexpr int S = L::S;
  constexpr int EB = L::EB;
  extern __shared__ __align__(16) uint8_t smem[];
  T* as = reinterpret_cast<T*>(smem);
  float* bs = reinterpret_cast<float*>(smem + STAGES * BM * S * sizeof(T));

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t nk = (K + BK - 1) / BK;
  const L ld{a, b, as, bs, M, N, K, row0, tid};

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      ld.issue_a(s, s);
      ld.issue_b(s, s);
    }
    wg::cp_async_commit();
  }

  float acc[ROWS][NP];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int n = 0; n < NP; ++n) acc[r][n] = 0.0f;

  for (int64_t kt = 0; kt < nk; ++kt) {
    wg::cp_async_wait<STAGES - 2>();  // this thread's copies of slab kt
    __syncthreads();                  // everyone's, and slab kt-1 is done
    const int64_t nt = kt + STAGES - 1;
    const int ns = static_cast<int>(nt % STAGES);
    const bool more = nt < nk;
    if (more) {
      ld.issue_a(nt, ns);
      ld.issue_b(nt, ns);
    }
    wg::cp_async_commit();

    const int cs = static_cast<int>(kt % STAGES);
    const T* ar = as + cs * BM * S;
    const float* br = bs + cs * EB;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float av[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) load4(ar + (tid + r * THREADS) * S + k4, av[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int n4 = 0; n4 < NP / 4; ++n4) {
          const float4 bv =
              *reinterpret_cast<const float4*>(br + (k4 + j) * NP + n4 * 4);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            acc[r][n4 * 4 + 0] = fmaf(av[r][j], bv.x, acc[r][n4 * 4 + 0]);
            acc[r][n4 * 4 + 1] = fmaf(av[r][j], bv.y, acc[r][n4 * 4 + 1]);
            acc[r][n4 * 4 + 2] = fmaf(av[r][j], bv.z, acc[r][n4 * 4 + 2]);
            acc[r][n4 * 4 + 3] = fmaf(av[r][j], bv.w, acc[r][n4 * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t gm = row0 + tid + r * THREADS;
    if (gm >= M) continue;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < N) c[gm * N + n] = from_f32<T>(acc[r][n]);
  }
}

template <typename T, int NP>
int launch_np(const T* a, const T* b, T* c, int64_t M, int64_t N, int64_t K,
              const Lanes& ln, cudaStream_t s) {
  constexpr int bytes = smem_bytes<T, NP>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), 1,
                  static_cast<unsigned>(ln.n));
  kernel<T, NP><<<grid, THREADS, bytes, s>>>(a, b, c, M, N, K, ln.sa, ln.sb,
                                             ln.sc);
  return launch_status();
}

template <typename T>
int launch(const T* a, const T* b, T* c, int64_t M, int64_t N, int64_t K,
           const Lanes& ln, cudaStream_t s) {
  if (N <= 8) return launch_np<T, 8>(a, b, c, M, N, K, ln, s);
  if (N <= 16) return launch_np<T, 16>(a, b, c, M, N, K, ln, s);
  return launch_np<T, 32>(a, b, c, M, N, K, ln, s);
}

}  // namespace narrow

// ---------------------------------------------------------------------------
// wide form
// ---------------------------------------------------------------------------
namespace wide {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int BK = 16;

// A block's loads of one slab: a transposed through registers into the
// k-major stage, b by cp.async (f32 with 16-byte rows) or through
// registers.
template <typename T, int BM, int BN, bool VEC>
struct Slabs {
  static constexpr int V = kUnit<T>;
  static constexpr int SA = BM + 4, SB = BN + 4;  // shared rows, float4-aligned
  static constexpr int APR = BK / V, BPR = BN / V;  // units a row of a, b slab
  static constexpr int UA = BM * APR, UB = BK * BPR;
  static constexpr int NA = (UA + THREADS - 1) / THREADS;
  static constexpr int NB = (UB + THREADS - 1) / THREADS;
  static constexpr bool B_ASYNC = VEC && std::is_same_v<T, float>;

  const T* a;
  const T* b;
  float (*as)[BK][SA];  // [2][BK][SA], k-major
  float (*bs)[BK][SB];  // [2][BK][SB]
  int64_t M, N, K, row0, col0;
  int tid;
  float ra[NA][V];
  float rb[NB][V];

  __device__ __forceinline__ void load_a(int64_t k0) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int u = tid + i * THREADS;
      if (UA % THREADS != 0 && u >= UA) break;
      const int m = u / APR, q = u % APR;
      const int64_t gm = row0 + m, gk = k0 + q * V;
      if constexpr (VEC) {
        if (gm < M && gk < K) {
          load_unit(a + gm * K + gk, ra[i]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) ra[i][j] = 0.0f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          ra[i][j] = (gm < M && gk + j < K) ? to_f32(a[gm * K + gk + j]) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void store_a(int s) const {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int u = tid + i * THREADS;
      if (UA % THREADS != 0 && u >= UA) break;
      const int m = u / APR, q = u % APR;
#pragma unroll
      for (int j = 0; j < V; ++j) as[s][q * V + j][m] = ra[i][j];
    }
  }
  // cp.async straight to stage s, or into registers for store_b
  __device__ __forceinline__ void load_b(int64_t k0, int s) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int u = tid + i * THREADS;
      if (UB % THREADS != 0 && u >= UB) break;
      const int kk = u / BPR, q = u % BPR;
      const int64_t gk = k0 + kk, gn = col0 + q * V;
      if constexpr (B_ASYNC) {
        const bool in = gk < K && gn < N;
        wg::cp_async16(smem_u32(&bs[s][kk][q * V]), in ? b + gk * N + gn : b, in);
      } else if constexpr (VEC) {
        if (gk < K && gn < N) {
          load_unit(b + gk * N + gn, rb[i]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) rb[i][j] = 0.0f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          rb[i][j] = (gk < K && gn + j < N) ? to_f32(b[gk * N + gn + j]) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void store_b(int s) const {
    if constexpr (!B_ASYNC) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int u = tid + i * THREADS;
        if (UB % THREADS != 0 && u >= UB) break;
        const int kk = u / BPR, q = u % BPR;
#pragma unroll
        for (int j = 0; j < V; ++j) bs[s][kk][q * V + j] = rb[i][j];
      }
    }
  }
};

// two blocks an SM (128 registers a thread) for the smaller tiles; the
// 128 x 128 tile's 64 sums and its prefetch take more, so it runs one
template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, BM * BN >= 128 * 128 ? 1 : 2)
kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
       int64_t M, int64_t N, int64_t K, int64_t sa, int64_t sb, int64_t sc) {
  using L = Slabs<T, BM, BN, VEC>;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int RV = TM % 4 == 0 ? 4 : 2;  // a thread's rows: TM/RV runs
  constexpr int CV = TN % 4 == 0 ? 4 : 2;  // of RV, 16·RV apart
  static_assert(BM % 32 == 0 && BN % 64 == 0 && TM % RV == 0, "tile shape");

  __shared__ __align__(16) float as[2][BK][L::SA];  // k-major
  __shared__ __align__(16) float bs[2][BK][L::SB];
  a += blockIdx.z * sa;  // this block's lane
  b += blockIdx.z * sb;
  c += blockIdx.z * sc;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t nk = (K + BK - 1) / BK;
  L ld{a, b, as, bs, M, N, K, row0, col0, tid, {}, {}};

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  ld.load_a(0);
  ld.load_b(0, 0);
  ld.store_a(0);
  ld.store_b(0);
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  __syncthreads();

  for (int64_t kt = 0; kt < nk; ++kt) {
    const int cur = static_cast<int>(kt & 1);
    const bool more = kt + 1 < nk;
    if (more) {  // the next slab's loads, in flight under this slab's FMAs
      ld.load_a((kt + 1) * BK);
      ld.load_b((kt + 1) * BK, cur ^ 1);
    }
    wg::cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
      float bv[TN];
#pragma unroll
      for (int g = 0; g < TM / RV; ++g) {
        const float* p = &as[cur][kk][g * 16 * RV + ty * RV];
        if constexpr (RV == 4) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          av[g * 4 + 0] = v.x;
          av[g * 4 + 1] = v.y;
          av[g * 4 + 2] = v.z;
          av[g * 4 + 3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(p);
          av[g * 2 + 0] = v.x;
          av[g * 2 + 1] = v.y;
        }
      }
#pragma unroll
      for (int g = 0; g < TN / CV; ++g) {
        const float* p = &bs[cur][kk][g * 16 * CV + tx * CV];
        if constexpr (CV == 4) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          bv[g * 4 + 0] = v.x;
          bv[g * 4 + 1] = v.y;
          bv[g * 4 + 2] = v.z;
          bv[g * 4 + 3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(p);
          bv[g * 2 + 0] = v.x;
          bv[g * 2 + 1] = v.y;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      ld.store_a(cur ^ 1);
      ld.store_b(cur ^ 1);
    }
    wg::cp_async_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = row0 + (i / RV) * 16 * RV + ty * RV + i % RV;
    if (gm >= M) continue;
#pragma unroll
    for (int g = 0; g < TN / CV; ++g) {
      const int64_t gn = col0 + g * 16 * CV + tx * CV;
      if constexpr (VEC && CV == 4 && std::is_same_v<T, float>) {
        if (gn < N)  // N is a multiple of 4: the whole float4 is inside
          *reinterpret_cast<float4*>(c + gm * N + gn) =
              make_float4(acc[i][g * 4], acc[i][g * 4 + 1],
                          acc[i][g * 4 + 2], acc[i][g * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < CV; ++j)
          if (gn + j < N) c[gm * N + gn + j] = from_f32<T>(acc[i][g * CV + j]);
      }
    }
  }
}

struct Tile {
  int bm, bn;
};
// largest first: a tie on the busiest SM's work goes to the larger tile
constexpr Tile kTiles[] = {{128, 128}, {96, 128}, {64, 128}, {128, 64}, {64, 64}};

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// the tile whose busiest SM computes the fewest outputs
Tile pick(int64_t M, int64_t N) {
  const int64_t sms = sm_count();
  Tile best = kTiles[0];
  int64_t best_cost = -1;
  for (const Tile& t : kTiles) {
    const int64_t blocks = ((M + t.bm - 1) / t.bm) * ((N + t.bn - 1) / t.bn);
    const int64_t cost = (blocks + sms - 1) / sms * t.bm * t.bn;
    if (best_cost < 0 || cost < best_cost) {
      best = t;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, int BM, int BN, bool VEC>
int launch_tile(const T* a, const T* b, T* c, int64_t M, int64_t N, int64_t K,
                const Lanes& ln, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>(ln.n));
  kernel<T, BM, BN, VEC><<<grid, THREADS, 0, s>>>(a, b, c, M, N, K, ln.sa,
                                                  ln.sb, ln.sc);
  return launch_status();
}

// the tile is picked for one lane: a lane computes what its own launch would
template <typename T, bool VEC>
int launch(const T* a, const T* b, T* c, int64_t M, int64_t N, int64_t K,
           const Lanes& ln, cudaStream_t s) {
  const Tile t = pick(M, N);
  if (t.bm == 128 && t.bn == 128)
    return launch_tile<T, 128, 128, VEC>(a, b, c, M, N, K, ln, s);
  if (t.bm == 96) return launch_tile<T, 96, 128, VEC>(a, b, c, M, N, K, ln, s);
  if (t.bm == 64 && t.bn == 128)
    return launch_tile<T, 64, 128, VEC>(a, b, c, M, N, K, ln, s);
  if (t.bm == 128)
    return launch_tile<T, 128, 64, VEC>(a, b, c, M, N, K, ln, s);
  return launch_tile<T, 64, 64, VEC>(a, b, c, M, N, K, ln, s);
}

}  // namespace wide

// ---------------------------------------------------------------------------
// split form
// ---------------------------------------------------------------------------
namespace split {

namespace cg = cooperative_groups;

constexpr int BM = 32;         // a tile's rows
constexpr int BN = 64;         // its columns
constexpr int BK = 32;         // k of a slab
constexpr int STAGES = 4;      // slabs in the ring
constexpr int MIN_BLOCKS = 3;  // blocks an SM, for the registers
// a thread's 4 x 4 outputs: 16 threads along a 64-column group, BM / 4
// row groups, BN / 64 column groups
constexpr int RG = BM / 4, CG = BN / 64;
constexpr int THREADS = 16 * RG * CG;
// matmul.py: SPLIT_MAX_M, SPLIT_MIN_K, SPLIT_BLOCKS and SPLIT_MAX_SLICES
constexpr long long MAX_M = 128;
constexpr long long MIN_K = 256;      // k a slice sums, at the least
constexpr long long BLOCKS = 3 * 132;  // three blocks for each of 132 SMs
constexpr long long MAX_SLICES = 8;   // the portable cluster size

// The slices of K for (M, N, K): about BLOCKS blocks over the tiles, at
// most MAX_SLICES, none shorter than MIN_K; 1 is no split.  A shape's
// own, so a lane of a launch takes its own launch's slices.
long long slices(long long M, long long N, long long K) {
  const long long tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  long long s = BLOCKS / tiles;
  if (s > MAX_SLICES) s = MAX_SLICES;
  if (s > K / MIN_K) s = K / MIN_K;
  return s < 1 ? 1 : s;
}

template <typename T>
struct Smem {
  static constexpr int PA = BK + kUnit<T>;  // a's row, padded by a unit
  static constexpr int A = BM * PA;         // values of a slab of a
  static constexpr int B = BK * BN;         // of b
  static constexpr int STAGE = A + B;
  static constexpr int RING = STAGES * STAGE * static_cast<int>(sizeof(T));
  static constexpr int PART = BM * BN * 4;  // the partial tile, f32
  static constexpr int BYTES = RING > PART ? RING : PART;
};

// one value global -> shared, zero where !in (src still a valid address):
// f32 by 4-byte cp.async, bf16 through a register
__device__ __forceinline__ void copy_value(float* dst, const float* src,
                                           bool in) {
  cp_async4(smem_u32(dst), src, in);
}
__device__ __forceinline__ void copy_value(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool in) {
  *dst = in ? *src : __float2bfloat16(0.0f);
}

// slab kt of a and b -> one stage, zero past M, N and K: 16-byte units
// where every row lies on the grid (VEC), else value by value
template <typename T, bool VEC>
__device__ __forceinline__ void issue(const T* a, const T* b, T* as, T* bs,
                                      int64_t M, int64_t N, int64_t K,
                                      int64_t row0, int64_t col0, int64_t kt,
                                      int tid) {
  using L = Smem<T>;
  constexpr int V = kUnit<T>;
  const int64_t k0 = kt * BK;
  if constexpr (VEC) {
    constexpr int UA = BM * BK / V, UB = BK * BN / V;
    static_assert(UB % THREADS == 0, "slab shape");
#pragma unroll
    for (int u = tid; u < UA; u += THREADS) {
      const int m = u / (BK / V), q = u % (BK / V);
      const int64_t gm = row0 + m, gk = k0 + q * V;
      const bool in = gm < M && gk < K;
      wg::cp_async16(smem_u32(as + m * L::PA + q * V),
                     in ? a + gm * K + gk : a, in);
    }
#pragma unroll
    for (int i = 0; i < UB / THREADS; ++i) {
      const int u = tid + i * THREADS;
      const int kk = u / (BN / V), q = u % (BN / V);
      const int64_t gk = k0 + kk, gn = col0 + q * V;
      const bool in = gk < K && gn < N;
      wg::cp_async16(smem_u32(bs + kk * BN + q * V),
                     in ? b + gk * N + gn : b, in);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, kk = e % BK;
      const int64_t gm = row0 + m, gk = k0 + kk;
      const bool in = gm < M && gk < K;
      copy_value(as + m * L::PA + kk, in ? a + gm * K + gk : a, in);
    }
#pragma unroll 4
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, n = e % BN;
      const int64_t gk = k0 + kk, gn = col0 + n;
      const bool in = gk < K && gn < N;
      copy_value(bs + kk * BN + n, in ? b + gk * N + gn : b, in);
    }
  }
}

// grid (S·row tiles, column tiles, lanes) in clusters of (S, 1, 1): block
// x is rank x % S of tile x / S, and sums slice rank of K's slabs
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
       int64_t M, int64_t N, int64_t K, int64_t sa, int64_t sb, int64_t sc,
       int S) {
  using L = Smem<T>;
  a += blockIdx.z * sa;  // this block's lane
  b += blockIdx.z * sb;
  c += blockIdx.z * sc;
  extern __shared__ __align__(16) uint8_t smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x;
  const int rq = 4 * ((tid / 16) % RG);              // its rows rq..+3
  const int cn = (tid / (16 * RG)) * 64 + (tid % 16) * 4;  // columns cn..+3
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / S) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t nk = (K + BK - 1) / BK;  // slabs of the whole of K
  const int64_t kb = nk * rank / S;      // this slice's
  const int64_t n = nk * (rank + 1) / S - kb;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n)
      issue<T, VEC>(a, b, ring + st * L::STAGE, ring + st * L::STAGE + L::A,
                    M, N, K, row0, col0, kb + st, tid);
    wg::cp_async_commit();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int64_t t = 0; t < n; ++t) {
    wg::cp_async_wait<STAGES - 2>();  // this thread's copies of slab t
    __syncthreads();                  // everyone's, and slab t-1 is done
    const int64_t nt = t + STAGES - 1;
    if (nt < n) {
      T* const st = ring + (nt % STAGES) * L::STAGE;
      issue<T, VEC>(a, b, st, st + L::A, M, N, K, row0, col0, kb + nt, tid);
    }
    wg::cp_async_commit();

    const T* const as = ring + (t % STAGES) * L::STAGE;
    const T* const bs = as + L::A;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float av[4][4], bv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) narrow::load4(as + (rq + i) * L::PA + k4, av[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) narrow::load4(bs + (k4 + j) * BN + cn, bv[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][e] = fmaf(av[i][j], bv[j][e], acc[i][e]);
    }
  }

  // the partial tile into this block's own shared memory, over the ring
  wg::cp_async_wait<0>();
  __syncthreads();
  float* const part = reinterpret_cast<float*>(smem);  // [BM][BN]
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(part + (rq + i) * BN + cn) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();  // every slice's partial tile is written

  // rank r adds its share of the tile's 4-column units over the ranks, in
  // rank order, and stores it
  constexpr int UNITS = BM * BN / 4;
  const int u1 = UNITS * (rank + 1) / S;
  for (int u = UNITS * rank / S + tid; u < u1; u += THREADS) {
    float4 p[MAX_SLICES];  // every rank's unit u, the reads all in flight
#pragma unroll
    for (int r = 0; r < MAX_SLICES; ++r)
      if (r < S)
        p[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, r) + 4 * u);
    float4 sum = p[0];
#pragma unroll
    for (int r = 1; r < MAX_SLICES; ++r) {
      if (r < S) {
        sum.x += p[r].x;
        sum.y += p[r].y;
        sum.z += p[r].z;
        sum.w += p[r].w;
      }
    }
    const int64_t gm = row0 + u / (BN / 4), gn = col0 + (u % (BN / 4)) * 4;
    if (gm >= M) continue;
    T* const dst = c + gm * N + gn;
    if constexpr (VEC && std::is_same_v<T, float>) {
      if (gn < N) *reinterpret_cast<float4*>(dst) = sum;  // N % 4 == 0
    } else {
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gn + e < N) dst[e] = from_f32<T>(v[e]);
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <typename T, bool VEC>
int launch(const T* a, const T* b, T* c, int64_t M, int64_t N, int64_t K,
           const Lanes& ln, cudaStream_t s) {
  const int S = static_cast<int>(slices(M, N, K));
  constexpr int bytes = Smem<T>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(S * ((M + BM - 1) / BM)),
                     static_cast<unsigned>((N + BN - 1) / BN),
                     static_cast<unsigned>(ln.n));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(S);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel<T, VEC>, a, b, c, M,
                                             N, K, ln.sa, ln.sb, ln.sc, S);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_status();
}

}  // namespace split

bool on_grid(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// form: 0 picks from M, N, K and a's alignment (see the note), 1 forces
// the wide form, 2 the narrow one (N <= MAX_N, a's rows on the 16-byte
// grid), 3 the split one.  An operand is on the grid when every lane's
// copy is: its base and its lane stride.
template <typename T>
int launch(int form, const void* a, const void* b, void* c, int64_t M,
           int64_t N, int64_t K, const Lanes& ln, cudaStream_t s) {
  if (ln.n < 1 || ln.n > 65535) return -1;
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  T* ct = static_cast<T*>(c);
  constexpr int V = kUnit<T>;
  const bool rows_a = on_grid(a) && K % V == 0 && ln.sa % V == 0;
  const bool narrow_n =
      N <= narrow::SMALL_M_N || (N <= narrow::MAX_N && M >= narrow::FULL_M);
  if (form == 0)
    form = rows_a && narrow_n ? 2
           : M <= split::MAX_M && split::slices(M, N, K) > 1 ? 3 : 1;
  if (form == 2) {
    if (N > narrow::MAX_N || !rows_a) return -1;
    return narrow::launch<T>(at, bt, ct, M, N, K, ln, s);
  }
  const bool vec = rows_a && on_grid(b) && on_grid(c) && N % V == 0 &&
                   ln.sb % V == 0 && ln.sc % V == 0;
  if (form == 3)
    return vec ? split::launch<T, true>(at, bt, ct, M, N, K, ln, s)
               : split::launch<T, false>(at, bt, ct, M, N, K, ln, s);
  if (form != 1) return -1;
  return vec ? wide::launch<T, true>(at, bt, ct, M, N, K, ln, s)
             : wide::launch<T, false>(at, bt, ct, M, N, K, ln, s);
}

}  // namespace

extern "C" int repro_matmul_lanes(int dtype, int form, const void* a,
                                  const void* b, void* c, long long M,
                                  long long N, long long K, long long lanes,
                                  long long sa, long long sb, long long sc,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Lanes ln{lanes, sa, sb, sc};
  switch (dtype) {
    case kFloat32:
      return launch<float>(form, a, b, c, M, N, K, ln, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(form, a, b, c, M, N, K, ln, s);
    default:
      return -1;
  }
}
