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
// group (T=4096, E=64, C=480, D=2048) that is hundreds of operations a
// byte, past the 295 where bf16 tensor cores stop waiting on memory and
// far past the 20 of the f32 FMA rate.
//
// Two forms, by x's type; both are the general contraction, right for
// any mask.  Each mask value is rounded to x's type on its way into shared
// memory (the reference casts the mask to x.dtype before the product), so
// no cast pass over the mask runs.  For a one-hot mask each output is one
// product with 1.0 plus exact zeros, equal to the plain version bit for
// bit in either form.
//
// f32 x: full-f32 FMA (the reference product is full f32, so no TF32, and
// no split-TF32 either: it would lose the one-hot exactness).  A block of
// 256 threads computes a 256 (c) x 128 (d) tile of one expert, each
// thread a 16 x 8 register tile, over 32-token slabs in a ring of 3
// stages (144 KB of dynamic shared memory, one block an SM).  Each output
// is one fmaf chain in token order.  What the design does about each
// hazard:
//  1. Layout: mask[:, e, :]ᵀ is contiguous along c and x along d, which
//     is the k-major layout an outer product reads, so both slabs are
//     staged as they lie (a slab row is 256 or 128 contiguous f32); no
//     transpose is made anywhere.
//  2. Shared-memory reads: per token a thread reads its 16 rows and 8
//     columns as six float4 (rows rt + 64·g, columns ct + 64·h, rt =
//     4·(tid / 16), ct = 4·(tid % 16)), 6 vector loads for 128 FMAs; a
//     warp's 16 column reads are 256 consecutive bytes and its row reads
//     two addresses, so no bank conflicts and no padding.
//  3. Overlap: slabs go by 16-byte cp.async straight into shared memory,
//     two slabs ahead of the FMAs, one barrier a slab.  A bf16 mask,
//     and any operand off the 16-byte grid, passes through registers
//     instead: loaded before the slab's FMAs, stored after them (a bf16
//     mask converted to f32 on the way, exactly).
//  4. Tile: 256 rows pad the capacity 480 of deepseek-v2-lite-16b's group
//     to 512 (6 % of the FMAs).  Of the tiles timed on the card this one
//     was the fastest: 128 x 128 (8 x 8 a thread, two blocks an SM), 128
//     x 256 and a 96 x 128 tile of 192 threads, which pads nothing at C =
//     480, were slower, as were other slab depths.  A fourth stage was
//     about 1 % faster but made a register-staged path spill.
//  5. Mask re-reads: each (e, c-tile) mask slab is read once per D tile;
//     D tiles are the fastest grid index, so the blocks that share a
//     slab run together and L2 serves all but the first read.
//  6. Edges: tokens past T, rows past C and columns past D are
//     zero-filled in the loads (cp.async with source size 0), the store
//     is masked; offsets are 64-bit.  A 4-value unit is loaded whole
//     when the rows and the base allow it (C, D multiples of 4; the mask
//     base on a 16-byte grid in f32, 8 in bf16; x's on 16), else value by
//     value: the launch picks each operand's path and the kernel is
//     compiled for each.
//  7. Registers: 128 sums plus 24 operands a thread; one block an SM
//     leaves 255 a thread, which the paths that stage a slab through
//     registers (32 or 16 values more) also fit (ptxas reports spills).
// No all-zero slab is skipped: the op is the dense contraction for any
// mask, and 0·inf gives NaN as in the reference.  matmul.cu's wide form
// is a loop of the same shape but not shared with this one: its A is
// K-major and goes through registers to be transposed, and it picks its
// tile to fill the SMs at small M.
//
// bf16 x: wgmma on the tensor cores (wgmma.cuh).  A block of two
// warpgroups computes a 128 (c) x 256 (d) tile of one expert, each
// warpgroup a 64 x 256 half with m64n256k16, over 64-token slabs in a
// ring of 4 stages (48 KB each) in dynamic shared memory, loaded two slabs
// ahead of the tensor cores.  What the design does about each hazard:
//  1. Both operands are MN-major: mask[:, e, :]ᵀ is contiguous along c
//     with stride E·C along t, x contiguous along d.  Both are staged
//     as they lie, in the 128-byte-swizzled MN-major layout, and wgmma
//     reads them transposed (imm-trans-a = imm-trans-b = 1); no
//     transpose is made anywhere.
//  2. The async proxy: every slab is written by st.shared or cp.async,
//     so __syncthreads() and fence.proxy.async precede each wgmma group.
//  3. Ragged edges: rows past C, columns past D and tokens past T are
//     zero-filled in the loads (cp.async with source size 0), so padding
//     adds only exact zeros; the store is masked.
//  4. Alignment: 16-byte loads need 16-byte-aligned rows and bases.  The
//     launch picks each operand's width from C or D and its base pointer
//     (mask_vec, x_vec), and the kernel keeps a scalar path for the rest.
//  5. Shared memory: 193 KB a block, above the 48 KB default, so every
//     launch first raises the function's dynamic limit; a refused launch
//     returns its status.
//  6. Registers: the 64 x 256 f32 accumulator is 128 registers a thread,
//     plus 32 for the f32 mask in flight; one block of 256 threads an SM
//     leaves 255 a thread (ptxas reports spills).
//  7. Mask re-reads: each (e, c-tile) mask slab is read once per D tile.
//     A 256-wide tile halves that against 128 (8 reads at D = 2048), and
//     D tiles are the fastest grid index, so the blocks that share a slab
//     run together and L2 serves all but the first read.
// The f32 mask passes through registers (loaded an iteration before it is
// rounded to bf16 and stored, while the tensor cores run); a bf16 mask and
// x go straight to shared memory with cp.async.  Left out on purpose: TMA,
// warp specialisation, clusters and a persistent scheduler.  The
// "breakdown:" comments mark what bench/moe_breakdown.py cuts out of a
// copy of this file to time the loads and the tensor cores apart.
#include <type_traits>

#include "wgmma.cuh"

namespace {

namespace f32 {

constexpr int BM = 256;  // c rows
constexpr int BN = 128;  // d columns
constexpr int BK = 32;   // tokens a slab
constexpr int STAGES = 3;
constexpr int THREADS = 256;  // 16 x 16
constexpr int TM = BM / 16;   // rows a thread: runs of 4, 64 apart
constexpr int TN = BN / 16;   // columns a thread, likewise
constexpr int A_UNITS = BK * BM / 4;  // 4-value units of a mask slab
constexpr int B_UNITS = BK * BN / 4;  // ... of an x slab
constexpr int NA = A_UNITS / THREADS;
constexpr int NB = B_UNITS / THREADS;
constexpr int STAGE_FLOATS = BK * (BM + BN);
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;

static_assert(NA * THREADS == A_UNITS && NB * THREADS == B_UNITS,
              "slab shape");

// A block's loads of one slab into one stage: mask rows (t, c0..c0+BM)
// at As[t][·], x rows (t, d0..d0+BN) at Bs[t][·].  A_VEC / B_VEC: whole
// 4-value units (by cp.async for f32, through registers for a bf16
// mask); otherwise value by value through registers.
template <typename MaskT, bool A_VEC, bool B_VEC>
struct Slabs {
  static constexpr bool A_ASYNC = A_VEC && std::is_same_v<MaskT, float>;
  static constexpr bool B_ASYNC = B_VEC;

  const MaskT* mask;  // mask + e·C: element (t, c) at t·EC + c
  const float* x;
  float* smem;
  int64_t Tok, C, D, EC, c0, d0;
  int tid;
  float ra[A_ASYNC ? 1 : NA][4];
  float rb[B_ASYNC ? 1 : NB][4];

  __device__ float* as(int s) const { return smem + s * STAGE_FLOATS; }
  __device__ float* bs(int s) const { return as(s) + BK * BM; }

  // slab kt of the mask: cp.async into stage s, or into registers
  __device__ __forceinline__ void fetch_a(int64_t kt, int s) {
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int u = tid + j * THREADS;
      const int t = u / (BM / 4), c = (u % (BM / 4)) * 4;
      const int64_t gt = kt * BK + t, gc = c0 + c;
      const MaskT* p = mask + gt * EC + gc;
      if constexpr (A_ASYNC) {
        const bool in = gt < Tok && gc < C;
        wg::cp_async16(wg::smem_u32(as(s) + t * BM + c), in ? p : mask, in);
      } else if constexpr (A_VEC) {  // 4 bf16, converted exactly
        uint2 v = make_uint2(0u, 0u);
        if (gt < Tok && gc < C) v = __ldg(reinterpret_cast<const uint2*>(p));
        ra[j][0] = __uint_as_float(v.x << 16);
        ra[j][1] = __uint_as_float(v.x & 0xffff0000u);
        ra[j][2] = __uint_as_float(v.y << 16);
        ra[j][3] = __uint_as_float(v.y & 0xffff0000u);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ra[j][i] = gt < Tok && gc + i < C ? to_f32(p[i]) : 0.0f;
      }
    }
  }
  // slab kt of x: cp.async into stage s, or into registers
  __device__ __forceinline__ void fetch_b(int64_t kt, int s) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int u = tid + j * THREADS;
      const int t = u / (BN / 4), d = (u % (BN / 4)) * 4;
      const int64_t gt = kt * BK + t, gd = d0 + d;
      const float* p = x + gt * D + gd;
      if constexpr (B_ASYNC) {
        const bool in = gt < Tok && gd < D;
        wg::cp_async16(wg::smem_u32(bs(s) + t * BN + d), in ? p : x, in);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rb[j][i] = gt < Tok && gd + i < D ? p[i] : 0.0f;
      }
    }
  }
  // the registers of the last fetch -> stage s
  __device__ __forceinline__ void store(int s) const {
    if constexpr (!A_ASYNC) {
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        const int u = tid + j * THREADS;
        *reinterpret_cast<float4*>(as(s) + (u / (BM / 4)) * BM +
                                   (u % (BM / 4)) * 4) =
            make_float4(ra[j][0], ra[j][1], ra[j][2], ra[j][3]);
      }
    }
    if constexpr (!B_ASYNC) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int u = tid + j * THREADS;
        *reinterpret_cast<float4*>(bs(s) + (u / (BN / 4)) * BN +
                                   (u % (BN / 4)) * 4) =
            make_float4(rb[j][0], rb[j][1], rb[j][2], rb[j][3]);
      }
    }
  }
};

template <typename MaskT, bool A_VEC, bool B_VEC>
__global__ void __launch_bounds__(THREADS, 1)
dispatch_fma(const MaskT* __restrict__ mask, const float* __restrict__ x,
             float* __restrict__ out, int64_t Tok, int64_t E, int64_t C,
             int64_t D, int out_vec) {
  extern __shared__ __align__(16) float smem[];
  const int64_t e = blockIdx.z;
  const int tid = threadIdx.x;
  // this thread's rows rt + 64·g + {0..3} and columns ct + 64·h + {0..3}
  // of the block's tile
  const int rt = tid / 16 * 4, ct = tid % 16 * 4;
  Slabs<MaskT, A_VEC, B_VEC> ld{mask + e * C,
                                x,
                                smem,
                                Tok,
                                C,
                                D,
                                E * C,
                                static_cast<int64_t>(blockIdx.y) * BM,
                                static_cast<int64_t>(blockIdx.x) * BN,
                                tid,
                                {},
                                {}};
  const int64_t KT = (Tok + BK - 1) / BK;

  // The ring: slab kt sits in stage kt % STAGES.  Iteration kt waits for
  // slab kt, then refills the stage slab kt-1 used (every thread passed
  // the barrier after its FMAs) with slab kt + STAGES - 1: copies issued
  // before this slab's FMAs, register loads stored after them.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) {
      ld.fetch_a(s, s);
      ld.fetch_b(s, s);
      ld.store(s);
    }
    wg::cp_async_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int64_t kt = 0; kt < KT; ++kt) {
    wg::cp_async_wait<STAGES - 2>();  // this thread's copies of slab kt
    __syncthreads();  // everyone's, their stores, and slab kt-1 is done
    const int64_t nk = kt + STAGES - 1;
    const int ns = static_cast<int>(nk % STAGES);
    const bool more = nk < KT;
    if (more) {
      ld.fetch_a(nk, ns);
      ld.fetch_b(nk, ns);
    }
    wg::cp_async_commit();

    const int cs = static_cast<int>(kt % STAGES);
    const float* as = ld.as(cs) + rt;
    const float* bs = ld.bs(cs) + ct;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(as + k * BM + g * 64);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * BN + h * 64);
        b[4 * h] = v.x;
        b[4 * h + 1] = v.y;
        b[4 * h + 2] = v.z;
        b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) ld.store(ns);
  }

  // epilogue: float4 stores when D is a multiple of 4
  float* o = out + e * C * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = ld.c0 + (i / 4) * 64 + rt + i % 4;
    if (row >= C) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int64_t col = ld.d0 + h * 64 + ct;
      float* p = o + row * D + col;
      if (out_vec) {
        if (col < D)
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < D) p[j] = acc[i][4 * h + j];
      }
    }
  }
}

template <typename MaskT, bool A_VEC, bool B_VEC>
int launch_paths(const void* mask, const void* x, void* out, int64_t Tok,
                 int64_t E, int64_t C, int64_t D, int out_vec,
                 cudaStream_t s) {
  // per launch, so it holds on whichever device is current
  const cudaError_t attr = cudaFuncSetAttribute(
      dispatch_fma<MaskT, A_VEC, B_VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // D tiles fastest: the blocks that read one mask slab run together
  const dim3 grid(static_cast<unsigned>((D + BN - 1) / BN),
                  static_cast<unsigned>((C + BM - 1) / BM),
                  static_cast<unsigned>(E));
  dispatch_fma<MaskT, A_VEC, B_VEC><<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const MaskT*>(mask), static_cast<const float*>(x),
      static_cast<float*>(out), Tok, E, C, D, out_vec);
  return launch_status();
}

template <typename MaskT>
int launch(const void* mask, const void* x, void* out, int64_t Tok, int64_t E,
           int64_t C, int64_t D, cudaStream_t s) {
  // whole 4-value units where every unit read starts on its own size: the
  // mask's rows (stride E·C) and stripes (offset e·C) when C is a
  // multiple of 4, x's rows when D is, and each base
  const auto on = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const bool a_vec = C % 4 == 0 && on(mask, 4 * sizeof(MaskT));
  const bool b_vec = D % 4 == 0 && on(x, 16);
  const int out_vec = D % 4 == 0 && on(out, 16);
  if (a_vec && b_vec)
    return launch_paths<MaskT, true, true>(mask, x, out, Tok, E, C, D, out_vec, s);
  if (a_vec)
    return launch_paths<MaskT, true, false>(mask, x, out, Tok, E, C, D, out_vec, s);
  if (b_vec)
    return launch_paths<MaskT, false, true>(mask, x, out, Tok, E, C, D, out_vec, s);
  return launch_paths<MaskT, false, false>(mask, x, out, Tok, E, C, D, out_vec, s);
}

}  // namespace f32

namespace tc {

constexpr int BM = 128;  // c rows: two warpgroups of 64
constexpr int BN = 256;  // d columns
constexpr int BK = 64;   // tokens a slab
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int ATOM_BYTES = BK * 128;      // one 64-wide MN atom of a slab
constexpr int K16_BYTES = 16 * 128;       // one wgmma's 16 K rows
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment
constexpr int A_REGS = BM * BK / THREADS;  // mask values a thread stages

static_assert(A_REGS == 32 && BM * BK / 4 == 8 * THREADS, "tile shape");

template <typename MaskT>
struct Tile {
  const MaskT* mask;  // mask + e·C: element (t, c) at t·EC + c
  const __nv_bfloat16* x;
  int64_t Tok, C, D, EC, c0, d0;
  uint8_t* base;   // stage 0, 1024-byte aligned (generic address)
  uint32_t smem;   // the same as a shared-window address
  int tid;

  __device__ uint32_t a_slot(int s) const { return smem + s * STAGE_BYTES; }
  __device__ uint32_t b_slot(int s) const {
    return smem + s * STAGE_BYTES + A_BYTES;
  }

  // the mask slab kt -> registers (f32), zero past T and C
  __device__ void load_a_regs(int64_t kt, bool vec, float (&r)[A_REGS]) const {
    const int64_t t0 = kt * BK;
    if (vec) {  // f32 rows 16-byte aligned: 8 float4 a thread
#pragma unroll
      for (int j = 0; j < A_REGS / 4; ++j) {
        const int i = tid + j * THREADS;
        const int64_t gt = t0 + (i >> 5), gc = c0 + (i & 31) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gt < Tok && gc < C)
          v = __ldg(reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(mask) + gt * EC + gc));
        r[4 * j] = v.x;
        r[4 * j + 1] = v.y;
        r[4 * j + 2] = v.z;
        r[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < A_REGS; ++j) {
        const int i = tid + j * THREADS;
        const int64_t gt = t0 + (i >> 7), gc = c0 + (i & 127);
        r[j] = (gt < Tok && gc < C) ? to_f32(mask[gt * EC + gc]) : 0.0f;
      }
    }
  }

  // registers -> stage s, each value rounded to bf16 (round to nearest
  // even, as torch's cast)
  __device__ void store_a_regs(int s, bool vec,
                               const float (&r)[A_REGS]) const {
    uint8_t* a = base + s * STAGE_BYTES;
    if (vec) {
#pragma unroll
      for (int j = 0; j < A_REGS / 4; ++j) {
        const int i = tid + j * THREADS;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(r[4 * j], r[4 * j + 1]);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(r[4 * j + 2], r[4 * j + 3]);
        uint2 v;
        v.x = *reinterpret_cast<const uint32_t*>(&lo);
        v.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(a + wg::sw128_offset((i & 31) * 4, i >> 5,
                                                       BK)) = v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < A_REGS; ++j) {
        const int i = tid + j * THREADS;
        *reinterpret_cast<__nv_bfloat16*>(
            a + wg::sw128_offset(i & 127, i >> 7, BK)) = __float2bfloat16(r[j]);
      }
    }
  }

  // a bf16 mask slab with 16-byte rows: cp.async, 4 chunks a thread
  __device__ void load_a_async(int s, int64_t kt) const {
    const int64_t t0 = kt * BK;
#pragma unroll
    for (int j = 0; j < BM * BK / 8 / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int t = i >> 4, c = (i & 15) * 8;
      const int64_t gt = t0 + t, gc = c0 + c;
      const bool in = gt < Tok && gc < C;
      wg::cp_async16(a_slot(s) + wg::sw128_offset(c, t, BK),
                     in ? static_cast<const void*>(mask + gt * EC + gc)
                        : static_cast<const void*>(mask),
                     in);
    }
  }

  // the x slab kt -> stage s: cp.async when rows are 16-byte aligned,
  // else element by element
  __device__ void load_b(int s, int64_t kt, bool vec) const {
    const int64_t t0 = kt * BK;
    if (vec) {
#pragma unroll
      for (int j = 0; j < BK * BN / 8 / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int t = i >> 5, d = (i & 31) * 8;
        const int64_t gt = t0 + t, gd = d0 + d;
        const bool in = gt < Tok && gd < D;
        wg::cp_async16(b_slot(s) + wg::sw128_offset(d, t, BK),
                       in ? static_cast<const void*>(x + gt * D + gd)
                          : static_cast<const void*>(x),
                       in);
      }
    } else {
      uint8_t* b = base + s * STAGE_BYTES + A_BYTES;
#pragma unroll 8
      for (int j = 0; j < BK * BN / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int t = i >> 8, d = i & 255;
        const int64_t gt = t0 + t, gd = d0 + d;
        *reinterpret_cast<__nv_bfloat16*>(b + wg::sw128_offset(d, t, BK)) =
            (gt < Tok && gd < D) ? x[gt * D + gd] : __float2bfloat16(0.0f);
      }
    }
  }
};

template <typename MaskT>
__global__ void __launch_bounds__(THREADS, 1)
dispatch_wgmma(const MaskT* __restrict__ mask,
               const __nv_bfloat16* __restrict__ x,
               __nv_bfloat16* __restrict__ out, int64_t Tok, int64_t E,
               int64_t C, int64_t D, int mask_vec, int x_vec) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int64_t e = blockIdx.z;
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t aligned = (raw + 1023u) & ~1023u;
  Tile<MaskT> tile{mask + e * C,
                   x,
                   Tok,
                   C,
                   D,
                   E * C,
                   static_cast<int64_t>(blockIdx.y) * BM,
                   static_cast<int64_t>(blockIdx.x) * BN,
                   smem_raw + (aligned - raw),
                   aligned,
                   static_cast<int>(threadIdx.x)};
  // a bf16 mask with 16-byte rows goes by cp.async; otherwise the mask
  // passes through registers one slab ahead
  const bool a_async = std::is_same_v<MaskT, __nv_bfloat16> && mask_vec;
  const bool a_vec = std::is_same_v<MaskT, float> && mask_vec;
  const int64_t KT = (Tok + BK - 1) / BK;
  const int warpgroup = threadIdx.x / 128;

  // The ring: slab kt sits in slot kt % STAGES.  Iteration kt issues
  // slab kt's wgmma group, then refills the slot slab kt-2 used with slab
  // kt+2 (its group retired in this warpgroup at the end of iteration
  // kt-1 and in the other one before the barrier at the top of kt), then
  // retires slab kt-1's group, so one group runs while the next is issued
  // and one barrier an iteration suffices.
  constexpr int AHEAD = STAGES - 2;
  float staged[A_REGS];
  for (int s = 0; s < AHEAD; ++s) {
    if (s < KT) {
      if (a_async) {
        tile.load_a_async(s, s);
      } else {
        tile.load_a_regs(s, a_vec, staged);
        tile.store_a_regs(s, a_vec, staged);
      }
      tile.load_b(s, s, x_vec);
    }
    wg::cp_async_commit();
  }
  if (!a_async && AHEAD < KT) tile.load_a_regs(AHEAD, a_vec, staged);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

  for (int64_t kt = 0; kt < KT; ++kt) {
    const int s = static_cast<int>(kt % STAGES);
    wg::cp_async_wait<AHEAD - 1>();  // this thread's copies of slab kt
    __syncthreads();                 // everyone's, and their st.shared
    wg::fence_proxy_async();         // ... visible to the async proxy
    wg::fence_operands(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const uint64_t da = wg::desc_sw128(
          tile.a_slot(s) + warpgroup * ATOM_BYTES + k * K16_BYTES, ATOM_BYTES,
          wg::GROUP_BYTES);
      const uint64_t db = wg::desc_sw128(tile.b_slot(s) + k * K16_BYTES,
                                         ATOM_BYTES, wg::GROUP_BYTES);
      wg::mma_m64n256k16_bf16_mn(acc, da, db);  // breakdown: wgmma
    }
    wg::wgmma_commit();
    // breakdown: refill begin
    const int64_t nk = kt + AHEAD;
    if (nk < KT) {
      const int ns = static_cast<int>(nk % STAGES);
      if (a_async) {
        tile.load_a_async(ns, nk);
      } else {  // the registers hold slab nk, loaded one iteration ago
        tile.store_a_regs(ns, a_vec, staged);
        if (nk + 1 < KT) tile.load_a_regs(nk + 1, a_vec, staged);
      }
      tile.load_b(ns, nk, x_vec);
    }
    // breakdown: refill end
    wg::cp_async_commit();
    wg::wgmma_wait<1>();  // slab kt-1's group retires
    wg::fence_operands(acc);
  }
  wg::wgmma_wait<0>();
  wg::fence_operands(acc);

  // epilogue: the accumulator fragment straight to global memory, rounded
  // to bf16, masked at the C and D edges; pairs when D is even
  __nv_bfloat16* o = out + e * C * D;
  const int t = threadIdx.x % 128;
  const bool pairs = (D % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = tile.c0 + warpgroup * 64 + wg::frag_row(t, h);
    if (row >= C) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int64_t col = tile.d0 + wg::frag_col(t, i);
      const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if (pairs && col < D) {
        *reinterpret_cast<__nv_bfloat162*>(o + row * D + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < D) o[row * D + col] = __float2bfloat16(v0);
        if (col + 1 < D) o[row * D + col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <typename MaskT>
int launch(const void* mask, const void* x, void* out, int64_t Tok, int64_t E,
           int64_t C, int64_t D, cudaStream_t s) {
  // 16-byte loads where every row read starts on a 16-byte boundary: the
  // mask's rows (stride E·C) and stripes (offset e·C) when C is a multiple
  // of the vector, x's rows when D is a multiple of 8, and both bases
  constexpr int64_t mask_width = 16 / sizeof(MaskT);
  const int mask_vec = C % mask_width == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const int x_vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // per launch, so it holds on whichever device is current
  const cudaError_t attr = cudaFuncSetAttribute(
      dispatch_wgmma<MaskT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((D + BN - 1) / BN),
                  static_cast<unsigned>((C + BM - 1) / BM),
                  static_cast<unsigned>(E));
  dispatch_wgmma<MaskT><<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const MaskT*>(mask), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), Tok, E, C, D, mask_vec, x_vec);
  return launch_status();
}

}  // namespace tc

}  // namespace

extern "C" int repro_moe_dispatch(int mask_dtype, int dtype, const void* mask,
                                  const void* x, void* out, long long T,
                                  long long E, long long C, long long D,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && mask_dtype == kFloat32)
    return f32::launch<float>(mask, x, out, T, E, C, D, s);
  if (dtype == kFloat32 && mask_dtype == kBFloat16)
    return f32::launch<__nv_bfloat16>(mask, x, out, T, E, C, D, s);
  if (dtype == kBFloat16 && mask_dtype == kFloat32)
    return tc::launch<float>(mask, x, out, T, E, C, D, s);
  if (dtype == kBFloat16 && mask_dtype == kBFloat16)
    return tc::launch<__nv_bfloat16>(mask, x, out, T, E, C, D, s);
  return -1;
}
