// FlashAttention-2 forward: out = softmax(q kᵀ / sqrt(D) + mask) v over
// the (B, S, H, D) layout, online softmax, f32 scores and statistics.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_single
// -> _flash_kernel (the Pallas kernel with a VMEM-resident q tile, a kv
// grid dimension swept in order, and running max / denominator /
// accumulator in VMEM scratch), which ops.flash_attention vmaps over batch
// and heads.
//
// What bounds it on an H100: operations.  It does 4·D flops for every
// (query, key) pair the mask keeps against 4·B·S·H·D·bytes of q, k, v and
// out, so at a model's head width and sequence length (D=128, S=4096) the
// products, not the reads, are the floor: 67 TFLOP/s in f32, 989 in bf16
// on the tensor cores.
//
// Every form keeps the reference's function: scores in f32 scaled by
// 1/sqrt(D); masked scores never win and weigh an exact 0 (a padded key
// past Skv included); the causal mask keeps key index <= query index, both
// from 0 (top-left aligned, also when Sq != Skv); the running max m,
// denominator l and accumulator stay f32; p is rounded to v's type before
// the PV product while l sums the unrounded p; the output is the
// accumulator over max(l, 1e-30), cast to q's type.  One block per (b·h,
// query tile), all B·H heads in one launch, reading q, k, v and writing
// out through the (B, S, H, D) strides (no transposed copy; 64-bit
// offsets); under the causal mask the key tiles wholly past a query tile
// are never read, and the heaviest query tiles are launched first.
//
// bf16 at every D from 1 to 256: wgmma on the tensor cores (wgmma.cuh),
// compiled for padded widths DP = 64, 128, 192 and 256; a D between runs
// at the next one up, D a run-time value.  A full-width head at DP = 64
// or 128 runs a second copy with D fixed at compile time, as fast as the
// forms compiled for those widths alone, where the run-time copy is 38 %
// and 5 % slower (PERF.md §6).  A block of two warpgroups takes 128
// queries, 64 a warpgroup.  The q tile is loaded once; tiles of BK keys
// of k and v stream through a ring of slots filled with 16-byte cp.async,
// one barrier a tile: 64 keys in 3 slots at DP = 64 and 192, 128 keys in
// 3 slots at 128, 64 keys in 2 slots at 256.  Per key tile each
// warpgroup runs S = Q·Kᵀ (m64nBKk16, DP/16 steps, both operands from
// shared memory), the online softmax on the S fragment in registers, and
// O += P·V (m64nDPk16, BK/16 steps, P from registers).
// What the design does about each hazard:
//  1. K-major operands: q and k rows are contiguous along d, the
//     contraction of Q·Kᵀ, so both are staged K-major (wgmma.cuh's
//     128-byte swizzle with 64 d values a row, imm-trans 0, SBO 1024
//     bytes, k16 steps 32 bytes apart inside an atom, each further
//     64-wide d atom rows·128 bytes on).  v is contiguous along d, the N
//     of P·V: MN-major, read transposed (imm-trans-b 1), LBO the d-atom
//     stride, BK·128 bytes, for 1 to 4 atoms.
//  2. Instruction shapes: m64nBKk16 with both operands in shared memory
//     for S, m64nDPk16 with A from registers for O (N = 64 to 256).
//  3. P as an A operand: the S accumulator's columns 16j..16j+15 are the
//     j-th k16 step's A fragment, packed pairwise (d[8j + 2r],
//     d[8j + 2r + 1]) into register r after rounding to bf16; P never
//     goes through shared memory.
//  4. The async proxy and register fences: every tile is written by
//     cp.async or st.shared, then __syncthreads() and fence.proxy.async
//     precede its wgmma; the S, O and P registers are fenced around each
//     group and P stays live until its group retires.
//  5. Ragged edges: keys past Skv, queries past Sq and d columns past D
//     are zero-filled in the loads (cp.async with source size 0), so a
//     padded column adds exact zeros to q·k; masked scores become -inf,
//     so their p is exactly 0 even in a row whose whole tile is masked,
//     and the running max stays finite (it starts at -1e30).  Rows past
//     Sq and columns past D are computed but not stored.  Only the tiles
//     on the causal diagonal and past Skv are masked.
//  6. Alignment: a row starts on the 16-byte grid wherever its base does
//     only when D % 8 == 0 (rows are H·D·2 bytes apart, heads D·2), so
//     the launch takes 16-byte loads for an operand whose base is aligned
//     and whose D is a multiple of 8, else 2-byte loads and 16-byte
//     stores; the output is stored in bf16 pairs when D is even, else
//     value by value.
//  7. Shared memory and registers: q takes 256·DP bytes and a slot of k
//     and v 4·BK·DP, 66 KB a block at DP = 64, 225 KB at 128, 193 KB at
//     192 and at 256 (three slots of 64 keys would take 257 KB there, and
//     BK = 128 at 192 240 KB in two slots), under the 227 KB a block may
//     take (a static_assert); every launch raises the function's dynamic
//     limit and a refused launch returns its status.  A thread holds BK/2
//     S, DP/2 O and BK/4 P registers (32 + 128 + 16 at DP = 256); one
//     block of 256 threads an SM leaves 255 a thread (ptxas reports
//     spills).
//  8. The query tile: 128 rows, as in the tiled form.
// Left out on purpose: TMA, warp specialisation and setmaxnreg, clusters,
// a persistent scheduler, and overlapping one tile's softmax with the
// next tile's products inside a warpgroup.
//
// f32 at every D from 1 to 256: register-tiled FMA (the reference product
// is full f32, so no TF32), compiled for the padded widths DP = 64, 128,
// 192 and 256, as the wgmma form; a D between runs at the next one up, D
// a run-time value, and a full-width head at DP = 64, 128 or 192 runs a
// copy with D fixed at compile time (at 192 it measured 6 % faster, at
// 256 no faster than the run-time copy: PERF.md §6).  A block of 256 threads
// takes 128 queries; tiles of BK keys (128 at DP = 64, 64 at 128, 48 at
// 192, 32 at 256) stream through shared memory.  Thread (ty, tx) =
// (tid / 16, tid % 16) owns 8 queries, 64·(i/4) + 4·ty + i%4, for the
// whole kernel: their 8 x BK/16 scores against keys 16·j + tx of a tile,
// their running max and sums, and their 8 x DP/16 block of the output at
// columns 64·g + 4·tx + 0..3.  What the design does about each hazard:
//  1. Score reads: q and k are staged as they lie (rows along d), each
//     row padded by 4 floats, so a thread reads its 8 queries and BK/16
//     keys as float4 along d: 8 + BK/16 vector loads for 32·BK/16 FMAs.
//     A warp's 16 k reads, rows DP + 4 floats apart, are two conflict-free
//     wavefronts; its q reads are two addresses in different banks.  (A
//     d-major copy would need a transpose through registers for the same
//     vector width.)
//  2. PV reads: p is stored key by key (ps[key][query], rows padded by 4
//     floats), so a thread's 8 queries of one key are two float4, and v
//     rows are read as float4 at 4·tx: 2 + DP/64 vector loads for 8·DP/16
//     FMAs a key.
//  3. Loads under the FMAs: q once, then k and v by 16-byte cp.async, one
//     buffer each, alternating: v of tile kt is copied while the scores
//     of tile kt are computed, k of tile kt+1 while the PV product of
//     tile kt runs; two barriers a tile (the scores' k; the product's p
//     and v).  Rows are H·D·4 bytes apart and heads D·4, so an operand
//     takes 16-byte copies when its base is on the 16-byte grid and D %
//     4 == 0, else value-by-value loads and a 16-byte store; the output
//     is stored as float4 under the same rule, else value by value.
//  4. A run-time D: columns past D are zero-filled in q, k and v (a
//     cp.async of source size 0), so they add exact zeros to q·k; the
//     score loop stops at D rounded up to 4 (at DP = 256 it runs to 256,
//     which keeps the run-time copy within the registers); output columns
//     past D are computed but never stored.  D between 128 and 192, or
//     past 192, needs every 64-wide column group, so no group is
//     skipped.
//  5. Shared memory: q 128 x (DP + 4), k BK x (DP + 4), v BK x DP and p BK
//     x 132 floats: 169 KB at DP = 64, 167 KB at 128, 196 KB at 192 and
//     211 KB at 256 (48 keys would take 252 KB there), under the 227 KB a
//     block may take (a static_assert); one block an SM, so every launch
//     raises the function's dynamic limit.
//  6. Registers: 8·BK/16 scores, 8·DP/16 sums and 16 running statistics a
//     thread, 64 + 32 at DP = 64, 32 + 64 at 128, 24 + 96 at 192 and 16 +
//     128 at 256; one block of 256 threads an SM leaves 255 a thread
//     (ptxas reports spills).
//  7. The softmax: in base 2 (scores times scale·log2 e, ex2.approx, as
//     the wgmma form), the row max through a 16-lane shuffle each tile;
//     each thread keeps its own share of the row sum, added over the 16
//     lanes once at the end.  Only tiles on the causal diagonal and past
//     Skv are masked.
//  8. The query tile: 128 rows, as in the wgmma form; the wrapper counts
//     the grid with the form's own tile.
// Each score and each output is one fmaf chain in d and key order.  The
// key tile per width, the loops' unrolling and the fixed-D copies are the
// fastest of those timed on the card (repro_torch.bench.flash_tiles at
// DP = 192 and 256) that ptxas compiles without spilling.
#include <math_constants.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16;  // threads along keys (scores) and d (output)
constexpr int MAX_D = 256;
constexpr int SMEM_LIMIT = 232448;  // the most a block may take, 227 KB
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x; exactly 0 at -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

namespace tiled {

constexpr int BQ = 128;  // queries a block
constexpr int PP = BQ + 4;  // a row of ps: one key's p for every query

template <int DP>
struct Shape {
  static_assert(DP == 64 || DP == 128 || DP == 192 || DP == 256,
                "the tiled form takes DP = 64, 128, 192 or 256");
  // keys a tile; the unrolling of the score loop's 4-wide d steps, of
  // the PV loop's keys and of a tile load's chunks; whether a run-time D
  // scores all DP columns (repro_torch.bench.flash_tiles times others)
  static constexpr int BK = DP == 64 ? 128 : DP == 128 ? 64 : DP == 192 ? 48 : 32;
  static constexpr int D_UNROLL = DP == 256 ? 2 : DP == 64 ? 2 : 4;
  static constexpr int PV_UNROLL = DP == 256 ? 4 : 16;
  static constexpr int LOAD_UNROLL = DP == 256 ? 1 : 64;
  static constexpr int SCORE_DP = DP == 256 ? 1 : 0;
  static constexpr int KJ = BK / TX;  // keys of a tile a thread scores
  static constexpr int RP = DP + 4;   // a row of qs or ks, padded
  static constexpr int DJ = DP / TX;  // output columns a thread
  static constexpr int Q_FLOATS = BQ * RP;
  static constexpr int K_FLOATS = BK * RP;
  static constexpr int V_FLOATS = BK * DP;
  static constexpr int P_FLOATS = BK * PP;
  static constexpr int SMEM_BYTES =
      4 * (Q_FLOATS + K_FLOATS + V_FLOATS + P_FLOATS);
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "past the shared memory a block "
                                          "may take");
};

// ROWS rows of D floats (row r at src + (r0 + r)·stride) -> dst, rows
// `pitch` floats apart, DP columns, zero past row n and past column D:
// 16-byte cp.async when every row starts on the 16-byte grid (vec), else
// 4-byte loads and a 16-byte store.  Neighbouring threads take
// neighbouring 16-byte chunks of a row.
template <int ROWS, int DP, bool FIXED_D, int UNROLL>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* src, int64_t stride,
                                          int64_t r0, int64_t n, int D,
                                          bool vec, int tid) {
  constexpr int CPR = DP / 4;  // 16-byte chunks a row
  static_assert(ROWS * CPR % THREADS == 0, "tile shape");
#pragma unroll UNROLL
  for (int j = 0; j < ROWS * CPR / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool in_row = r0 + r < n;
    const bool in_col = FIXED_D || c < D;
    const float* p = src + (in_row ? r0 + r : 0) * stride + (in_col ? c : 0);
    float* d = dst + r * pitch + c;
    if (vec) {  // D % 4 == 0: a chunk lies wholly inside D or past it
      wg::cp_async16(wg::smem_u32(d), p, in_row && in_col);
    } else {
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in_row && in_col) {
        w.x = p[0];
        if (FIXED_D || c + 1 < D) w.y = p[1];
        if (FIXED_D || c + 2 < D) w.z = p[2];
        if (FIXED_D || c + 3 < D) w.w = p[3];
      }
      *reinterpret_cast<float4*>(d) = w;
    }
  }
}

// FIXED_D: the head width is DP, known at compile time; else it is d,
// from 1 to DP, given at run time
template <int DP, bool FIXED_D>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int64_t Sq,
          int64_t Skv, int64_t H, int d, float scale_log2, int causal,
          int q_vec, int k_vec, int v_vec, int o_vec) {
  const int D = FIXED_D ? DP : d;
  using S = Shape<DP>;
  constexpr int BK = S::BK;
  constexpr int KJ = S::KJ;
  constexpr int D_UNROLL = S::D_UNROLL;
  constexpr int PV_UNROLL = S::PV_UNROLL;
  constexpr int RP = S::RP;
  constexpr int DJ = S::DJ;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;              // [BQ][RP]
  float* const ks = qs + S::Q_FLOATS;  // [BK][RP]
  float* const vs = ks + S::K_FLOATS;  // [BK][DP]
  float* const ps = vs + S::V_FLOATS;  // [BK][PP]

  const int tid = threadIdx.x;
  const int tx = tid % TX;  // keys of the scores, columns of the output
  const int ty = tid / TX;  // the query group
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t row = H * D;  // stride between sequence positions
  const float* qb = q + (b * Sq * H + h) * D;
  const float* kb = k + (b * Skv * H + h) * D;
  const float* vb = v + (b * Skv * H + h) * D;
  float* ob = out + (b * Sq * H + h) * D;
  // d columns that can be nonzero: the score loop's end
  const int DL = FIXED_D || S::SCORE_DP ? DP : (D + 3) & ~3;

  // under the causal mask, key tiles starting past the block's last query
  // are wholly masked
  const int64_t kv_end = causal ? (Skv < q0 + BQ ? Skv : q0 + BQ) : Skv;
  const int KT = static_cast<int>((kv_end + BK - 1) / BK);

  constexpr int LU = S::LOAD_UNROLL;
  load_rows<BQ, DP, FIXED_D, LU>(qs, RP, qb, row, q0, Sq, D, q_vec, tid);
  load_rows<BK, DP, FIXED_D, LU>(ks, RP, kb, row, 0, Skv, D, k_vec, tid);
  wg::cp_async_commit();

  // this thread's query i is row 64·(i/4) + 4·ty + i%4 of the block; m
  // is in log2 units (scores times scale·log2 e)
  const float* qr = qs + (4 * ty) * RP;
  float m[8], l[8], o[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DJ; ++c) o[i][c] = 0.0f;
  }

  for (int kt = 0; kt < KT; ++kt) {
    const int64_t k0 = int64_t{kt} * BK;
    wg::cp_async_wait<0>();  // this thread's copies of k tile kt (and q)
    __syncthreads();  // everyone's, and the last tile's PV reads are done
    load_rows<BK, DP, FIXED_D, LU>(vs, DP, vb, row, k0, Skv, D, v_vec, tid);
    wg::cp_async_commit();

    // S = Q·Kᵀ for keys 16·j + tx, d in order
    float sc[8][KJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) sc[i][j] = 0.0f;
#pragma unroll D_UNROLL
    for (int dd = 0; dd < DL; dd += 4) {
      float4 kv[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (16 * j + tx) * RP + dd);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qr + ((i / 4) * 64 + i % 4) * RP + dd);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          float a = sc[i][j];
          a = fmaf(qv.x, kv[j].x, a);
          a = fmaf(qv.y, kv[j].y, a);
          a = fmaf(qv.z, kv[j].z, a);
          sc[i][j] = fmaf(qv.w, kv[j].w, a);
        }
      }
    }

    // online softmax; masked scores never win and weigh an exact 0
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t qi = q0 + (i / 4) * 64 + 4 * ty + i % 4;
      bool ok[KJ];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int64_t kj = k0 + 16 * j + tx;
        ok[j] = !edge || (kj < Skv && (!causal || kj <= qi));
        sc[i][j] = ok[j] ? sc[i][j] * scale_log2 : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = ex2(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        sc[i][j] = ok[j] ? ex2(sc[i][j] - m_new) : 0.0f;
        sum += sc[i][j];
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DJ; ++c) o[i][c] *= corr;
    }
    // p by key: this thread's 4 consecutive queries of a key are a float4
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        *reinterpret_cast<float4*>(ps + (16 * j + tx) * PP + g * 64 + 4 * ty) =
            make_float4(sc[4 * g][j], sc[4 * g + 1][j], sc[4 * g + 2][j],
                        sc[4 * g + 3][j]);

    wg::cp_async_wait<0>();  // this thread's copies of v tile kt
    __syncthreads();  // everyone's, every p, and the score reads of k
    if (kt + 1 < KT)
      load_rows<BK, DP, FIXED_D, LU>(ks, RP, kb, row, k0 + BK, Skv, D, k_vec,
                                     tid);
    wg::cp_async_commit();

    // O += P·V, keys in order
#pragma unroll PV_UNROLL
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(ps + kk * PP + 4 * ty);
      const float4 p1 =
          *reinterpret_cast<const float4*>(ps + kk * PP + 64 + 4 * ty);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int g = 0; g < DJ / 4; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + kk * DP + g * 64 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[i][4 * g] = fmaf(pv[i], vv.x, o[i][4 * g]);
          o[i][4 * g + 1] = fmaf(pv[i], vv.y, o[i][4 * g + 1]);
          o[i][4 * g + 2] = fmaf(pv[i], vv.z, o[i][4 * g + 2]);
          o[i][4 * g + 3] = fmaf(pv[i], vv.w, o[i][4 * g + 3]);
        }
      }
    }
  }

  // epilogue: the row sums over the 16 lanes, then O / max(l, 1e-30);
  // rows past Sq and columns past D dropped
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float inv_l = 1.0f / fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int64_t qi = q0 + (i / 4) * 64 + 4 * ty + i % 4;
    if (qi >= Sq) continue;
#pragma unroll
    for (int g = 0; g < DJ / 4; ++g) {
      const int c = g * 64 + 4 * tx;
      float* p = ob + qi * row + c;
      const float r[4] = {o[i][4 * g] * inv_l, o[i][4 * g + 1] * inv_l,
                          o[i][4 * g + 2] * inv_l, o[i][4 * g + 3] * inv_l};
      if (o_vec) {  // D % 4 == 0: the chunk lies wholly inside D or past it
        if (FIXED_D || c < D)
          *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (FIXED_D || c + e < D) p[e] = r[e];
      }
    }
  }
}

// D from 1 to DP: the padded width DP is the dispatch's
template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t Sq, int64_t Skv, int64_t H, int D, float scale,
           bool causal, cudaStream_t s) {
  // rows are H·D·4 bytes apart and heads D·4, so every row lies on the
  // 16-byte grid when the base does and D % 4 == 0
  const auto aligned = [D](const void* p) {
    return static_cast<int>(D % 4 == 0 &&
                            reinterpret_cast<uintptr_t>(p) % 16 == 0);
  };
  // D fixed at compile time at DP = 64, 128 and 192 (the header)
  auto kernel = flash_f32<DP, false>;
  if constexpr (DP <= 192)
    if (D == DP) kernel = flash_f32<DP, true>;
  // per launch, so it holds on whichever device is current
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Shape<DP>::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  kernel<<<grid, THREADS, Shape<DP>::SMEM_BYTES, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, D,
      scale * LOG2E, causal, aligned(q), aligned(k), aligned(v),
      aligned(out));
  return launch_status();
}

}  // namespace tiled

namespace tc {

constexpr int BQ = 128;  // queries a block: two warpgroups of 64

// Tiles by padded head width DP, the fastest of those timed on the card
// that fit (PERF.md §6): 64 keys a tile at DP = 64 and 192, 128 at 128, in
// a ring of 3 slots, and 64 keys in 2 slots at 256; one block an SM (two
// blocks of the DP = 64 form an SM were no faster).
template <int DP>
struct Shape {
  static_assert(DP == 64 || DP == 128 || DP == 192 || DP == 256,
                "the wgmma form takes DP = 64, 128, 192 or 256");
  static constexpr int BK = DP == 128 ? 128 : 64;  // keys a tile
  static constexpr int STAGES = DP == 256 ? 2 : 3;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // one of k, v
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // k then v
  static constexpr int SMEM_BYTES = Q_BYTES + STAGES * STAGE_BYTES + 1024;
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "past the shared memory a block "
                                          "may take");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ROWS rows of D bf16 (row r at src + (r0 + r)·stride) -> a 128-byte-
// swizzled tile DP wide at smem (shared-window address) / smem_p
// (generic), zero past row n and past column D.  16-byte cp.async when
// every row starts on the 16-byte grid (vec), else 2-byte loads and
// 16-byte stores.  Neighbouring threads take neighbouring 16-byte chunks
// of a row.
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows(uint32_t smem, uint8_t* smem_p,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int64_t r0,
                                          int64_t n, int D, bool vec,
                                          int tid) {
  constexpr int CPR = DP / 8;  // 16-byte chunks a row
  static_assert(ROWS * CPR % THREADS == 0, "tile shape");
#pragma unroll
  for (int j = 0; j < ROWS * CPR / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool in_row = r0 + r < n;
    const bool in = in_row && c < D;
    const __nv_bfloat16* p =
        src + (in_row ? r0 + r : 0) * stride + (c < D ? c : 0);
    const uint32_t off = wg::sw128_offset(c, r, ROWS);
    if (vec) {
      wg::cp_async16(smem + off, p, in);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (in) {
        const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c + e < D)
            w[e / 2] |= static_cast<uint32_t>(h[e]) << (16 * (e % 2));
      }
      *reinterpret_cast<uint4*>(smem_p + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// FIXED_D: the head width is DP, known at compile time; else it is d,
// from 1 to DP, given at run time
template <int DP, bool FIXED_D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            __nv_bfloat16* __restrict__ out, int64_t Sq, int64_t Skv,
            int64_t H, int d, float scale_log2, int causal, int q_vec,
            int k_vec, int v_vec, int o_pair) {
  const int D = FIXED_D ? DP : d;
  using S = Shape<DP>;
  constexpr int BK = S::BK;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023u) & ~1023u;  // every atom 1024-aligned
  uint8_t* const qs_p = smem_raw + (qs - raw);
  const uint32_t ring = qs + S::Q_BYTES;
  uint8_t* const ring_p = qs_p + S::Q_BYTES;

  const int tid = threadIdx.x;
  const int warpgroup = tid / 128;
  const int t = tid % 128;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * BQ;
  const int64_t wq0 = q0 + warpgroup * 64;  // this warpgroup's first query
  const int64_t row = H * D;  // stride between sequence positions
  const __nv_bfloat16* qb = q + (b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + (b * Skv * H + h) * D;
  const __nv_bfloat16* vb = v + (b * Skv * H + h) * D;
  __nv_bfloat16* ob = out + (b * Sq * H + h) * D;

  // under the causal mask, key tiles starting past the block's last query
  // are wholly masked
  const int64_t kv_end = causal ? (Skv < q0 + BQ ? Skv : q0 + BQ) : Skv;
  const int KT = static_cast<int>((kv_end + BK - 1) / BK);

  auto load_kv = [&](int kt) {
    const int s = kt % STAGES;
    const uint32_t ks = ring + s * S::STAGE_BYTES;
    uint8_t* const ks_p = ring_p + s * S::STAGE_BYTES;
    load_rows<BK, DP>(ks, ks_p, kb, row, int64_t{kt} * BK, Skv, D, k_vec,
                      tid);
    load_rows<BK, DP>(ks + S::KV_BYTES, ks_p + S::KV_BYTES, vb, row,
                      int64_t{kt} * BK, Skv, D, v_vec, tid);
  };

  // the ring: tile kt sits in slot kt % STAGES; the q tile rides in the
  // first group
  load_rows<BQ, DP>(qs, qs_p, qb, row, q0, Sq, D, q_vec, tid);
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < KT) load_kv(kt);
    wg::cp_async_commit();
  }

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {-1e30f, -1e30f};  // running max, in log2 units
  float l[2] = {0.0f, 0.0f};      // this thread's share of the row sums

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    wg::cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt
    __syncthreads();  // everyone's, and both warpgroups are done with kt-1
    wg::fence_proxy_async();
    // refill the slot tile kt-1 used
    if (kt + STAGES - 1 < KT) load_kv(kt + STAGES - 1);
    wg::cp_async_commit();

    const uint32_t ks = ring + s * S::STAGE_BYTES;
    const uint32_t vs = ks + S::KV_BYTES;

    // S = Q·Kᵀ: raw dot products, 64 x BK for this warpgroup
    float sc[BK / 2];
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = wg::desc_sw128(
          qs + warpgroup * 64 * 128 + wg::kmajor_k16(kk, BQ), 16,
          wg::GROUP_BYTES);
      const uint64_t db =
          wg::desc_sw128(ks + wg::kmajor_k16(kk, BK), 16, wg::GROUP_BYTES);
      wg::mma_ss_k<BK>(sc, da, db, kk > 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_operands(sc);

    // mask: only the tile past Skv and the tiles on the causal diagonal
    const int64_t k0 = int64_t{kt} * BK;
    if (k0 + BK > Skv || (causal && k0 + BK - 1 > wq0)) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t qi = wq0 + wg::frag_row(t, hh);
        const int64_t lim = causal ? (qi + 1 < Skv ? qi + 1 : Skv) : Skv;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (k0 + wg::frag_col(t, i) + j >= lim)
              sc[4 * i + 2 * hh + j] = -CUDART_INF_F;
      }
    }

    // online softmax on the fragment: a row lies in the 4 threads of a quad
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
        mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * hh], sc[4 * i + 2 * hh + 1]));
      // scale > 0, so the max of the scaled scores is the scaled max; a
      // wholly masked row keeps its finite m
      const float m_new = fmaxf(m[hh], quad_max(mx) * scale_log2);
      const float corr = ex2(m[hh] - m_new);
      m[hh] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& e = sc[4 * i + 2 * hh + j];
          e = ex2(fmaf(e, scale_log2, -m_new));  // -inf -> exactly 0
          sum += e;
        }
      }
      l[hh] = l[hh] * corr + sum;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i + 2 * hh] *= corr;
        o[4 * i + 2 * hh + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);

    // O += P·V
    wg::fence_operands(o);
    wg::fence_operands(pa);
    wg::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint64_t db = wg::desc_sw128(vs + j * 16 * 128, BK * 128,
                                         wg::GROUP_BYTES);
      wg::mma_rs_mn<DP>(o, pa[j], db);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_operands(o);
    wg::fence_operands(pa);
  }

  // epilogue: the row sums over the quad, then O / max(l, 1e-30) straight
  // from the fragment, bf16 pairs (value by value where o_pair is 0),
  // rows past Sq and columns past D dropped
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lsum = l[hh];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const float inv_l = 1.0f / fmaxf(lsum, 1e-30f);
    const int64_t qi = wq0 + wg::frag_row(t, hh);
    if (qi >= Sq) continue;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = wg::frag_col(t, i);
      const float x0 = o[4 * i + 2 * hh] * inv_l;
      const float x1 = o[4 * i + 2 * hh + 1] * inv_l;
      __nv_bfloat16* const p = ob + qi * row + c;
      if (o_pair && c + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < D) p[0] = __float2bfloat16_rn(x0);
        if (c + 1 < D) p[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// D from 1 to DP: the padded width DP is the dispatch's
template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t Sq, int64_t Skv, int64_t H, int D, float scale,
           bool causal, cudaStream_t s) {
  // rows are H·D·2 bytes apart and heads D·2, so every row lies on the
  // 16-byte grid when the base does and D % 8 == 0; bf16 pairs need an
  // even D, as out is the wrapper's fresh tensor, whose base the caching
  // allocator puts on its 512-byte grid
  const auto aligned = [D](const void* p) {
    return static_cast<int>(D % 8 == 0 &&
                            reinterpret_cast<uintptr_t>(p) % 16 == 0);
  };
  const int o_pair = D % 2 == 0;
  // D fixed at compile time only at DP = 64 and 128, where it measured
  // faster (the header)
  auto kernel = flash_wgmma<DP, false>;
  if constexpr (DP <= 128)
    if (D == DP) kernel = flash_wgmma<DP, true>;
  // per launch, so it holds on whichever device is current
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Shape<DP>::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  kernel<<<grid, THREADS, Shape<DP>::SMEM_BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, H, D, scale * LOG2E, causal, aligned(q), aligned(k),
      aligned(v), o_pair);
  return launch_status();
}

}  // namespace tc

// every D from 1 to 256 at the next padded width up, in either type, as
// the wrapper's flash_attention.padded_width
int dispatch_f32(const void* q, const void* k, const void* v, void* out,
                 int64_t B, int64_t Sq, int64_t Skv, int64_t H, int D,
                 float scale, bool causal, cudaStream_t s) {
  if (D <= 64) return tiled::launch<64>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
  if (D <= 128) return tiled::launch<128>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
  if (D <= 192) return tiled::launch<192>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
  return tiled::launch<256>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out,
                  int64_t B, int64_t Sq, int64_t Skv, int64_t H, int D,
                  float scale, bool causal, cudaStream_t s) {
  if (D <= 64) return tc::launch<64>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
  if (D <= 128) return tc::launch<128>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
  if (D <= 192) return tc::launch<192>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
  return tc::launch<256>(q, k, v, out, B, Sq, Skv, H, D, scale, causal, s);
}

}  // namespace

extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, long long B,
                                     long long Sq, long long Skv, long long H,
                                     int D, float scale, int causal,
                                     void* stream) {
  if (D < 1 || D > MAX_D) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_f32(q, k, v, out, B, Sq, Skv, H, D, scale, causal != 0, s);
    case kBFloat16:
      return dispatch_bf16(q, k, v, out, B, Sq, Skv, H, D, scale, causal != 0, s);
    default:
      return -1;
  }
}
