// Hopper tensor-core building blocks: wgmma on bf16 operands, their
// descriptors and 128-byte-swizzled layouts (MN-major and K-major), the
// accumulator fragment and its reuse as a register A operand, and the
// cp.async and proxy fences that feed them.
//
// A warpgroup (128 threads, four warps) issues `wgmma.mma_async` for a
// 64-row tile; B is read from shared memory through a 64-bit descriptor,
// A from shared memory the same way or from registers, and the f32 sum
// stays in registers.
//
// MN-major operands (imm-trans = 1): A(m, k) contiguous along m, B(k, n)
// along n, which is how a column-major view such as the MoE mask stripe
// and a row-major right-hand side (x, or v in P·V) lie in memory, so a
// tile is staged without a transpose.
//
// Layout (SWIZZLE_128B, MN-major, 16-bit elements): a tile of `rows` K
// rows is cut into atoms 64 elements wide along MN.  Inside an atom each
// K row is 128 contiguous bytes; its eight 16-byte chunks are permuted by
// XOR with (k mod 8).  Atoms follow each other every rows·128 bytes.  In
// the descriptor the leading byte offset (LBO) is that MN-atom stride and
// the stride byte offset (SBO) the step between groups of 8 K rows (1024
// bytes).  Every atom base must be 1024-byte aligned, so the XOR the
// hardware applies to address bits [4,7) from bits [7,10) is (k mod 8).
//
// K-major operands (imm-trans = 0): A(m, k) and B(k, n) contiguous along
// k, as q and k rows are in Q·Kᵀ.  The bytes lie as above with the roles
// swapped: each M/N row is 128 contiguous bytes of 64 K values, chunks
// XOR-ed with (row mod 8), 64-wide K atoms every rows·128 bytes, so
// element (r, k) sits at sw128_offset(k, r, rows).  SBO is the step
// between groups of 8 rows (1024 bytes); LBO is not read for a swizzled
// K-major operand (one k16 step, 32 bytes, never leaves its atom).  The
// k16 step kk starts kmajor_k16(kk, rows) bytes in: inside the 128-byte
// row, which is right because the hardware swizzles the address it forms.
//
// A register operand (m64k16, bf16): thread t of warp w holds four 32-bit
// registers of two bf16 each: rows 16w + t/4 (registers 0 and 2) and +8
// (1 and 3), columns 2(t mod 4) + {0, 1} (registers 0 and 1) and +8 (2
// and 3), the low half the lower column.  That is the accumulator
// fragment's order (frag_row/frag_col): an m64nN accumulator's columns
// 16j..16j+15 are the A operand of the j-th k16 step as the pairs
// (d[8j + 2r], d[8j + 2r + 1]) for register r, rounded to bf16.
//
// Memory-model rules the callers keep:
//  * shared memory written by st.shared or cp.async is made visible to
//    wgmma with __syncthreads() then fence_proxy_async() before
//    wgmma_fence();
//  * a buffer read by a wgmma group may be overwritten only after
//    wgmma_wait<n>() has retired that group in every warpgroup that read
//    it (a barrier after the wait);
//  * accumulator and register-A operands are touched by ordinary code
//    only outside an open group (a register A operand also stays live
//    until wgmma_wait<n>() retires its group); fence_operands() on both
//    keeps the compiler from moving such accesses across the asynchronous
//    instructions or reusing the registers early.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace wg {

constexpr int GROUP_BYTES = 1024;  // 8 K rows of one MN atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (mn, k) of a 16-bit MN-major SWIZZLE_128B tile
// whose atoms hold `rows` K rows.
__device__ __forceinline__ uint32_t sw128_offset(int mn, int k, int rows) {
  return static_cast<uint32_t>((mn >> 6) * rows * 128 + k * 128 +
                               ((((mn & 63) >> 3) ^ (k & 7)) << 4) +
                               ((mn & 7) << 1));
}

// Shared-memory matrix descriptor: start address, LBO and SBO in 16-byte
// units, layout SWIZZLE_128B (1 in bits 62-63), base offset 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R, int C>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Byte offset of the k16 step kk in a K-major tile of `rows` rows.
__device__ __forceinline__ uint32_t kmajor_k16(int kk, int rows) {
  return static_cast<uint32_t>((kk >> 2) * rows * 128 + (kk & 3) * 32);
}

#define REPRO_WG_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d(64x256, f32) += A(64x16) · B(16x256), bf16 operands in shared memory,
// both MN-major.  Thread l of the warpgroup holds d[4i + 2h + j] =
// D(row(l, h), col(l, i) + j) (see frag_row/frag_col).
__device__ __forceinline__ void mma_m64n256k16_bf16_mn(float (&d)[128],
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24),
        REPRO_WG_D8(32), REPRO_WG_D8(40), REPRO_WG_D8(48), REPRO_WG_D8(56),
        REPRO_WG_D8(64), REPRO_WG_D8(72), REPRO_WG_D8(80), REPRO_WG_D8(88),
        REPRO_WG_D8(96), REPRO_WG_D8(104), REPRO_WG_D8(112),
        REPRO_WG_D8(120)
      : "l"(da), "l"(db), "r"(1));
}

// d(64xN, f32) = A(64x16)·B(16xN) (scale_d 0) or += it (scale_d 1), bf16
// operands in shared memory, both K-major.
template <int N>
__device__ void mma_ss_k(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);

// d(64xN, f32) += A(64x16)·B(16xN), A bf16 in registers (the layout
// above), B bf16 in shared memory, MN-major.
template <int N>
__device__ void mma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                          uint64_t db);

template <>
__device__ __forceinline__ void mma_ss_k<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss_k<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24),
        REPRO_WG_D8(32), REPRO_WG_D8(40), REPRO_WG_D8(48), REPRO_WG_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs_mn<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs_mn<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24),
        REPRO_WG_D8(32), REPRO_WG_D8(40), REPRO_WG_D8(48), REPRO_WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs_mn<192>(float (&d)[96],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24),
        REPRO_WG_D8(32), REPRO_WG_D8(40), REPRO_WG_D8(48), REPRO_WG_D8(56),
        REPRO_WG_D8(64), REPRO_WG_D8(72), REPRO_WG_D8(80), REPRO_WG_D8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs_mn<256>(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : REPRO_WG_D8(0), REPRO_WG_D8(8), REPRO_WG_D8(16), REPRO_WG_D8(24),
        REPRO_WG_D8(32), REPRO_WG_D8(40), REPRO_WG_D8(48), REPRO_WG_D8(56),
        REPRO_WG_D8(64), REPRO_WG_D8(72), REPRO_WG_D8(80), REPRO_WG_D8(88),
        REPRO_WG_D8(96), REPRO_WG_D8(104), REPRO_WG_D8(112),
        REPRO_WG_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef REPRO_WG_D8

// Accumulator fragment of an m64nN f32 tile: thread t (0..127 in its
// warpgroup) holds rows frag_row(t, 0) and frag_row(t, 1) = +8, and in
// each 8-wide column block i the columns frag_col(t, i) and +1.
__device__ __forceinline__ int frag_row(int t, int h) {
  return (t >> 5) * 16 + ((t & 31) >> 2) + h * 8;
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return i * 8 + (t & 3) * 2;
}

// 16-byte global -> shared copy; with `pred` false it writes 16 zero bytes
// and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace wg
