// Helpers shared by the flash-attention kernels (flash_attn_fwd.cu and
// flash_attn_bwd.cu): the swizzled shared-memory layout of bf16 tiles, the
// ldmatrix reads of it, cp.async copies, the bf16 mma.sync product, the
// warpgroup products (wgmma) that read those tiles through descriptors, and
// the SFU's exp2.  Each source includes it inside its own anonymous
// namespace, after <cuda_bf16.h>, <cuda_runtime.h>, <stdint.h> and
// <string.h>.  The functions that are inline PTX sit under
// #ifndef CUDA_EMU_TENSOR_CORES: the CPU emulation (tools/cuda_emu/cuda_emu.h)
// defines it and supplies its own, so that flash_attn_bwd.cu runs there.
#pragma once

#ifndef CUDA_EMU_TENSOR_CORES
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; zeros if !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
// 4 bytes from global to shared memory, asynchronously; zero if !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU's ex2.approx.ftz, the instruction exp2f compiles to under
// fast math: one instruction; results below 2^-126 flush to 0, far below any
// weight a softmax row keeps.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 32 bits to shared memory at a shared-window address.
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// --- wgmma (sm_90a): a warpgroup of four warps issues one product of a
// 64-row tile, asynchronously; see the description before wgmma_desc.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of the warpgroup's committed groups are in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's generic-proxy writes of shared memory (cp.async,
// stores) before the async proxy's reads of it (wgmma's descriptors).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving an accumulator's reads or writes across
// this point: after wgmma_wait, before its registers are read.
template <int R> __device__ __forceinline__ void wgmma_hold(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

#define WG_ACC8(d)                                                                            \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
      "+f"(d[1][2]), "+f"(d[1][3])
#define WG_ACC32(d)                                                                           \
  WG_ACC8(d), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]),    \
      "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),            \
      "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]),            \
      "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),            \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define WG_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_REGS32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) = A B (+ d if scale_d), both operands bf16 in shared
// memory through descriptors, K-major: A (64 x 16), B (16 x 64).
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (64 x N, f32) += A B, A (64 x 16 bf16) from registers in the m16n8k16
// A-fragment layout of the thread's warp's 16 rows (rows 16 w + g and + 8 at
// columns 2 t, 2 t + 1, 2 t + 8, 2 t + 9), B (16 x N) MN-major in shared
// memory through a descriptor.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 16 || N == 64, "dK, dV and dQ at head_dim 16 and 64");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " WG_REGS8
        ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : WG_ACC8(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}
#undef WG_ACC8
#undef WG_ACC32
#undef WG_REGS8
#undef WG_REGS32
#endif  // CUDA_EMU_TENSOR_CORES

// Byte offset of 16-byte chunk c of `row` in a tile whose rows are W chunks.
// The chunk index is XORed with bits of the row so that the eight rows one
// ldmatrix reads at one chunk column fall in eight distinct 16-byte bank
// groups (W >= 8: row & 7; W = 2, hd 16, four rows share a 128-byte line).
// On a tile whose base is 1024-byte aligned these are the address bits that
// wgmma's swizzles XOR: at W = 8 (128-byte rows) its 128-byte swizzle,
// address bits 4-6 ^= bits 7-9; at W = 2 (32-byte rows) its 32-byte one,
// bit 4 ^= bit 7.
template <int W> __device__ __forceinline__ uint32_t swizzle(int row, int c) {
  static_assert(W == 2 || W % 8 == 0, "rows of 2 or a multiple of 8 chunks");
  const int x = W >= 8 ? (row & 7) : ((row >> 2) & 1);
  return (uint32_t)(row * W + (c ^ x)) * 16u;
}

// The wgmma descriptor of a swizzled tile of bf16 rows of W = 8 or 2
// chunks (head_dim 64 or 16) at shared address `addr` (1024-byte aligned,
// or a k-step into such a tile): bits 0-13 the address / 16, 16-29 the
// leading byte offset / 16, 32-45 the stride byte offset / 16, 62-63 the
// swizzle (1: 128 bytes, 3: 32 bytes).  Each tile is 64 rows of one
// sequence position each and head_dim columns; read
//   * K-major (the row's head_dim is the product's k dimension: the A tile
//     of S = Q K^T and the B tile, and dP's alike): eight rows make a
//     swizzle atom and the stride byte offset steps to the next eight
//     rows; the leading offset is not used, as a k-step (16 values, 32
//     bytes) lies within one row; the next k-step starts 32 bytes on;
//   * MN-major (the rows are the k dimension and head_dim the n dimension:
//     B of dV = P^T dO, dK = dS^T Q, dQ = dS K): one atom spans the whole
//     row (n = head_dim = 64 values in 128 bytes, or 16 in 32) and eight
//     rows of k; the stride byte offset steps to the next eight rows, the
//     leading offset (to the next atom along n) is not used; the next
//     k-step starts 16 rows on.
// Both offsets are set to the eight-row step, so the encoding reads the
// same under either field's use.
template <int W> __device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  static_assert(W == 8 || W == 2, "128- and 32-byte swizzled rows");
  constexpr uint64_t eight_rows = 8 * W * 16 / 16;
  constexpr uint64_t layout = W == 8 ? 1 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (eight_rows << 16) | (eight_rows << 32) |
         (layout << 62);
}

// Where one lane's ldmatrix reads fall in a swizzled tile.  Every read
// takes eight rows row0 + r8 (+ 8 for half the lanes) at chunk c0 (+ 1 for
// half the lanes), with row0 a multiple of 16 and c0 even; the row bits that
// the swizzle XORs are the lane's own, so a read's offset is one of four lane
// terms (by c0 % 8) plus a constant, and a thread keeps four registers for
// all its reads of one pattern rather than one per read.
template <int W> struct LaneReads {
  uint32_t off[4];
  __device__ __forceinline__ LaneReads(int r8, int row_bit, int chunk_bit) {
    const int x = W >= 8 ? r8 : ((r8 >> 2) & 1);
#pragma unroll
    for (int ph = 0; ph < 4; ++ph)
      off[ph] = (uint32_t)((r8 + 8 * row_bit) * W + ((2 * ph) ^ chunk_bit ^ x)) * 16u;
  }
  // = swizzle<W>(row0 + r8 + 8 row_bit, c0 + chunk_bit)
  __device__ __forceinline__ uint32_t at(int row0, int c0) const {
    return off[(c0 & 7) / 2] + (uint32_t)(row0 * W + (c0 & ~7)) * 16u;
  }
};

// Two f32 as one bf16x2 register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}
