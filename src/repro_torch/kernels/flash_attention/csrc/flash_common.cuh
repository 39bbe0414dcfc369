// Helpers shared by the flash-attention kernels (flash_attn_fwd.cu and
// flash_attn_bwd.cu): the swizzled shared-memory layout of bf16 tiles, the
// ldmatrix reads of it, cp.async copies, the bf16 mma.sync product and the
// SFU's exp2.  Each source includes it inside its own anonymous namespace,
// after <cuda_bf16.h>, <cuda_runtime.h>, <stdint.h> and <string.h>.
#pragma once

// Byte offset of 16-byte chunk c of `row` in a tile whose rows are W chunks.
// The chunk index is XORed with bits of the row so that the eight rows one
// ldmatrix reads at one chunk column fall in eight distinct 16-byte bank
// groups (W >= 8: row & 7; W = 2, hd 16, four rows share a 128-byte line).
template <int W> __device__ __forceinline__ uint32_t swizzle(int row, int c) {
  static_assert(W == 2 || W % 8 == 0, "rows of 2 or a multiple of 8 chunks");
  const int x = W >= 8 ? (row & 7) : ((row >> 2) & 1);
  return (uint32_t)(row * W + (c ^ x)) * 16u;
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

// Two f32 as one bf16x2 register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}
