// Helpers shared by the SSD's tensor-core kernels (ssd_bf16.cu and
// ssd_bwd_tc.cu): the swizzled shared-memory layout of bf16 tiles and the
// ldmatrix reads of it, cp.async copies, the bf16 mma.sync product and the
// hi + lo bf16 split of an f32 operand.  Each source includes it inside its
// own anonymous namespace, after <cuda_bf16.h>, <cuda_runtime.h>, <stdint.h>
// and <string.h>.  The functions that are inline PTX sit under
// #ifndef CUDA_EMU_TENSOR_CORES: the CPU emulation (tools/cuda_emu/cuda_emu.h)
// defines it and supplies its own, so that a kernel built on these runs
// there (ssd_bwd_tc.cu; ssd_bf16.cu has PTX of its own and stays outside).
#pragma once

#ifndef CUDA_EMU_TENSOR_CORES
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros if !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Waits until at most N of this thread's committed groups are in flight.
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
#endif  // CUDA_EMU_TENSOR_CORES

// Byte offset of 16-byte chunk c of `row` in a tile whose rows are W chunks.
// The chunk index is XORed with bits of the row so that the eight rows one
// ldmatrix reads at one chunk column fall in eight distinct 16-byte bank
// groups; the bits XORed are those of row % 8, so a tile may start at any
// row that is a multiple of 8.  Rows of 4 chunks (P or N 32) and of 2 are
// taken too.
template <int W> __device__ __forceinline__ uint32_t swizzle(int row, int c) {
  static_assert(W == 2 || W == 4 || W % 8 == 0, "rows of 2, 4 or a multiple of 8 chunks");
  const int x = W >= 8 ? (row & 7) : W == 4 ? ((row >> 1) & 3) : ((row >> 2) & 1);
  return (uint32_t)(row * W + (c ^ x)) * 16u;
}

// Fragment layouts of m16n8k16 (lane = 4 g + t): the A fragment holds rows g
// and g + 8 at columns 2t, 2t + 1 (regs 0, 1) and 2t + 8, 2t + 9 (regs 2,
// 3); the B fragment rows (k) 2t, 2t + 1 and 2t + 8, 2t + 9 at column g; the
// f32 accumulator rows g (elements 0, 1) and g + 8 (2, 3) at columns 2t, 2t + 1.
// So the accumulators of two neighbouring 8-column tiles are, element for
// element, the A fragment of their 16 columns.
// ldmatrix: lane l gives the address of row l % 8 of matrix l / 8.  Two read
// patterns: "row pairs" (matrix m at row + 8 (m & 1), chunk + (m >> 1)) reads
// an A operand stored [m][k], or by .trans a B operand stored [k][n] (regs
// 0, 1 the n-tile of chunk c0, regs 2, 3 that of c0 + 1); "chunk pairs"
// (matrix m at row + 8 (m >> 1), chunk + (m & 1)) reads a B operand stored
// [n][k] (regs 0, 1 the n-tile of rows row0.., regs 2, 3 of rows row0 + 8..),
// or by .trans an A operand stored [k][m].
template <int W> __device__ __forceinline__ uint32_t row_pairs(int row0, int c0, int lane) {
  return swizzle<W>(row0 + (lane & 7) + 8 * ((lane >> 3) & 1), c0 + (lane >> 4));
}
template <int W> __device__ __forceinline__ uint32_t chunk_pairs(int row0, int c0, int lane) {
  return swizzle<W>(row0 + (lane & 7) + 8 * (lane >> 4), c0 + ((lane >> 3) & 1));
}

// Two f32 as one bf16x2 register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}
// The low and the high bf16 of a bf16x2 register, as f32 (exact).
__device__ __forceinline__ float bf16_low(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_high(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// a and b as hi = bf16(v) and lo = bf16(v - hi), each pair one bf16x2 register.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - bf16_low(hi), b - bf16_high(hi));
}

// d += (a_hi + a_lo) * b: the two halves of a split f32 operand.
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  mma_bf16(d, hi, b0, b1);
  mma_bf16(d, lo, b0, b1);
}

// rows 0 .. rows - 1 of a bf16 (rows, WIDTH) slice with row stride `stride`
// into a swizzled tile at `dst` by cp.async, THREADS threads; rows at or past
// `valid` are zeros.
template <int WIDTH, int THREADS>
__device__ __forceinline__ void stage_rows(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                           size_t stride, int valid, int rows) {
  constexpr int W = WIDTH / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * W; i += THREADS) {
    const int r = i / W, cc = i % W;
    const bool ok = r < valid;
    cp_async16(dst + swizzle<W>(r, cc), ok ? src + (size_t)r * stride + 8 * cc : src, ok);
  }
}
