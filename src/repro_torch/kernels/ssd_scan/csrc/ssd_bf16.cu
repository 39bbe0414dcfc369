// Mamba2 SSD forward for bf16 inputs on Hopper's tensor cores (sm_90a): the
// whole of ops.ssd in three kernels; and ssd_bwd_dstate of the backward for
// bf16 inputs, the same product as ssd_chunk_state's (described where it is
// defined).
//
// Replaces, for bf16 x, B and C (the served path), the TPU kernel
// `ssd_chunk_pallas` (body `_kernel`) of src/repro/kernels/ssd_scan/kernel.py
// together with the state passing and carry that the JAX package's
// ssd_scan/ops.py does around it.  It computes what they compute, not block by
// block.  For batch b, head h of group g = h / (H/G), chunk c of Q rows, all
// sums in f32:
//   ssd_chunk_state:  cum_k = sum_{j <= k} A dt_j within the chunk, and
//                     chunk_in[c] = sum_k (x_k dt_k exp(cum_end - cum_k)) (outer) B_k      (P x N)
//   ssd_state_pass:   h_in[0] = h0 or 0;  h_in[c + 1] = h_in[c] exp(cum_end[c]) + chunk_in[c];
//                     h_final = h_in[nc]                                                 (P x N)
//   ssd_chunk_scan:   y_q = sum_{k <= q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//                         + exp(cum_q) C_q . h_in[c] + D x_q                             (P)
// This is the chunk_state / state_passing / chunk_scan split of the published
// Mamba2 implementation, with its chunk cumsum folded into chunk_state.  y is
// written once, in bf16; cum, chunk_in, h_in and h_final are f32.  Layouts are
// the model's: x and y (Bt, S, H, P); dt and cum (Bt, S, H); A and D (H);
// B and C (Bt, S, G, N), read by group; chunk_in and h_in (Bt, nc, H, P, N);
// h0 and h_final (Bt, H, P, N); all contiguous.
//
// Numerics.  The tensor cores take bf16 operands, and three operands of this
// function are f32: the scores (C.B^T) exp(cum_q - cum_k) dt_k, the weighted
// input x_k dt_k exp(cum_end - cum_k) of chunk_in, and the incoming state h_in
// of the carry.  Rounded once to bf16 they move y past one bf16 step and
// h_final past 2e-4 (a case in tests/test_torch_ssd_scan.py).  So each enters
// as two bf16 values, hi = bf16(v) and lo = bf16(v - hi), in two mma.sync into
// the same f32 accumulator: hi + lo carries 16 bits of v's mantissa.  x, B and
// C are bf16 already and enter exactly; every product of two bf16 is exact in
// f32.  The decay is formed as exp(cum_q - cum_k) only where k <= q (masked
// BEFORE the exp, as the TPU kernel does): with mamba2-780m's A, cum falls to
// about -2,000 within a chunk, and the factored form exp(cum_q) exp(-cum_k)
// would overflow.  chunk_in's weights use expf of the difference, as the plain
// version does; the scores, which reach only y, one ex2.approx of a
// difference of a per-row and a per-key term (relative error about 2e-4 at
// |cum| near 2,000, far inside y's one bf16 step).  The cumsum adds in
// PyTorch's order, so cum has the plain version's bits.
//
// What bounds it on the H100.  At mamba2-780m's serving shape (Bt 4, S 2048,
// H 48, P 64, G 1, N 128, chunk 256) the function must read x, dt, cum, B and
// C and write y and h_final: 114 MB, 0.034 ms at 3.35 TB/s, against 19.7
// GFLOP (0.020 ms at 989 TFLOP/s).  Split in three, it also writes and reads
// back cum, chunk_in and h_in (50 MB each of the last two, f32), and the hi +
// lo split doubles the three products to about 39 GFLOP.  What the design
// does (PERF.md has the times of what was tried):
//   * C.B^T does not depend on the head.  ssd_chunk_scan takes one block per
//     (batch * chunk, block of heads inside one group), 8 warps and one block
//     an SM; warp w owns the 16-row strips w and 15 - w, so every warp has
//     17 key slices at or below its rows whatever w is (no warp waits for
//     another at the block's barriers).  Each warp computes C.B^T for its
//     strips once, on the tensor cores, and keeps the 15 slices below the
//     diagonals in registers (the accumulator of two key n-tiles is, element
//     for element, the A fragment of one k-slice of scores . x, as in
//     flash_attn_fwd.cu) and the two diagonal slices in shared memory, then
//     walks the heads of the block;
//   * x of the whole chunk and h_in are read once per (chunk, head): x, cum
//     and dt of the next head come by cp.async into the other of two stages
//     and h_in into its f32 buffer while a head is computed; h_in is split
//     into hi and lo bf16 in shared memory once per head; for each strip the
//     carry C.h_in^T is accumulated first, scaled by exp(cum_q) per row, then
//     scores . x and D x are added to the same accumulator and y is written
//     once;
//   * ssd_chunk_state takes one block per (batch * chunk, block of heads), B of
//     the chunk staged once; it makes cum of its heads first (and writes it
//     for the other two kernels), then x of each head comes by cp.async and
//     is read as the transposed A operand by ldmatrix.trans, weighted and
//     split in registers;
//   * ssd_state_pass runs the sequential recurrence over the chunks with four
//     state elements a thread in f32, rounding as the plain version does;
//   * bf16 rows stay in shared memory in 16-byte chunks whose index is
//     XOR-swizzled by the row, so every ldmatrix (eight rows at one chunk
//     column) touches eight distinct bank groups.  The mma.sync, ldmatrix,
//     cp.async and swizzle code is that of flash_attn_fwd.cu, copied here so
//     that this source builds alone; the swizzle also takes rows of 4 chunks
//     (P 32, N 32).
// Rows past the chunk inside a 16-row tile are zeros, so chunk 1..256 works;
// a head block never straddles a group, so any G dividing H works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_CHUNK = 256;  // the wrapper refuses larger chunks
constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of 16-byte chunk c of `row` in a tile whose rows are W chunks.
// The chunk index is XORed with bits of the row so that the eight rows one
// ldmatrix reads at one chunk column fall in eight distinct 16-byte bank
// groups; the bits XORed are those of row % 8, so a tile may start at any
// row that is a multiple of 8.
template <int W> __device__ __forceinline__ uint32_t swizzle(int row, int c) {
  static_assert(W == 2 || W == 4 || W % 8 == 0, "rows of 2, 4 or a multiple of 8 chunks");
  const int x = W >= 8 ? (row & 7) : W == 4 ? ((row >> 1) & 3) : ((row >> 2) & 1);
  return (uint32_t)(row * W + (c ^ x)) * 16u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; zeros if !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// d += (a_hi + a_lo) * b: the two halves of a split f32 operand.
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  mma_bf16(d, hi, b0, b1);
  mma_bf16(d, lo, b0, b1);
}

// 2^x by the SFU's ex2.approx.ftz: one instruction, relative error near 2^-22.
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
// The low and the high bf16 of a bf16x2 register, as f32 (exact).
__device__ __forceinline__ float bf16_low(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_high(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// a and b as hi = bf16(v) and lo = bf16(v - hi), each pair one bf16x2 register.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - bf16_low(hi), b - bf16_high(hi));
}

// The heads [h_begin, h_end) of block `hb` of group g: head_block heads, fewer
// at the group's end.
struct HeadBlock {
  int h_begin, h_end;
  __device__ HeadBlock(int g, int hb, int R, int head_block)
      : h_begin(g * R + hb * head_block), h_end(min(g * R + (hb + 1) * head_block, (g + 1) * R)) {}
};

// Fragment layouts of m16n8k16 (lane = 4 g + t): the A fragment holds rows g
// and g + 8 at columns 2t, 2t + 1 (regs 0, 1) and 2t + 8, 2t + 9 (regs 2,
// 3); the B fragment rows (k) 2t, 2t + 1 and 2t + 8, 2t + 9 at column g; the
// f32 accumulator rows g (elements 0, 1) and g + 8 (2, 3) at columns 2t, 2t + 1.
// ldmatrix: lane l gives the address of row l % 8 of matrix l / 8.  Two read
// patterns: "row pairs" (matrix m at row + 8 (m & 1), chunk + (m >> 1)) reads
// an A operand stored [m][k] or a B operand stored [k][n] by .trans; "chunk
// pairs" (matrix m at row + 8 (m >> 1), chunk + (m & 1)) reads a B operand
// stored [n][k] or an A operand stored [k][m] by .trans.
template <int W> __device__ __forceinline__ uint32_t row_pairs(int row0, int c0, int lane) {
  return swizzle<W>(row0 + (lane & 7) + 8 * ((lane >> 3) & 1), c0 + (lane >> 4));
}
template <int W> __device__ __forceinline__ uint32_t chunk_pairs(int row0, int c0, int lane) {
  return swizzle<W>(row0 + (lane & 7) + 8 * (lane >> 4), c0 + ((lane >> 3) & 1));
}

// ---------------------------------------------------------------------------
// ssd_chunk_state: cum, the within-chunk cumulative sum of A dt, and
// chunk_in = (x w)^T . B with w_k = dt_k exp(cum_end - cum_k) <= 1.

constexpr int MAX_STATE_HEADS = 16;  // the wrapper refuses larger head blocks
constexpr int CUM_LD = MAX_CHUNK + 1;  // row stride of dt and cum in shared memory

// Warps along P (16 rows each) and along N, and the n-tiles of one warp.
template <int P, int N> struct StateConfig {
  static constexpr int WM = P / 16;
  static constexpr int WN = (N / 16 < 8 / WM) ? N / 16 : 8 / WM;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int NTW = N / 8 / WN;
  // B of the chunk, x of one head (both bf16), w of one head; then dt and
  // cum of the block's heads (f32), head_block rows of each
  static constexpr int BASE = MAX_CHUNK * (N + P) * 2 + MAX_CHUNK * 4;
  static int smem(int head_block) { return BASE + 2 * head_block * CUM_LD * 4; }
};

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

// dst (P x N, f32, row-major) = (x w)^T . B over the `rows` staged rows (a
// multiple of 16; rows past the chunk are zeros): x ([rows][P] bf16) and B
// ([rows][N] bf16) swizzled in shared memory, w ([rows] f32) beside them.
// Warp w owns the 16 rows p0 of P and NTW 8-column n-tiles from n0 of N;
// x w is formed in f32 and split into hi + lo bf16 in registers.
template <int P, int N>
__device__ __forceinline__ void weighted_outer(float* __restrict__ dst, uint32_t xs,
                                               const float* w_s, uint32_t bs, int rows) {
  using Cfg = StateConfig<P, N>;
  constexpr int NTW = Cfg::NTW, WX = P / 8, WB = N / 8;
  static_assert(NTW % 2 == 0, "n-tiles in pairs");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  const int p0 = 16 * (warp % Cfg::WM), n0 = 8 * NTW * (warp / Cfg::WM);
  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < rows; k0 += 16) {
    // The A fragment of rows p0.. of (x w)^T at keys k0..: x is stored
    // [k][p], so ldmatrix.trans; regs 0, 1 hold keys k0 + 2t, + 1 and
    // regs 2, 3 keys k0 + 8 + 2t, + 1.
    uint32_t a[4], ahi[4], alo[4];
    ldmatrix_x4_trans(a, xs + chunk_pairs<WX>(k0, p0 / 8, lane));
    const float2 w01 = *reinterpret_cast<const float2*>(w_s + k0 + 2 * t);
    const float2 w89 = *reinterpret_cast<const float2*>(w_s + k0 + 8 + 2 * t);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 w = r < 2 ? w01 : w89;
      split_bf16(bf16_low(a[r]) * w.x, bf16_high(a[r]) * w.y, ahi[r], alo[r]);
    }
#pragma unroll
    for (int np = 0; np < NTW / 2; ++np) {  // state n-tiles 2np and 2np + 1
      uint32_t b[4];  // B is stored [k][n]: the B operand by .trans
      ldmatrix_x4_trans(b, bs + row_pairs<WB>(k0, (n0 + 16 * np) / 8, lane));
      mma_split(acc[2 * np], ahi, alo, b[0], b[1]);
      mma_split(acc[2 * np + 1], ahi, alo, b[2], b[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int col = n0 + 8 * n + 2 * t;
    *reinterpret_cast<float2*>(dst + (size_t)(p0 + gq) * N + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(dst + (size_t)(p0 + gq + 8) * N + col) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(StateConfig<P, N>::THREADS, 2)
ssd_chunk_state_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                       float* __restrict__ chunk_in, float* __restrict__ cum, int H, int G,
                       int chunk, int head_block) {
  using Cfg = StateConfig<P, N>;
  constexpr int THREADS = Cfg::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bs = smem_addr(smem);       // B: [MAX_CHUNK][N], swizzled
  const uint32_t xs = bs + MAX_CHUNK * N * 2;  // x of one head: [MAX_CHUNK][P]
  float* const w_s = reinterpret_cast<float*>(smem + MAX_CHUNK * (N + P) * 2);
  float* const dt_s = reinterpret_cast<float*>(smem + Cfg::BASE);  // [head_block][CUM_LD]
  float* const cum_s = dt_s + head_block * CUM_LD;

  const int R = H / G, nhb = (R + head_block - 1) / head_block;
  const int hb = blockIdx.x % nhb, g = blockIdx.x / nhb % G;
  const size_t bc = blockIdx.x / nhb / G;  // b * nc + c
  const HeadBlock heads(g, hb, R, head_block);
  const size_t row0 = bc * chunk;  // the chunk's first row of (Bt * S)
  const int rows = (chunk + 15) & ~15;

  // B of the chunk, once for all heads of the block; rows past it zeros.
  stage_rows<N, THREADS>(bs, Bm + row0 * G * N + (size_t)g * N, (size_t)G * N, chunk, rows);
  cp_async_commit();

  // cum of the block's heads, a thread a head adding in row order, each
  // product and sum rounded on its own: the order and the roundings of
  // PyTorch's cumsum over a dimension that is not the last (a sequential
  // loop a thread), so chunk_cumsum gives the same bits.  Written out for
  // ssd_state_pass and ssd_chunk_scan.
  const int nh = heads.h_end - heads.h_begin;
  const size_t at0 = row0 * H + heads.h_begin;  // (row 0 of the chunk, first head)
  for (int i = threadIdx.x; i < nh * chunk; i += THREADS)
    dt_s[(i % nh) * CUM_LD + i / nh] = dt[at0 + (size_t)(i / nh) * H + i % nh];
  __syncthreads();
  if (threadIdx.x < nh) {
    const float a = A[heads.h_begin + threadIdx.x];
    const float* d = dt_s + threadIdx.x * CUM_LD;
    float* c = cum_s + threadIdx.x * CUM_LD;
    float acc = 0.f;
    for (int k0 = 0; k0 < chunk; k0 += 16) {  // 16 rows read, added in order, written
      float r[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) r[u] = d[min(k0 + u, MAX_CHUNK - 1)];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        acc = __fadd_rn(acc, __fmul_rn(a, r[u]));
        if (k0 + u < chunk) c[k0 + u] = acc;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * chunk; i += THREADS)
    cum[at0 + (size_t)(i / nh) * H + i % nh] = cum_s[(i % nh) * CUM_LD + i / nh];

  for (int h = heads.h_begin; h < heads.h_end; ++h) {
    __syncthreads();  // no warp still reads the previous head's x and w
    const float* dt_h = dt_s + (h - heads.h_begin) * CUM_LD;
    const float* cum_h = cum_s + (h - heads.h_begin) * CUM_LD;
    stage_rows<P, THREADS>(xs, x + row0 * H * P + (size_t)h * P, (size_t)H * P, chunk, rows);
    cp_async_commit();
    const float cum_end = cum_h[chunk - 1];
    for (int k = threadIdx.x; k < rows; k += THREADS)
      w_s[k] = k < chunk ? dt_h[k] * expf(cum_end - cum_h[k]) : 0.f;
    cp_async_wait_all();
    __syncthreads();

    weighted_outer<P, N>(chunk_in + (bc * H + h) * P * N, xs, w_s, bs, rows);
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_dstate for bf16 dy and C, the training path's: the gradient of each
// chunk's incoming state through its carry,
//   dS_c = sum_q exp(cum_q) dy_q (outer) C_q = (dy w)^T . C,  w_q = exp(cum_q),
// (P x N, f32), the product of ssd_chunk_state with dy for x, C for B and
// exp(cum) for its weight (the f32 inputs' kernel is ssd_bwd.cu's).  It has
// no TPU counterpart: the JAX package differentiates the jnp path of
// ssd_chunk_pallas.  At mamba2-780m's training shape it reads dy (50 MB), C
// and cum and writes dS (50 MB): bound by bytes, 0.031 ms at 3.35 TB/s,
// against 6.4 GFLOP (12.9 with hi + lo).  C depends on the group alone, so a
// block per (batch * chunk, group, block of heads) stages the chunk's C once
// for its heads, and cum of its heads once (rows of head_block contiguous
// values); each head's dy comes by cp.async, w = exp(cum) (expf, as the
// plain version's exp) scales it in f32 and hi + lo bf16 carry the product
// into the f32 accumulators; each head's P x N result is written once.

template <int P, int N>
__global__ void __launch_bounds__(StateConfig<P, N>::THREADS, 2)
ssd_bwd_dstate_tc_kernel(const __nv_bfloat16* __restrict__ dy, const float* __restrict__ cum,
                         const __nv_bfloat16* __restrict__ C, float* __restrict__ dS, int H,
                         int G, int chunk, int head_block) {
  using Cfg = StateConfig<P, N>;
  constexpr int THREADS = Cfg::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t cs = smem_addr(smem);         // C: [MAX_CHUNK][N], swizzled
  const uint32_t ys = cs + MAX_CHUNK * N * 2;  // dy of one head: [MAX_CHUNK][P]
  float* const w_s = reinterpret_cast<float*>(smem + MAX_CHUNK * (N + P) * 2);
  float* const cum_s = reinterpret_cast<float*>(smem + Cfg::BASE);  // [head_block][CUM_LD]

  const int R = H / G, nhb = (R + head_block - 1) / head_block;
  const int hb = blockIdx.x % nhb, g = blockIdx.x / nhb % G;
  const size_t bc = blockIdx.x / nhb / G;  // b * nc + c
  const HeadBlock heads(g, hb, R, head_block);
  const size_t row0 = bc * chunk;  // the chunk's first row of (Bt * S)
  const int rows = (chunk + 15) & ~15;

  stage_rows<N, THREADS>(cs, C + row0 * G * N + (size_t)g * N, (size_t)G * N, chunk, rows);
  cp_async_commit();
  const int nh = heads.h_end - heads.h_begin;
  const size_t at0 = row0 * H + heads.h_begin;  // (row 0 of the chunk, first head)
  for (int i = threadIdx.x; i < nh * chunk; i += THREADS)
    cum_s[(i % nh) * CUM_LD + i / nh] = cum[at0 + (size_t)(i / nh) * H + i % nh];

  for (int h = heads.h_begin; h < heads.h_end; ++h) {
    __syncthreads();  // no warp still reads the previous head's dy and w; cum_s is in place
    stage_rows<P, THREADS>(ys, dy + row0 * H * P + (size_t)h * P, (size_t)H * P, chunk, rows);
    cp_async_commit();
    const float* cum_h = cum_s + (h - heads.h_begin) * CUM_LD;
    for (int q = threadIdx.x; q < rows; q += THREADS) w_s[q] = q < chunk ? expf(cum_h[q]) : 0.f;
    cp_async_wait_all();
    __syncthreads();
    weighted_outer<P, N>(dS + (bc * H + h) * P * N, ys, w_s, cs, rows);
  }
}

// ---------------------------------------------------------------------------
// ssd_state_pass: the recurrence over the chunks, four state elements a
// thread; the multiply and the add round separately, as in the plain version.

constexpr int PASS_THREADS = 256;

__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(const float4* __restrict__ chunk_in, const float* __restrict__ cum,
                      const float4* __restrict__ h0, float4* __restrict__ h_ins,
                      float4* __restrict__ h_final, long long total, int nc, int H, int PN4,
                      int chunk) {
  const long long i = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (i >= total) return;
  const int e = (int)(i % PN4);
  const long long bh = i / PN4;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  float4 s = h0 ? h0[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const size_t o = (((size_t)b * nc + c) * H + h) * PN4 + e;
    h_ins[o] = s;  // the state entering chunk c
    const float d = expf(cum[(((size_t)b * nc + c) * chunk + chunk - 1) * H + h]);
    const float4 v = chunk_in[o];
    s.x = __fadd_rn(__fmul_rn(s.x, d), v.x);
    s.y = __fadd_rn(__fmul_rn(s.y, d), v.y);
    s.z = __fadd_rn(__fmul_rn(s.z, d), v.z);
    s.w = __fadd_rn(__fmul_rn(s.w, d), v.w);
  }
  h_final[i] = s;
}

// ---------------------------------------------------------------------------
// ssd_chunk_scan: y of one chunk for a block of heads.

constexpr int SCAN_WARPS = 8, SCAN_THREADS = 32 * SCAN_WARPS;
constexpr int STRIPS = MAX_CHUNK / 16;  // 16-row strips of a chunk: warp w takes w and 15 - w

// 4 bytes from global to shared memory, asynchronously; zero if !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int P, int N> struct ScanConfig {
  // C of the chunk; two stages, each x, cum and dt of one head; h_in of one
  // head as f32 (by cp.async) and split into hi and lo bf16 rows [p][n],
  // whose bytes hold B of the chunk while C.B^T is formed; the key terms u_k
  // of one head; each warp's two diagonal slices of C.B^T, in fragment order.
  static constexpr int C_BYTES = MAX_CHUNK * N * 2;
  static constexpr int X_BYTES = MAX_CHUNK * P * 2;
  static constexpr int STAGE_BYTES = X_BYTES + 2 * MAX_CHUNK * 4;
  static constexpr int F_BYTES = P * N * 4, H_BYTES = P * N * 2;
  static constexpr int B_BYTES = MAX_CHUNK * N * 2;
  static constexpr int HREG_BYTES =
      F_BYTES + 2 * H_BYTES > B_BYTES ? F_BYTES + 2 * H_BYTES : B_BYTES;
  static constexpr int DIAG_AT = C_BYTES + 2 * STAGE_BYTES + HREG_BYTES + MAX_CHUNK * 4;
  static constexpr int SMEM = DIAG_AT + SCAN_WARPS * 2 * 8 * 32 * 4;
};

// acc += scores . x for key slice kp of a warp's 16 rows qa - g.. (lane
// rows qa and qb = qa + 8): c0 and c1 hold C.B^T of the slice's key n-tiles
// in accumulator layout, which is, element for element, the A fragment of
// the slice's product with x (stored [k][p] at `xs`: the B operand by
// .trans).  The decay times dt is one ex2 of a difference of per-row (la, lb
// = cum_q log2(e)) and per-key (u_k) terms; at |cum| near 2,000 their
// rounding moves a score by about 2e-4 of itself, far inside y's one bf16
// step.  In the diagonal slice the mask applies before the exp.
template <int P>
__device__ __forceinline__ void scores_x(float (&acc)[P / 8][4], const float (&c0)[4],
                                         const float (&c1)[4], int kp, bool diag,
                                         const float* u_s, uint32_t xs, float la, float lb,
                                         int qa, int qb, int lane) {
  constexpr int WX = P / 8;
  const int t = lane % 4;
  uint32_t ahi[4], alo[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = 16 * kp + 8 * j + 2 * t;
    const float2 uk = *reinterpret_cast<const float2*>(u_s + k);
    float sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = e < 2 ? qa : qb;
      const float l = e < 2 ? la : lb, u = (e & 1) ? uk.y : uk.x;
      const float decay = diag && k + (e & 1) > q ? 0.f : fast_exp2(l - u);
      sc[e] = (j ? c1[e] : c0[e]) * decay;
    }
    split_bf16(sc[0], sc[1], ahi[2 * j], alo[2 * j]);          // row g
    split_bf16(sc[2], sc[3], ahi[2 * j + 1], alo[2 * j + 1]);  // row g + 8
  }
#pragma unroll
  for (int pp = 0; pp < P / 16; ++pp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, xs + row_pairs<WX>(16 * kp, 2 * pp, lane));
    mma_split(acc[2 * pp], ahi, alo, b[0], b[1]);
    mma_split(acc[2 * pp + 1], ahi, alo, b[2], b[3]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
ssd_chunk_scan_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ cum, const __nv_bfloat16* __restrict__ Bm,
                      const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ D,
                      const float* __restrict__ h_ins, __nv_bfloat16* __restrict__ y, int H,
                      int G, int chunk, int head_block) {
  using Cfg = ScanConfig<P, N>;
  constexpr int WX = P / 8, WC = N / 8;  // 16-byte chunks per row of x and of B, C, h_in
  constexpr int NS = STRIPS - 1;         // key slices below the diagonals of a warp's strips
  constexpr int PT = P / 8;              // n-tiles of y
  constexpr int CUM_AT = Cfg::X_BYTES, DT_AT = CUM_AT + MAX_CHUNK * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t cs = smem_addr(smem);  // C: [MAX_CHUNK][N]
  const uint32_t stage0 = cs + Cfg::C_BYTES, stage1 = stage0 + Cfg::STAGE_BYTES;
  const uint32_t hreg = stage1 + Cfg::STAGE_BYTES;  // B, later h_in f32 | hi | lo
  const uint32_t hhi = hreg + Cfg::F_BYTES, hlo = hhi + Cfg::H_BYTES;
  float* const u_s =
      reinterpret_cast<float*>(smem + Cfg::C_BYTES + 2 * Cfg::STAGE_BYTES + Cfg::HREG_BYTES);
  float* const diag_s = reinterpret_cast<float*>(smem + Cfg::DIAG_AT);

  const int R = H / G, nhb = (R + head_block - 1) / head_block;
  const int hb = blockIdx.x % nhb, g = blockIdx.x / nhb % G;
  const size_t bc = blockIdx.x / nhb / G;  // b * nc + c
  const HeadBlock heads(g, hb, R, head_block);
  const size_t row0 = bc * chunk;
  const int rows = (chunk + 15) & ~15;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  // The warp's strips: A at rows 16 warp with key slices 0..warp, B at rows
  // 16 (15 - warp) with key slices 0..15 - warp: 17 slices for every warp.
  // C.B^T of the 15 slices below the diagonals stays in registers (A's in
  // cb[0..warp - 1], B's in cb[warp..14]), that of the two diagonal slices
  // in shared memory.  A strip past the chunk is skipped (warp-uniform).
  const int row_a = 16 * warp, row_b = 16 * (STRIPS - 1 - warp);
  const bool live_a = row_a < chunk, live_b = row_b < chunk;

  auto load_x = [&](int h, uint32_t stage) {  // x, cum and dt of head h; zeros past the chunk
    const __nv_bfloat16* xsrc = x + row0 * H * P + (size_t)h * P;
    for (int i = threadIdx.x; i < rows * WX; i += SCAN_THREADS) {
      const int r = i / WX, cc = i % WX;
      const bool ok = r < chunk;
      cp_async16(stage + swizzle<WX>(r, cc), ok ? xsrc + (size_t)r * H * P + 8 * cc : xsrc, ok);
    }
    for (int k = threadIdx.x; k < rows; k += SCAN_THREADS) {
      const bool ok = k < chunk;
      const size_t at = ok ? (row0 + k) * H + h : 0;
      cp_async4(stage + CUM_AT + 4 * k, cum + at, ok);
      cp_async4(stage + DT_AT + 4 * k, dt + at, ok);
    }
  };
  auto load_h = [&](int h) {  // h_in of head h, f32
    const float* hsrc = h_ins + (bc * H + h) * P * N;
    for (int i = threadIdx.x; i < P * N / 4; i += SCAN_THREADS)
      cp_async16(hreg + 16 * i, hsrc + 4 * i, true);
  };

  // C and B of the chunk, and x of the first head.
  {
    const __nv_bfloat16* csrc = Cm + row0 * G * N + (size_t)g * N;
    const __nv_bfloat16* bsrc = Bm + row0 * G * N + (size_t)g * N;
    for (int i = threadIdx.x; i < rows * WC; i += SCAN_THREADS) {
      const int r = i / WC, cc = i % WC;
      const bool ok = r < chunk;
      const size_t off = (size_t)r * G * N + 8 * cc;
      cp_async16(cs + swizzle<WC>(r, cc), ok ? csrc + off : csrc, ok);
      cp_async16(hreg + swizzle<WC>(r, cc), ok ? bsrc + off : bsrc, ok);
    }
    load_x(heads.h_begin, stage0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // C.B^T of the warp's two strips, once for all heads: key n-tiles 2i and
  // 2i + 1 of slice i.  B is stored [k][n]: the B operand of C.B^T (n = key,
  // k = state) without .trans.
  float cb[2 * NS][4], cd[2][2][4];  // below the diagonals; the diagonal slices
#pragma unroll
  for (int n = 0; n < 2 * NS; ++n) cb[n][0] = cb[n][1] = cb[n][2] = cb[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < 4; ++n) cd[n / 2][n % 2][0] = cd[n / 2][n % 2][1] =
      cd[n / 2][n % 2][2] = cd[n / 2][n % 2][3] = 0.f;
#pragma unroll
  for (int kn = 0; kn < N / 16; ++kn) {
    uint32_t fa[4], fb[4], b[4];
    ldmatrix_x4(fa, cs + row_pairs<WC>(row_a, 2 * kn, lane));
    ldmatrix_x4(fb, cs + row_pairs<WC>(row_b, 2 * kn, lane));
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const bool in_a = i < warp;
      if (in_a ? live_a : live_b) {
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = in_a ? fa[r] : fb[r];
        ldmatrix_x4(b, hreg + chunk_pairs<WC>(16 * (in_a ? i : i - warp), 2 * kn, lane));
        mma_bf16(cb[2 * i], a, b[0], b[1]);
        mma_bf16(cb[2 * i + 1], a, b[2], b[3]);
      }
    }
    if (live_a) {
      ldmatrix_x4(b, hreg + chunk_pairs<WC>(row_a, 2 * kn, lane));
      mma_bf16(cd[0][0], fa, b[0], b[1]);
      mma_bf16(cd[0][1], fa, b[2], b[3]);
    }
    if (live_b) {
      ldmatrix_x4(b, hreg + chunk_pairs<WC>(row_b, 2 * kn, lane));
      mma_bf16(cd[1][0], fb, b[0], b[1]);
      mma_bf16(cd[1][1], fb, b[2], b[3]);
    }
  }
  // diag_s[warp][strip][j * 4 + e][lane]: each lane reads back its own
#pragma unroll
  for (int v = 0; v < 16; ++v)
    diag_s[((warp * 2 + v / 8) * 8 + v % 8) * 32 + lane] = cd[v / 8][v % 8 / 4][v % 4];
  __syncthreads();  // B is no longer read: h_in of the first head takes its bytes
  load_h(heads.h_begin);
  cp_async_commit();

  for (int h = heads.h_begin; h < heads.h_end; ++h) {
    const bool odd = (h - heads.h_begin) & 1;
    const uint32_t st = odd ? stage1 : stage0;
    // No warp still reads the other stage, h_in's hi and lo or u: the next
    // head's x goes into the other stage while this one is computed.
    __syncthreads();
    if (h + 1 < heads.h_end) {
      load_x(h + 1, odd ? stage0 : stage1);
      cp_async_commit();
      cp_async_wait<1>();  // this head's x and h_in have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cum_s = reinterpret_cast<const float*>(smem + (st - cs) + CUM_AT);
    {
      // h_in as hi and lo bf16 rows [p][n]; the key terms u_k, so that
      // exp(cum_q - cum_k) dt_k = 2^(cum_q log2(e) - u_k) (dt_k = 0, past
      // the chunk, gives u_k = inf and 0).
      const float* dt_s = reinterpret_cast<const float*>(smem + (st - cs) + DT_AT);
      for (int k = threadIdx.x; k < rows; k += SCAN_THREADS)
        u_s[k] = cum_s[k] * LOG2E - __log2f(dt_s[k]);
      const unsigned char* hf = smem + (hreg - cs);
      unsigned char* const hi_p = smem + (hhi - cs);
      unsigned char* const lo_p = smem + (hlo - cs);
      for (int i = threadIdx.x; i < P * N / 4; i += SCAN_THREADS) {
        const int p = i / (N / 4), n = 4 * (i % (N / 4));
        const float4 v = *reinterpret_cast<const float4*>(hf + 16 * i);
        uint2 hi, lo;
        split_bf16(v.x, v.y, hi.x, lo.x);
        split_bf16(v.z, v.w, hi.y, lo.y);
        const uint32_t off = swizzle<WC>(p, n / 8) + (n % 8) * 2;
        *reinterpret_cast<uint2*>(hi_p + off) = hi;
        *reinterpret_cast<uint2*>(lo_p + off) = lo;
      }
    }
    __syncthreads();
    if (h + 1 < heads.h_end) {  // the f32 bytes are free again
      load_h(h + 1);
      cp_async_commit();
    }
    const float dh = D[h];
    __nv_bfloat16* ybase = y + row0 * H * P + (size_t)h * P;

#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {  // strip A, then strip B
      if (!(pass ? live_b : live_a)) continue;
      const int s0 = pass ? row_b : row_a;
      const int qa = s0 + gq, qb = qa + 8;  // the lane's rows

      // The carry, C_q . h_in^T (h_in is stored [p][n]: the B operand
      // without .trans), then scaled by exp(cum_q) row by row.
      float acc[PT][4];
#pragma unroll
      for (int d = 0; d < PT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn) {
        uint32_t a[4];
        ldmatrix_x4(a, cs + row_pairs<WC>(s0, 2 * kn, lane));
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {  // head-dim n-tiles 2pp and 2pp + 1
          const uint32_t off = chunk_pairs<WC>(16 * pp, 2 * kn, lane);
#pragma unroll
          for (int half = 0; half < 2; ++half) {  // hi, then lo
            uint32_t b[4];
            ldmatrix_x4(b, (half ? hlo : hhi) + off);
            mma_bf16(acc[2 * pp], a, b[0], b[1]);
            mma_bf16(acc[2 * pp + 1], a, b[2], b[3]);
          }
        }
      }
      const float cqa = cum_s[qa], cqb = cum_s[qb];
      const float ea = fast_exp2(cqa * LOG2E), eb = fast_exp2(cqb * LOG2E);
#pragma unroll
      for (int d = 0; d < PT; ++d) {
        acc[d][0] *= ea; acc[d][1] *= ea;
        acc[d][2] *= eb; acc[d][3] *= eb;
      }

      // + scores . x: the slices below the diagonal, then the diagonal one.
      const float la = cqa * LOG2E, lb = cqb * LOG2E;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (pass ? i >= warp : i < warp)
          scores_x<P>(acc, cb[2 * i], cb[2 * i + 1], pass ? i - warp : i, false, u_s, st, la, lb,
                      qa, qb, lane);
      }
      {
        float c0[4], c1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c0[e] = diag_s[((warp * 2 + pass) * 8 + e) * 32 + lane];
          c1[e] = diag_s[((warp * 2 + pass) * 8 + 4 + e) * 32 + lane];
        }
        scores_x<P>(acc, c0, c1, s0 / 16, true, u_s, st, la, lb, qa, qb, lane);
      }

      // + D x, and y written once in bf16.
      const unsigned char* xs_p = smem + (st - cs);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = r ? qb : qa;
        if (q < chunk) {
#pragma unroll
          for (int d = 0; d < PT; ++d) {
            uint32_t xv;
            memcpy(&xv, xs_p + swizzle<WX>(q, d) + 4 * t, sizeof(xv));
            const float v0 = fmaf(dh, bf16_low(xv), acc[d][2 * r]);
            const float v1 = fmaf(dh, bf16_high(xv), acc[d][2 * r + 1]);
            *reinterpret_cast<uint32_t*>(ybase + (size_t)q * H * P + 8 * d + 2 * t) =
                pack_bf16(v0, v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.

template <int P, int N>
int launch_state(const void* x, const void* dt, const void* A, const void* B, void* chunk_in,
                 void* cum, int Bt, int S, int H, int G, int chunk, int head_block,
                 cudaStream_t stream) {
  using Cfg = StateConfig<P, N>;
  auto kernel = ssd_chunk_state_kernel<P, N>;
  if (head_block > MAX_STATE_HEADS) return (int)cudaErrorInvalidValue;
  const int smem = Cfg::smem(head_block);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)Bt * (S / chunk) * G * ((H / G + head_block - 1) / head_block);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, Cfg::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<float*>(chunk_in), static_cast<float*>(cum), H, G, chunk, head_block);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch_dstate(const void* dy, const void* cum, const void* C, void* dS, int Bt, int S, int H,
                  int G, int chunk, int head_block, cudaStream_t stream) {
  using Cfg = StateConfig<P, N>;
  auto kernel = ssd_bwd_dstate_tc_kernel<P, N>;
  if (head_block > MAX_STATE_HEADS) return (int)cudaErrorInvalidValue;
  const int smem = Cfg::smem(head_block);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)Bt * (S / chunk) * G * ((H / G + head_block - 1) / head_block);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, Cfg::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(cum),
      static_cast<const __nv_bfloat16*>(C), static_cast<float*>(dS), H, G, chunk, head_block);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch_scan(const void* x, const void* dt, const void* cum, const void* B, const void* C,
                const void* D, const void* h_ins, void* y, int Bt, int S, int H, int G,
                int chunk, int head_block, cudaStream_t stream) {
  using Cfg = ScanConfig<P, N>;
  auto kernel = ssd_chunk_scan_kernel<P, N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)Bt * (S / chunk) * G * ((H / G + head_block - 1) / head_block);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, SCAN_THREADS, Cfg::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h_ins), static_cast<__nv_bfloat16*>(y), H, G, chunk,
      head_block);
  return (int)cudaGetLastError();
}

template <int P, int N>
int attributes_pn(int which, int head_block, cudaFuncAttributes* attr, int* dynamic_smem) {
  if (which == 0 || which == 2) {
    *dynamic_smem = StateConfig<P, N>::smem(head_block);
    return which == 0 ? (int)cudaFuncGetAttributes(attr, ssd_chunk_state_kernel<P, N>)
                      : (int)cudaFuncGetAttributes(attr, ssd_bwd_dstate_tc_kernel<P, N>);
  }
  *dynamic_smem = ScanConfig<P, N>::SMEM;
  return (int)cudaFuncGetAttributes(attr, ssd_chunk_scan_kernel<P, N>);
}

bool valid(int Bt, int S, int H, int G, int chunk, int head_block) {
  return Bt >= 1 && chunk >= 1 && chunk <= MAX_CHUNK && S >= chunk && S % chunk == 0 &&
         G >= 1 && H % G == 0 && head_block >= 1;
}

}  // namespace

// Each entry launches on `stream` and returns the CUDA error of the launch (0
// on success).  The caller has checked shapes, types (x, B, C bf16; dt, cum,
// D, chunk_in, h0, h_ins f32), contiguity, 16-byte alignment and the device;
// (P, N) is one of (16, 16), (16, 32), (32, 16), (64, 128).

extern "C" int ssd_chunk_state(const void* x, const void* dt, const void* A, const void* B,
                               void* chunk_in, void* cum, int Bt, int S, int H, int G, int P,
                               int N, int chunk, int head_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(Bt, S, H, G, chunk, head_block)) return (int)cudaErrorInvalidValue;
#define SSD_STATE(p, n)                                                                        \
  if (P == p && N == n)                                                                        \
    return launch_state<p, n>(x, dt, A, B, chunk_in, cum, Bt, S, H, G, chunk, head_block, st);
  SSD_STATE(16, 16) SSD_STATE(16, 32) SSD_STATE(32, 16) SSD_STATE(64, 128)
#undef SSD_STATE
  return (int)cudaErrorInvalidValue;
}

// h0 may be null (a zero initial state).
extern "C" int ssd_state_pass(const void* chunk_in, const void* cum, const void* h0,
                              void* h_ins, void* h_final, int Bt, int S, int H, int P, int N,
                              int chunk, void* stream) {
  if (!valid(Bt, S, H, 1, chunk, 1) || P < 1 || N < 1 || (P * N) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int PN4 = P * N / 4;
  const long long total = (long long)Bt * H * PN4;
  const long long blocks = (total + PASS_THREADS - 1) / PASS_THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ssd_state_pass_kernel<<<(unsigned)blocks, PASS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(chunk_in), static_cast<const float*>(cum),
      static_cast<const float4*>(h0), static_cast<float4*>(h_ins),
      static_cast<float4*>(h_final), total, S / chunk, H, PN4, chunk);
  return (int)cudaGetLastError();
}

extern "C" int ssd_chunk_scan(const void* x, const void* dt, const void* cum, const void* B,
                              const void* C, const void* D, const void* h_ins, void* y, int Bt,
                              int S, int H, int G, int P, int N, int chunk, int head_block,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(Bt, S, H, G, chunk, head_block)) return (int)cudaErrorInvalidValue;
#define SSD_SCAN(p, n)                                                                         \
  if (P == p && N == n)                                                                        \
    return launch_scan<p, n>(x, dt, cum, B, C, D, h_ins, y, Bt, S, H, G, chunk, head_block, st);
  SSD_SCAN(16, 16) SSD_SCAN(16, 32) SSD_SCAN(32, 16) SSD_SCAN(64, 128)
#undef SSD_SCAN
  return (int)cudaErrorInvalidValue;
}

// dS (Bt, S / chunk, H, P, N) f32 from dy (Bt, S, H, P) bf16, cum (Bt, S, H)
// f32 and C (Bt, S, G, N) bf16; head_block heads a block (at most 16).
extern "C" int ssd_bwd_dstate_bf16(const void* dy, const void* cum, const void* C, void* dS,
                                   int Bt, int S, int H, int G, int P, int N, int chunk,
                                   int head_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(Bt, S, H, G, chunk, head_block)) return (int)cudaErrorInvalidValue;
#define SSD_DSTATE(p, n)                                                                       \
  if (P == p && N == n)                                                                        \
    return launch_dstate<p, n>(dy, cum, C, dS, Bt, S, H, G, chunk, head_block, st);
  SSD_DSTATE(16, 16) SSD_DSTATE(16, 32) SSD_DSTATE(32, 16) SSD_DSTATE(64, 128)
#undef SSD_DSTATE
  return (int)cudaErrorInvalidValue;
}

// Registers, local bytes (spills and stack) and shared bytes (static plus
// dynamic) of ssd_chunk_state (which = 0), ssd_chunk_scan (which = 1) or
// ssd_bwd_dstate_tc (which = 2) at (P, N) and head_block; returns a CUDA
// error code (0 on success).
extern "C" int ssd_bf16_attributes(int which, int P, int N, int head_block, int* regs,
                                   int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  int dynamic_smem = 0, err = (int)cudaErrorInvalidValue;
  if (which < 0 || which > 2) return err;
  if (P == 16 && N == 16) err = attributes_pn<16, 16>(which, head_block, &attr, &dynamic_smem);
  if (P == 16 && N == 32) err = attributes_pn<16, 32>(which, head_block, &attr, &dynamic_smem);
  if (P == 32 && N == 16) err = attributes_pn<32, 16>(which, head_block, &attr, &dynamic_smem);
  if (P == 64 && N == 128) err = attributes_pn<64, 128>(which, head_block, &attr, &dynamic_smem);
  if (err) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes + dynamic_smem;
  return 0;
}
