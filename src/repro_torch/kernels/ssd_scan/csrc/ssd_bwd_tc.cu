// ssd_bwd_chunk for bf16 x, B, C and dy on Hopper's tensor cores (sm_90a):
// every input's gradient of the Mamba2 SSD, chunk by chunk, from the state
// entering each chunk (h_in) and the gradient of each chunk's input to the
// state (dchunk_in = Dc), as chunk_bwd_ref (kernels/ssd_scan/ref.py) defines
// it.  The TPU has no kernel for it: the JAX package differentiates the jnp
// path of `ssd_chunk_pallas` (src/repro/kernels/ssd_scan/kernel.py).  The f32
// inputs' kernel, and the one the CPU emulation builds in both types, is
// ssd_bwd_chunk_kernel of ssd_bwd.cu.  Per (batch, head, chunk), rows q >= k,
// L_qk = exp(cum_q - cum_k), s_qk = C_q . B_k, gm_qk = dy_q . x_k,
// w_k = dt_k exp(cum_end - cum_k), e_q = exp(cum_q):
//
//   dx_k  = sum_q (s L dt_k)_qk dy_q + w_k (B_k Dc^T) + D dy_k
//   dB_k  = sum_h [sum_q (L dt_k gm)_qk C_q + w_k (x_k Dc)]
//   dC_q  = sum_h [sum_k (L dt_k gm)_qk B_k + e_q (dy_q h_in^T)]
//   ddt_k = sum_q (s L gm)_qk + exp(cum_end - cum_k) (x_k . B_k Dc^T) + A rc_k
//
// with cum's gradient (the scores' share, the chunk input's through w and
// the chunk-end term, the carry's through e_q) reverse-summed within the
// chunk into rc, as in ssd_bwd.cu; dB and dC are summed over the block's
// heads and written as one partial per head block, dA and dD as one per
// (batch, chunk, head), and PyTorch adds the partials.
//
// Numerics.  dy.x^T, C.B^T and every product of a bf16 input with another
// are exact in f32.  The f32 operands of the products (T = s L dt for dx,
// the gradient of C.B^T for dB and dC, Dc for dx and dB, h_in for dC) enter
// as hi = bf16(v) and lo = bf16(v - hi), two mma.sync into one f32
// accumulator, as in ssd_bf16.cu: hi + lo carries 16 bits of v's mantissa.
// The decay is exp of the difference cum_q - cum_k, masked before the exp
// (cum falls to about -2,000 within a chunk at mamba2-780m's A), by __expf
// (the SFU's ex2 of a product with log2 e: relative error near 1e-6 for the
// differences whose decay is not negligible); the chunk input's and the
// carry's weights by expf, as the plain version.
//
// What bounds it on the H100.  At mamba2-780m's training shape (Bt 4, S 2048,
// H 48, P 64, G 1, N 128, chunk 256) the function must read x, dy, dt, cum,
// B, C, h_in, Dc and the chunk-end term and write dx, ddt, dB and dC: about
// 269 MB, 0.080 ms at 3.35 TB/s, against about 33 GFLOP of products (0.033 ms
// at 989 TFLOP/s).  This design issues about 36 M mma.sync m16n8k16, 148
// GFLOP, on the tensor cores (the hi + lo halves; C.B^T recomputed per head
// and side; dB's and dC's intra products per head) and reads x and dy three
// times, h_in and Dc twice.  What it does:
//   * a block per (batch * chunk, group, block of heads), 8 warps, one block
//     an SM; the chunk's 16-row strips are owned by warps, strip w in a
//     first round and strip 8 + w in a second;
//   * two key rounds, then two query rounds, each walking the block's heads.
//     In a key round a warp owns key strip j and sums over the queries
//     q >= k: dx_j of each head (in registers, written once in bf16 with the
//     chunk input's term and D dy), dB_j over all the block's heads (in
//     registers, written once), ddt's and cum's key shares.  Its products are
//     written transposed (rows = keys), so that T^T and the gradient of C.B^T
//     transposed are, element for element, the A fragments of T^T.dy and
//     (dCB)^T.C.  In a query round a warp owns query strip i and sums over
//     the keys k <= q: dC_i over all heads with the carry's term, and cum's
//     query share.  The flash backward splits dK/dV and dQ the same way;
//   * a key round keeps C of the chunk in shared memory, a query round B (the
//     operand every strip reads), and beside it the round's own strips of
//     B or C (the warps' A operands, 128 rows), each staged once a round;
//     a warp's strip of x (key rounds) or dy (query rounds) comes from
//     device memory into registers once a head, while the head's stage is
//     waited for;
//   * each head's dy (key rounds) or x (query rounds), cum and dt come by
//     cp.async into one of two stages while the previous head is computed;
//     its Dc or h_in (f32, as stored, one buffer) after the previous head's
//     terms that read it, waited for only before its own, so that it lands
//     during the head's intra term; Dc and h_in are split into hi and lo as
//     their B fragments are read;
//   * cum's gradient of every head of the block stays in shared memory across
//     the rounds; at the end a thread a head takes its reverse cumsum in
//     ssd_bwd.cu's order, adds A rc to ddt and writes ddt once.
// No float atomics: every output element is written by one thread, in one
// order, so the gradients are the same bits from run to run.  bf16 rows stay
// in shared memory in 16-byte chunks XOR-swizzled by the row (the layout of
// ssd_common.cuh, whose cp.async, ldmatrix and mma.sync helpers this source
// shares with ssd_bf16.cu); f32 Dc and h_in rows are padded by 4 floats, so that a warp's
// reads of their B fragments fall in distinct banks.  Rows past the chunk
// are zeros, so any chunk from 1 to 256 works; a head block never straddles
// a group.
//
// Layouts are the forward's: x, dy, dx (Bt, S, H, P); dt, cum, ddt (Bt, S,
// H); B, C (Bt, S, G, N); h_ins, dchunk_in (Bt, nc, H, P, N); end_term (Bt,
// nc, H); dB_part, dC_part (nhb, Bt, S, G, N); dA_part, dD_part (Bt, nc, H).
//
// The CPU emulation (tools/cuda_emu/cuda_emu.h) defines
// CUDA_EMU_TENSOR_CORES and its own cp.async, ldmatrix and mma.sync in place
// of ssd_common.cuh's, so that this kernel's C++ runs on the CPU
// (tests/test_torch_cuda_emu.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_CHUNK = 256;
constexpr int STRIPS = MAX_CHUNK / 16;  // 16-row strips of a chunk
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int ROUNDS = STRIPS / WARPS;  // strips a warp owns, one a round
constexpr int SMEM_LIMIT = 232448;      // bytes of shared memory a block can have

#include "ssd_common.cuh"

// The A fragments (hi and lo) of a 16 x 16 f32 tile held as the accumulators
// of its two 8-column n-tiles.
__device__ __forceinline__ void split_tile(const float (&c)[2][4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16(c[0][0], c[0][1], hi[0], lo[0]);
  split_bf16(c[0][2], c[0][3], hi[1], lo[1]);
  split_bf16(c[1][0], c[1][1], hi[2], lo[2]);
  split_bf16(c[1][2], c[1][3], hi[3], lo[3]);
}

template <int R, int C> __device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = 0.f;
}

// The A fragments of rows row0 .. row0 + 15 of a bf16 (rows, K) slice in
// device memory with row stride `stride`, zeros at or past row `valid`.
template <int K>
__device__ __forceinline__ void load_afrags(uint32_t (&r)[K / 16][4],
                                            const __nv_bfloat16* __restrict__ src, size_t stride,
                                            int row0, int valid, int lane) {
  const int ra = row0 + lane / 4, rb = ra + 8, c = 2 * (lane % 4);
  const __nv_bfloat16* pa = src + (size_t)ra * stride + c;
  const __nv_bfloat16* pb = src + (size_t)rb * stride + c;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    r[ks][0] = ra < valid ? *reinterpret_cast<const uint32_t*>(pa + 16 * ks) : 0u;
    r[ks][1] = rb < valid ? *reinterpret_cast<const uint32_t*>(pb + 16 * ks) : 0u;
    r[ks][2] = ra < valid ? *reinterpret_cast<const uint32_t*>(pa + 16 * ks + 8) : 0u;
    r[ks][3] = rb < valid ? *reinterpret_cast<const uint32_t*>(pb + 16 * ks + 8) : 0u;
  }
}

// The shared memory of a block: the chunk's C (key rounds) or B (query
// rounds); the warps' own strips of B (key rounds) or C (query rounds), the
// round's 128 rows; two stages, each one head's dy (key rounds) or x (query
// rounds) and its cum and dt; one head's Dc or h_in as f32 rows padded to
// N + 4; then, for every head of the block, cum's and ddt's gradients by
// row, and each strip's sum of w dw (the chunk-end term) and of dy . x (dD).
template <int P, int N> struct TcLayout {
  static constexpr int LDF = N + 4;  // floats a row of Dc or h_in
  static constexpr int FULL = MAX_CHUNK * N * 2;
  static constexpr int OWN = 16 * WARPS * N * 2;
  static constexpr int ROWS = MAX_CHUNK * P * 2;
  static constexpr int STAGE = ROWS + 2 * MAX_CHUNK * 4;
  static constexpr int F32 = P * LDF * 4;
  static constexpr int OWN_AT = FULL, STAGE_AT = OWN_AT + OWN, F32_AT = STAGE_AT + 2 * STAGE;
  static constexpr int SHARES_AT = F32_AT + F32;
  static constexpr int PER_HEAD = 2 * MAX_CHUNK * 4 + 2 * STRIPS * 4;
  static int smem(int head_block) { return SHARES_AT + head_block * PER_HEAD; }
  // the last phase keeps dt of the block's heads where the stages were
  static int max_head_block() { return 2 * STAGE / (MAX_CHUNK * 4); }
};

// One head's share arrays in shared memory.
struct Shares {
  float *dcum, *ddt, *wdw, *dd;
  __device__ Shares(unsigned char* base, int hh)
      : dcum(reinterpret_cast<float*>(base) + hh * (2 * MAX_CHUNK + 2 * STRIPS)),
        ddt(dcum + MAX_CHUNK), wdw(ddt + MAX_CHUNK), dd(wdw + STRIPS) {}
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const float* __restrict__ cum,
                        const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                        const float* __restrict__ Dv, const __nv_bfloat16* __restrict__ dy,
                        const float* __restrict__ h_ins, const float* __restrict__ dchunk_in,
                        const float* __restrict__ end_term, __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ dB_part,
                        float* __restrict__ dC_part, float* __restrict__ dA_part,
                        float* __restrict__ dD_part, int Bt, int nc, int H, int G, int chunk,
                        int head_block) {
  using L = TcLayout<P, N>;
  constexpr int WP = P / 8, WN = N / 8, LDF = L::LDF;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full_s = smem_addr(smem), own_s = full_s + L::OWN_AT;
  const float* const f32 = reinterpret_cast<const float*>(smem + L::F32_AT);
  unsigned char* const shares = smem + L::SHARES_AT;

  const int R = H / G, nhb = (R + head_block - 1) / head_block;
  const int hb = blockIdx.x % nhb, g = blockIdx.x / nhb % G;
  const size_t bc = blockIdx.x / nhb / G;  // b * nc + c
  const int h_first = g * R + hb * head_block, nh = min(head_block, R - hb * head_block);
  const size_t S = (size_t)nc * chunk;
  const size_t row0 = bc * chunk;  // the chunk's first row of (Bt * S)
  const int ns = (chunk + 15) / 16, rows = 16 * ns;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  const size_t gn = (size_t)G * N, hp = (size_t)H * P;
  const __nv_bfloat16* const Bg = Bm + row0 * gn + (size_t)g * N;  // row 0 of the chunk
  const __nv_bfloat16* const Cg = Cm + row0 * gn + (size_t)g * N;
  float* const dB_blk = dB_part + ((size_t)hb * Bt * S + row0) * gn + (size_t)g * N;
  float* const dC_blk = dC_part + ((size_t)hb * Bt * S + row0) * gn + (size_t)g * N;

  // One head's dy or x, cum and dt into stage `st`.
  auto stage_rows_of = [&](int hh, int st, bool key_round) {
    const uint32_t base = full_s + L::STAGE_AT + st * L::STAGE;
    const int h = h_first + hh;
    stage_rows<P, THREADS>(base, (key_round ? dy : x) + row0 * hp + (size_t)h * P, hp, chunk, rows);
    for (int k = threadIdx.x; k < rows; k += THREADS) {
      const bool ok = k < chunk;
      const size_t at = ok ? (row0 + k) * H + h : 0;
      cp_async4(base + L::ROWS + 4 * k, cum + at, ok);
      cp_async4(base + L::ROWS + 4 * (MAX_CHUNK + k), dt + at, ok);
    }
  };
  // One head's Dc (key rounds) or h_in (query rounds), f32, into its rows.
  auto stage_f32 = [&](int hh, bool key_round) {
    const float* f = (key_round ? dchunk_in : h_ins) + (bc * H + h_first + hh) * P * N;
    for (int i = threadIdx.x; i < P * N / 4; i += THREADS) {
      const int p = i / (N / 4), c4 = i % (N / 4);
      cp_async16(full_s + L::F32_AT + (p * LDF + 4 * c4) * 4, f + 4 * i, true);
    }
  };
  // The B fragments of 16 columns n0.. at k-step rows k0.. of the f32 [k][n]
  // tile (Dc or h_in stored [p][n]: the B operand of x.Dc and dy.h_in), as
  // hi and lo: regs 0, 1 the n-tile n0.., regs 2, 3 n0 + 8...
  auto f32_kn = [&](int k0, int n0, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* col = f32 + n0 + 8 * half + gq;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int k = k0 + 8 * kk + 2 * t;
        split_bf16(col[k * LDF], col[(k + 1) * LDF], hi[2 * half + kk], lo[2 * half + kk]);
      }
    }
  };
  // ... of the f32 [n][k] tile (Dc stored [p][n]: the B operand of B.Dc^T).
  auto f32_nk = [&](int k0, int n0, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* row = f32 + (n0 + 8 * half + gq) * LDF + k0 + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float2 v = *reinterpret_cast<const float2*>(row + 8 * kk);
        split_bf16(v.x, v.y, hi[2 * half + kk], lo[2 * half + kk]);
      }
    }
  };

#pragma unroll 1
  for (int round = 0; round < 2 * ROUNDS; ++round) {
    const int first = WARPS * 16 * (round % ROUNDS);  // the round's first row
    if (first >= chunk) continue;  // no strip of the round lies in the chunk
    const bool key_round = round < ROUNDS;
    const int strip = warp + WARPS * (round % ROUNDS);
    const bool live = strip < ns;
    const int s0 = 16 * strip;
    const int ra = s0 + gq, rb = ra + 8;  // the lane's rows of its strip
    const int own0 = 16 * warp;           // the warp's strip in the own tile
    // The full operand of the round, the warps' own strips, the first
    // head's rows (one group), and its f32 operand (a second).
    __syncthreads();  // the previous round no longer reads any of them
    const __nv_bfloat16* const full_src = key_round ? Cg : Bg;
    stage_rows<N, THREADS>(full_s, full_src, gn, chunk, rows);
    stage_rows<N, THREADS>(own_s, (key_round ? Bg : Cg) + first * gn, gn, chunk - first, 16 * WARPS);
    stage_rows_of(0, 0, key_round);
    cp_async_commit();
    stage_f32(0, key_round);
    cp_async_commit();
    uint32_t cur[P / 16][4];  // the warp's strip of x (key) or dy (query) of a head
    const __nv_bfloat16* const rows_src = key_round ? x : dy;
    float acc[N / 8][4];  // dB_j (key rounds) or dC_i (query rounds) over the heads
    zero(acc);

#pragma unroll 1
    for (int hh = 0; hh < nh; ++hh) {
      const int st = hh & 1, h = h_first + hh;
      load_afrags<P>(cur, rows_src + row0 * hp + (size_t)h * P, hp, s0, chunk, lane);
      if (hh + 1 < nh) {
        stage_rows_of(hh + 1, st ^ 1, key_round);
        cp_async_commit();
        cp_async_wait<2>();  // this head's rows (this head's f32 and the next rows may pend)
      } else {
        cp_async_wait<1>();
      }
      __syncthreads();
      const uint32_t rows_s = full_s + L::STAGE_AT + st * L::STAGE;
      const unsigned char* const stage = smem + L::STAGE_AT + st * L::STAGE;
      const float* const cum_s = reinterpret_cast<const float*>(stage + L::ROWS);
      const float* const dt_s = cum_s + MAX_CHUNK;
      const Shares sh(shares, hh);
      const float cum_a = cum_s[ra], cum_b = cum_s[rb];  // 0 past the chunk
      const float dt_a = dt_s[ra], dt_b = dt_s[rb];
      float dxa[P / 8][4];   // key rounds: dx_j of this head
      float sum2[2] = {0.f, 0.f};  // key: sum_q e_qk; query: sum_k e_qk dt_k (the lane's rows)

      if (live && key_round) {
        // Key strip j = strip, rows = keys ra, rb; products transposed
        // (columns = queries).
        zero(dxa);
#pragma unroll 1
        for (int i = strip; i < ns; ++i) {
          const int i0 = 16 * i;
          float sT[2][4], gT[2][4];  // (C_i B_j^T)^T and (dy_i x_j^T)^T
          zero(sT);
          zero(gT);
#pragma unroll
          for (int ks = 0; ks < N / 16; ++ks) {
            uint32_t a[4], b[4];
            ldmatrix_x4(a, own_s + row_pairs<WN>(own0, 2 * ks, lane));
            ldmatrix_x4(b, full_s + chunk_pairs<WN>(i0, 2 * ks, lane));
            mma_bf16(sT[0], a, b[0], b[1]);
            mma_bf16(sT[1], a, b[2], b[3]);
          }
#pragma unroll
          for (int ks = 0; ks < P / 16; ++ks) {
            uint32_t b[4];
            ldmatrix_x4(b, rows_s + chunk_pairs<WP>(i0, 2 * ks, lane));
            mma_bf16(gT[0], cur[ks], b[0], b[1]);
            mma_bf16(gT[1], cur[ks], b[2], b[3]);
          }
          float T[2][4], dcb[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int q = i0 + 8 * nt + 2 * t;
            const float2 cq = *reinterpret_cast<const float2*>(cum_s + q);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qe = q + (e & 1), k = e < 2 ? ra : rb;
              // masked before the exp: a masked difference is positive
              const float l = qe < chunk && k <= qe
                                  ? __expf(((e & 1) ? cq.y : cq.x) - (e < 2 ? cum_a : cum_b))
                                  : 0.f;
              const float dtk = e < 2 ? dt_a : dt_b;
              const float sl = sT[nt][e] * l, ev = sl * gT[nt][e];
              T[nt][e] = sl * dtk;
              dcb[nt][e] = l * dtk * gT[nt][e];
              sum2[e >> 1] += ev;
            }
          }
          uint32_t hi[4], lo[4];
          split_tile(T, hi, lo);  // dx_j += T^T dy_i (dy stored [q][p]: .trans)
#pragma unroll
          for (int pp = 0; pp < P / 16; ++pp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, rows_s + row_pairs<WP>(i0, 2 * pp, lane));
            mma_split(dxa[2 * pp], hi, lo, b[0], b[1]);
            mma_split(dxa[2 * pp + 1], hi, lo, b[2], b[3]);
          }
          split_tile(dcb, hi, lo);  // dB_j += dCB^T C_i (C stored [q][n]: .trans)
#pragma unroll
          for (int nn = 0; nn < N / 16; ++nn) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, full_s + row_pairs<WN>(i0, 2 * nn, lane));
            mma_split(acc[2 * nn], hi, lo, b[0], b[1]);
            mma_split(acc[2 * nn + 1], hi, lo, b[2], b[3]);
          }
        }
      } else if (live) {
        // Query strip i = strip, rows = queries ra, rb.
#pragma unroll 1
        for (int j = 0; j <= strip; ++j) {
          const int j0 = 16 * j;
          float sq[2][4], gm[2][4];  // C_i B_j^T and dy_i x_j^T
          zero(sq);
          zero(gm);
#pragma unroll
          for (int ks = 0; ks < N / 16; ++ks) {
            uint32_t a[4], b[4];
            ldmatrix_x4(a, own_s + row_pairs<WN>(own0, 2 * ks, lane));
            ldmatrix_x4(b, full_s + chunk_pairs<WN>(j0, 2 * ks, lane));
            mma_bf16(sq[0], a, b[0], b[1]);
            mma_bf16(sq[1], a, b[2], b[3]);
          }
#pragma unroll
          for (int ks = 0; ks < P / 16; ++ks) {
            uint32_t b[4];
            ldmatrix_x4(b, rows_s + chunk_pairs<WP>(j0, 2 * ks, lane));
            mma_bf16(gm[0], cur[ks], b[0], b[1]);
            mma_bf16(gm[1], cur[ks], b[2], b[3]);
          }
          float dcb[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int k = j0 + 8 * nt + 2 * t;
            const float2 ck = *reinterpret_cast<const float2*>(cum_s + k);
            const float2 tk = *reinterpret_cast<const float2*>(dt_s + k);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ke = k + (e & 1), q = e < 2 ? ra : rb;
              const float l = q < chunk && ke <= q
                                  ? __expf((e < 2 ? cum_a : cum_b) - ((e & 1) ? ck.y : ck.x))
                                  : 0.f;
              const float dtk = (e & 1) ? tk.y : tk.x;
              const float ev = sq[nt][e] * l * gm[nt][e];
              sum2[e >> 1] += ev * dtk;
              dcb[nt][e] = l * dtk * gm[nt][e];
            }
          }
          uint32_t hi[4], lo[4];
          split_tile(dcb, hi, lo);  // dC_i += dCB B_j (B stored [k][n]: .trans)
#pragma unroll
          for (int nn = 0; nn < N / 16; ++nn) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, full_s + row_pairs<WN>(j0, 2 * nn, lane));
            mma_split(acc[2 * nn], hi, lo, b[0], b[1]);
            mma_split(acc[2 * nn + 1], hi, lo, b[2], b[3]);
          }
        }
      }
      // This head's f32 operand (the other group may pend).
      if (hh + 1 < nh) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();

      if (live && key_round) {
        // The chunk input's terms: U = B_j Dc^T, P-piece by P-piece, into dx
        // (w U) and dw = x_j . U; dB_j += w (x_j Dc), N-piece by N-piece.
        const float cum_end = cum_s[chunk - 1];
        const float dec_a = ra < chunk ? expf(cum_end - cum_a) : 0.f;
        const float dec_b = rb < chunk ? expf(cum_end - cum_b) : 0.f;
        const float w_a = dt_a * dec_a, w_b = dt_b * dec_b;
        float dw[2] = {0.f, 0.f};
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {
          float u[2][4];
          zero(u);
#pragma unroll
          for (int ks = 0; ks < N / 16; ++ks) {
            uint32_t a[4], hi[4], lo[4];
            ldmatrix_x4(a, own_s + row_pairs<WN>(own0, 2 * ks, lane));
            f32_nk(16 * ks, 16 * pp, hi, lo);
            mma_bf16(u[0], a, hi[0], hi[1]);
            mma_bf16(u[0], a, lo[0], lo[1]);
            mma_bf16(u[1], a, hi[2], hi[3]);
            mma_bf16(u[1], a, lo[2], lo[3]);
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* d = dxa[2 * pp + half];
            const uint32_t xa = cur[pp][2 * half], xb = cur[pp][2 * half + 1];
            d[0] += w_a * u[half][0];
            d[1] += w_a * u[half][1];
            d[2] += w_b * u[half][2];
            d[3] += w_b * u[half][3];
            dw[0] += bf16_low(xa) * u[half][0] + bf16_high(xa) * u[half][1];
            dw[1] += bf16_low(xb) * u[half][2] + bf16_high(xb) * u[half][3];
          }
        }
#pragma unroll
        for (int nn = 0; nn < N / 16; ++nn) {
          float v[2][4];
          zero(v);
#pragma unroll
          for (int ks = 0; ks < P / 16; ++ks) {
            uint32_t hi[4], lo[4];
            f32_kn(16 * ks, 16 * nn, hi, lo);
            mma_bf16(v[0], cur[ks], hi[0], hi[1]);
            mma_bf16(v[0], cur[ks], lo[0], lo[1]);
            mma_bf16(v[1], cur[ks], hi[2], hi[3]);
            mma_bf16(v[1], cur[ks], lo[2], lo[3]);
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* d = acc[2 * nn + half];
            d[0] += w_a * v[half][0];
            d[1] += w_a * v[half][1];
            d[2] += w_b * v[half][2];
            d[3] += w_b * v[half][3];
          }
        }
        // D dy, dD's share, and dx written once.
        const float Dh = Dv[h];
        float dd = 0.f;
        __nv_bfloat16* const out = dx + row0 * hp + (size_t)h * P;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const uint32_t xa = cur[nt / 2][2 * (nt % 2)], xb = cur[nt / 2][2 * (nt % 2) + 1];
          uint32_t ya, yb;
          memcpy(&ya, stage + swizzle<WP>(ra, nt) + 4 * t, sizeof(ya));
          memcpy(&yb, stage + swizzle<WP>(rb, nt) + 4 * t, sizeof(yb));
          const float* d = dxa[nt];
          dd += bf16_low(ya) * bf16_low(xa) + bf16_high(ya) * bf16_high(xa) +
                bf16_low(yb) * bf16_low(xb) + bf16_high(yb) * bf16_high(xb);
          if (ra < chunk)
            *reinterpret_cast<uint32_t*>(out + (size_t)ra * hp + 8 * nt + 2 * t) =
                pack_bf16(d[0] + Dh * bf16_low(ya), d[1] + Dh * bf16_high(ya));
          if (rb < chunk)
            *reinterpret_cast<uint32_t*>(out + (size_t)rb * hp + 8 * nt + 2 * t) =
                pack_bf16(d[2] + Dh * bf16_low(yb), d[3] + Dh * bf16_high(yb));
        }
        // The key shares: over the quad's four lanes, then each key's by the
        // lane with t = 0; w dw and dy . x of the strip by lane 0.
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          sum2[0] += __shfl_xor_sync(0xffffffffu, sum2[0], m);
          sum2[1] += __shfl_xor_sync(0xffffffffu, sum2[1], m);
          dw[0] += __shfl_xor_sync(0xffffffffu, dw[0], m);
          dw[1] += __shfl_xor_sync(0xffffffffu, dw[1], m);
        }
        float wdw = 0.f;
        if (t == 0) {
          if (ra < chunk) {
            sh.ddt[ra] = sum2[0] + dec_a * dw[0];
            sh.dcum[ra] = -dt_a * sum2[0] - w_a * dw[0];
          }
          if (rb < chunk) {
            sh.ddt[rb] = sum2[1] + dec_b * dw[1];
            sh.dcum[rb] = -dt_b * sum2[1] - w_b * dw[1];
          }
          wdw = w_a * dw[0] + w_b * dw[1];
        }
#pragma unroll
        for (int m = 16; m >= 1; m >>= 1) {
          wdw += __shfl_xor_sync(0xffffffffu, wdw, m);
          dd += __shfl_xor_sync(0xffffffffu, dd, m);
        }
        if (lane == 0) {
          sh.wdw[strip] = wdw;
          sh.dd[strip] = dd;
        }
      } else if (live) {
        // The carry: dC_i += e_q (dy_i h_in^T), N-piece by N-piece, and
        // C_q . (dy_i h_in^T)_q for cum's gradient.
        const float e_a = ra < chunk ? expf(cum_a) : 0.f;
        const float e_b = rb < chunk ? expf(cum_b) : 0.f;
        float cdot[2] = {0.f, 0.f};
#pragma unroll
        for (int nn = 0; nn < N / 16; ++nn) {
          float y[2][4];
          zero(y);
#pragma unroll
          for (int ks = 0; ks < P / 16; ++ks) {
            uint32_t hi[4], lo[4];
            f32_kn(16 * ks, 16 * nn, hi, lo);
            mma_bf16(y[0], cur[ks], hi[0], hi[1]);
            mma_bf16(y[0], cur[ks], lo[0], lo[1]);
            mma_bf16(y[1], cur[ks], hi[2], hi[3]);
            mma_bf16(y[1], cur[ks], lo[2], lo[3]);
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* d = acc[2 * nn + half];
            uint32_t ca, cb;  // C_q at the n-tile's two columns of the lane
            memcpy(&ca, smem + L::OWN_AT + swizzle<WN>(own0 + gq, 2 * nn + half) + 4 * t, 4);
            memcpy(&cb, smem + L::OWN_AT + swizzle<WN>(own0 + gq + 8, 2 * nn + half) + 4 * t, 4);
            d[0] += e_a * y[half][0];
            d[1] += e_a * y[half][1];
            d[2] += e_b * y[half][2];
            d[3] += e_b * y[half][3];
            cdot[0] += bf16_low(ca) * y[half][0] + bf16_high(ca) * y[half][1];
            cdot[1] += bf16_low(cb) * y[half][2] + bf16_high(cb) * y[half][3];
          }
        }
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          sum2[0] += __shfl_xor_sync(0xffffffffu, sum2[0], m);
          sum2[1] += __shfl_xor_sync(0xffffffffu, sum2[1], m);
          cdot[0] += __shfl_xor_sync(0xffffffffu, cdot[0], m);
          cdot[1] += __shfl_xor_sync(0xffffffffu, cdot[1], m);
        }
        if (t == 0) {  // after the key rounds' shares of the same rows
          if (ra < chunk) sh.dcum[ra] += sum2[0] + e_a * cdot[0];
          if (rb < chunk) sh.dcum[rb] += sum2[1] + e_b * cdot[1];
        }
      }
      __syncthreads();  // the stage and the f32 rows are free again
      if (hh + 1 < nh) {
        stage_f32(hh + 1, key_round);
        cp_async_commit();
      }
    }
    // dB_j or dC_i of the block's heads, written once.
    if (live) {
      float* const out = key_round ? dB_blk : dC_blk;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        const int col = 8 * nt + 2 * t;
        if (ra < chunk)
          *reinterpret_cast<float2*>(out + (size_t)ra * gn + col) =
              make_float2(acc[nt][0], acc[nt][1]);
        if (rb < chunk)
          *reinterpret_cast<float2*>(out + (size_t)rb * gn + col) =
              make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }

  // cum's gradient: the chunk-end terms, then the reverse cumsum (ssd_bwd.cu's
  // order); dt of the block's heads into the first stage.
  __syncthreads();
  float* const dt_all = reinterpret_cast<float*>(smem + L::STAGE_AT);  // [nh][MAX_CHUNK]
  for (int e = threadIdx.x; e < nh * chunk; e += THREADS) {
    const int hh = e % nh, r = e / nh;
    dt_all[hh * MAX_CHUNK + r] = dt[(row0 + r) * H + h_first + hh];
  }
  __syncthreads();
  if ((int)threadIdx.x < nh) {
    const int hh = threadIdx.x, h = h_first + hh;
    const Shares sh(shares, hh);
    float wdw = 0.f, d = 0.f;
    for (int s = 0; s < ns; ++s) {
      wdw += sh.wdw[s];
      d += sh.dd[s];
    }
    sh.dcum[chunk - 1] += wdw + end_term[bc * H + h];
    const float Ah = A[h];
    const float* dt_h = dt_all + hh * MAX_CHUNK;
    float rc = 0.f, da = 0.f;
    for (int r = chunk - 1; r >= 0; --r) {
      rc += sh.dcum[r];
      sh.ddt[r] += Ah * rc;
      da += dt_h[r] * rc;
    }
    dA_part[bc * H + h] = da;
    dD_part[bc * H + h] = d;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nh * chunk; e += THREADS) {
    const int hh = e % nh, r = e / nh;
    ddt[(row0 + r) * H + h_first + hh] = Shares(shares, hh).ddt[r];
  }
}

template <int P, int N>
int launch_chunk_tc(const void* x, const void* dt, const void* A, const void* cum, const void* B,
                    const void* C, const void* D, const void* dy, const void* h_ins,
                    const void* dchunk_in, const void* end_term, void* dx, void* ddt,
                    void* dB_part, void* dC_part, void* dA_part, void* dD_part, int Bt, int S,
                    int H, int G, int chunk, int head_block, cudaStream_t stream) {
  using L = TcLayout<P, N>;
  auto kernel = ssd_bwd_chunk_tc_kernel<P, N>;
  const int smem = L::smem(head_block);
  if (smem > SMEM_LIMIT || head_block > L::max_head_block()) return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)Bt * (S / chunk) * G * ((H / G + head_block - 1) / head_block);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(cum),
      static_cast<const __nv_bfloat16*>(B), static_cast<const __nv_bfloat16*>(C),
      static_cast<const float*>(D), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const float*>(h_ins), static_cast<const float*>(dchunk_in),
      static_cast<const float*>(end_term), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dA_part), static_cast<float*>(dD_part), Bt, S / chunk, H, G, chunk,
      head_block);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  The caller has checked shapes, types (x, B, C, dy, dx bf16; the
// rest f32), contiguity, 16-byte alignment and the device; (P, N) is one of
// (16, 16), (16, 32), (32, 16), (64, 128).  dB_part and dC_part are
// (ceil(H / G / head_block), Bt, S, G, N), dA_part and dD_part (Bt, nc, H);
// head_block >= 1 and small enough for the shared memory (TcLayout).
extern "C" int ssd_bwd_chunk_tc(const void* x, const void* dt, const void* A, const void* cum,
                                const void* B, const void* C, const void* D, const void* dy,
                                const void* h_ins, const void* dchunk_in, const void* end_term,
                                void* dx, void* ddt, void* dB_part, void* dC_part,
                                void* dA_part, void* dD_part, int Bt, int S, int H, int G, int P,
                                int N, int chunk, int head_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Bt < 1 || chunk < 1 || chunk > MAX_CHUNK || S < chunk || S % chunk != 0 || G < 1 ||
      H % G != 0 || head_block < 1)
    return (int)cudaErrorInvalidValue;
#define CHUNK_TC(p, n)                                                                        \
  if (P == p && N == n)                                                                       \
    return launch_chunk_tc<p, n>(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end_term, dx, \
                                 ddt, dB_part, dC_part, dA_part, dD_part, Bt, S, H, G, chunk, \
                                 head_block, st);
  CHUNK_TC(16, 16) CHUNK_TC(16, 32) CHUNK_TC(32, 16) CHUNK_TC(64, 128)
#undef CHUNK_TC
  return (int)cudaErrorInvalidValue;
}

// Registers, local bytes (spills and stack) and shared bytes (static plus
// dynamic at head_block) of ssd_bwd_chunk_tc_kernel at (P, N); returns a
// CUDA error code (0 on success).
extern "C" int ssd_bwd_tc_attributes(int P, int N, int head_block, int* regs, int* local_bytes,
                                     int* smem_bytes) {
  cudaFuncAttributes attr;
  int dynamic_smem = 0, err = (int)cudaErrorInvalidValue;
#define ATTR_TC(p, n)                                                                  \
  if (P == p && N == n) {                                                              \
    dynamic_smem = TcLayout<p, n>::smem(head_block);                                   \
    err = (int)cudaFuncGetAttributes(&attr, ssd_bwd_chunk_tc_kernel<p, n>);            \
  }
  ATTR_TC(16, 16) ATTR_TC(16, 32) ATTR_TC(32, 16) ATTR_TC(64, 128)
#undef ATTR_TC
  if (err) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes + dynamic_smem;
  return 0;
}
