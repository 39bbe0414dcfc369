// The gradient of the Mamba2 SSD for Hopper (sm_90a), f32 arithmetic on the
// CUDA cores, x, B, C and dy in f32 or bf16.  The TPU has no kernel for it:
// the JAX package differentiates the jnp path of `ssd_chunk_pallas`
// (src/repro/kernels/ssd_scan/kernel.py) and of its state passing.  Three
// kernels, in the split of the published Mamba2 backward, per chunk c of
// Q = chunk rows, rows q >= k of the chunk, L_qk = exp(cum_q - cum_k),
// s_qk = C_q . B_k, w_k = exp(cum_end - cum_k) dt_k:
//
//   ssd_bwd_dstate:     dS_c = sum_q exp(cum_q) dy_q (outer) C_q, the gradient
//                       of the chunk's incoming state through its carry, a block
//                       per (batch * chunk, head);
//   ssd_bwd_state_pass: the reverse scan dh_in[c] = dS_c + exp(cum_end[c])
//                       dh_in[c + 1] from dh_in[nc] = dh_final, four state
//                       elements a thread (as ssd_state_pass), writing dchunk_in
//                       = dh_in[c + 1], dh0 = dh_in[0], and the partial sums of
//                       exp(cum_end[c]) <h_in[c], dh_in[c + 1]> a block covers;
//   ssd_bwd_chunk:      dx, ddt, dB and dC of one chunk for a block of heads of
//                       one group: the intra term's, the chunk input's and the
//                       carry's parts, then cum's gradient, its reverse cumsum
//                       (the gradient of A.dt) into ddt, with per-block partials
//                       of dA and dD.
//
// No float atomics: every output element is written by one thread, in one
// order, so the gradients are the same bits from run to run.  dB and dC are
// summed over the block's heads inside the block (through the gradient of
// C.B^T, dCB_qk = sum_h L_qk dt_k (dy_q . x_k), formed once per block and
// multiplied by B and C once, not per head), and the blocks' partials, one per
// head block, are summed by PyTorch; so are the partials of dA, dD and the
// chunk-end term.
//
// What bounds them on the H100.  At mamba2-780m's training shape (Bt 4, S
// 2048, H 48, P 64, G 1, N 128, chunk 256) the whole gradient must read x, dy,
// dt, cum, B, C and h_ins and write dx, ddt, dB and dC: about 214 MB, 0.064
// ms at 3.35 TB/s.  Its products are about 33 GFLOP (per head and chunk the
// causal dy.x^T and T^T.dy, Q^2 P / 2 each, and three Q P N products against
// h_in and dchunk_in; per head block C.B^T and dCB against B and C), 0.49 ms
// at the f32 rate of the CUDA cores (67 TFLOP/s), 0.033 ms at the bf16 rate of
// the tensor cores.  These kernels are the simple design: every product is a
// block-wide tile product from shared memory, 256 threads on a 16 x 16 grid,
// each with a strided micro-tile of outputs in registers (rows ty + 16 i,
// columns tx + 16 j), rows of a chunk in tiles of KT = 32; the tensor cores
// (the hi + lo bf16 operands of ssd_bf16.cu) are later work.
//
// Layouts are those of the forward: x, dy, dx (Bt, S, H, P); dt, cum, ddt
// (Bt, S, H); B, C (Bt, S, G, N); h_ins, dS, dchunk_in (Bt, nc, H, P, N);
// h0, dh0, dh_final (Bt, H, P, N).  Any chunk from 1 to 256 (the last row
// tile of a chunk is masked), S a multiple of it, and (P, N) one of (16, 16),
// (16, 32), (32, 16), (64, 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid: tx = tid % 16, ty = tid / 16
constexpr int KT = 32;        // rows of a chunk per tile
constexpr int MAX_CHUNK = 256;
constexpr int MAX_HEAD_BLOCK = 4;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// acc[i][j] += sum_{k < K} A(ty + 16 i, k) B(k, tx + 16 j), with
// A(r, k) = A[r * a_r + k * a_k] and B(k, c) = B[k * b_k + c * b_c] in shared
// memory.  The k loop is unrolled 4 times, 2 for the widest outputs: with 4
// there too, ssd_bwd_chunk's f32 instantiation at (64, 128) spills 8 bytes
// at its 128 registers (tools/ssd_bwd_tune.py).
template <int MR, int NR>
__device__ __forceinline__ void mm(float (&acc)[MR][NR], const float* A, int a_r, int a_k,
                                   const float* B, int b_k, int b_c, int K, int ty, int tx) {
  constexpr int UNROLL = MR * NR >= 16 ? 2 : 4;
#pragma unroll UNROLL
  for (int k = 0; k < K; ++k) {
    float a[MR], b[NR];
#pragma unroll
    for (int i = 0; i < MR; ++i) a[i] = A[(ty + 16 * i) * a_r + k * a_k];
#pragma unroll
    for (int j = 0; j < NR; ++j) b[j] = B[k * b_k + (tx + 16 * j) * b_c];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int MR, int NR>
__device__ __forceinline__ void zero(float (&acc)[MR][NR]) {
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[i][j] = 0.f;
}

// The sum over the 16 lanes of a half-warp (the threads of one ty), in every
// one of them.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// rows [row0, row0 + KT) of a (rows, width) slice with row stride `stride`
// into shared memory with leading dimension ld, as f32; rows at or past
// `valid` are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src,
                                          size_t stride, int width, int valid, int tid) {
  for (int e = tid; e < KT * width; e += THREADS) {
    const int r = e / width, c = e % width;
    dst[r * ld + c] = r < valid ? to_f32(src[(size_t)r * stride + c]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// ssd_bwd_dstate: dS = sum_q exp(cum_q) dy_q (outer) C_q for one (batch *
// chunk, head), P x N outputs, the chunk's rows in tiles of KT.

template <int P, int N, typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dstate_kernel(const T* __restrict__ dy, const float* __restrict__ cum,
                      const T* __restrict__ C, float* __restrict__ dS, int nc, int H, int G,
                      int chunk) {
  __shared__ float s_dy[KT][P + 1];
  __shared__ float s_c[KT][N];
  __shared__ float s_e[KT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bc = blockIdx.x / H, h = blockIdx.x % H;
  const int b = bc / nc, c = bc % nc, g = h / (H / G);
  const size_t S = (size_t)nc * chunk;
  const size_t t0 = (size_t)b * S + (size_t)c * chunk;  // first row of the chunk
  float acc[P / 16][N / 16];
  zero(acc);
  for (int q0 = 0; q0 < chunk; q0 += KT) {
    const int valid = min(KT, chunk - q0);
    if (tid < KT) s_e[tid] = tid < valid ? expf(cum[(t0 + q0 + tid) * H + h]) : 0.f;
    __syncthreads();
    for (int e = tid; e < KT * P; e += THREADS) {
      const int r = e / P, p = e % P;
      s_dy[r][p] = r < valid ? to_f32(dy[((t0 + q0 + r) * H + h) * P + p]) * s_e[r] : 0.f;
    }
    load_rows(&s_c[0][0], N, C + ((t0 + q0) * G + g) * N, (size_t)G * N, N, valid, tid);
    __syncthreads();
    mm(acc, &s_dy[0][0], 1, P + 1, &s_c[0][0], N, 1, valid, ty, tx);
    __syncthreads();
  }
  float* out = dS + ((size_t)bc * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < P / 16; ++i)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) out[(ty + 16 * i) * N + tx + 16 * j] = acc[i][j];
}

// ---------------------------------------------------------------------------
// ssd_bwd_state_pass: the reverse recurrence over the chunks, four state
// elements a thread, a block per (batch * head, part of P * N); the multiply
// and the add round separately, as in the plain version.

constexpr int PASS_THREADS = 256;

__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_state_pass_kernel(const float4* __restrict__ dS, const float* __restrict__ cum,
                          const float4* __restrict__ h_ins, const float4* __restrict__ dh_final,
                          float4* __restrict__ dchunk_in, float4* __restrict__ dh0,
                          float* __restrict__ end_part, int nc, int H, int PN4, int chunk) {
  __shared__ float red[PASS_THREADS / 32];
  const int tid = threadIdx.x, parts = gridDim.y, part = blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int e = part * PASS_THREADS + tid;
  const bool active = e < PN4;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active && dh_final) g = dh_final[(size_t)bh * PN4 + e];
  for (int c = nc - 1; c >= 0; --c) {
    const size_t o = (((size_t)b * nc + c) * H + h) * PN4 + e;
    const float d = expf(cum[(((size_t)b * nc + c) * chunk + chunk - 1) * H + h]);
    float dot = 0.f;
    if (active) {
      dchunk_in[o] = g;  // dh_in[c + 1]
      const float4 hi = h_ins[o];
      dot = hi.x * g.x + hi.y * g.y + hi.z * g.z + hi.w * g.w;
      const float4 v = dS[o];
      g.x = __fadd_rn(v.x, __fmul_rn(d, g.x));
      g.y = __fadd_rn(v.y, __fmul_rn(d, g.y));
      g.z = __fadd_rn(v.z, __fmul_rn(d, g.z));
      g.w = __fadd_rn(v.w, __fmul_rn(d, g.w));
    }
    dot = sum32(dot);
    if (tid % 32 == 0) red[tid / 32] = dot;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < PASS_THREADS / 32; ++w) s += red[w];
      end_part[(((size_t)b * nc + c) * H + h) * parts + part] = d * s;
    }
    __syncthreads();
  }
  if (active) dh0[(size_t)bh * PN4 + e] = g;
}

// ---------------------------------------------------------------------------
// ssd_bwd_chunk: the gradients of one chunk for a block of heads of one
// group.  For each key tile j of the chunk:
//   1. for each query tile i >= j: s = C_i B_j^T once; for each head, the
//      causal dy_i x_j^T, from which the scores' share of ddt and of cum's
//      gradient, dCB (summed over the heads) and dx_j += T^T dy_i
//      (T = s L dt_k, the forward's scores); then dC_i += dCB B_j and
//      dB_j += dCB^T C_i;
//   2. for each head, against dchunk_in and h_in (N in pieces of NCH):
//      dx_j += w (B_j dchunk_in^T) + D dy_j, dB_j += w (x_j dchunk_in),
//      dC_j += exp(cum) (dy_j h_in), and their shares of ddt and cum's
//      gradient;
// then cum's gradient, its reverse cumsum within the chunk, ddt += A . that.
// dC is summed in the block's own partial in device memory, dB in registers
// over the query tiles and then in that partial (each element by one thread,
// in one order; in registers across both steps it would spill at 128), dx in
// shared memory.

template <int P, int N>
struct ChunkSmem {
  static constexpr int LDB = N + 1, LDC = N + 1, LDX = P + 1, LDY = P + 1, LDT = KT + 1;
  static constexpr int NCH = N < 32 ? N : 32, LDD = NCH + 1;
  static constexpr int TILE = KT * LDT;
  // offsets in floats
  static constexpr int B_ = 0, C_ = B_ + KT * LDB, X_ = C_ + KT * LDC, Y_ = X_ + KT * LDX,
                       S_ = Y_ + KT * LDY, CB_ = S_ + TILE, T_ = CB_ + TILE, E_ = T_ + TILE,
                       DX_ = E_ + TILE, ROW_ = DX_ + MAX_HEAD_BLOCK * KT * P,
                       DCUM_ = ROW_ + 4 * KT, DDT_ = DCUM_ + MAX_HEAD_BLOCK * MAX_CHUNK,
                       WDW_ = DDT_ + MAX_HEAD_BLOCK * MAX_CHUNK,
                       RED_ = WDW_ + MAX_HEAD_BLOCK * MAX_CHUNK,
                       END_ = RED_ + WARPS * MAX_HEAD_BLOCK;
  static constexpr int BYTES = END_ * 4;
  // phase 2 holds a piece of dchunk_in and of h_in where the four tiles were
  static_assert(2 * P * LDD <= 4 * TILE, "dchunk_in and h_in pieces must fit");
  // phase 3 keeps dt where the dx accumulators were
  static_assert(MAX_HEAD_BLOCK * MAX_CHUNK <= MAX_HEAD_BLOCK * KT * P,
                "phase 3 scratch must fit");
};

// Two blocks an SM (their shared memory allows two), so up to 128 registers
// a thread.
template <int P, int N, typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ cum,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const float* __restrict__ Dv, const T* __restrict__ dy,
                     const float* __restrict__ h_ins, const float* __restrict__ dchunk_in,
                     const float* __restrict__ end_term, T* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dB_part,
                     float* __restrict__ dC_part, float* __restrict__ dA_part,
                     float* __restrict__ dD_part, int Bt, int nc, int H, int G, int chunk,
                     int head_block) {
  using L = ChunkSmem<P, N>;
  constexpr int NCH = L::NCH, LDD = L::LDD, LDT = L::LDT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* sB = smem + L::B_;
  float* sC = smem + L::C_;
  float* sX = smem + L::X_;
  float* sY = smem + L::Y_;
  float* sS = smem + L::S_;
  float* sCB = smem + L::CB_;
  float* sT = smem + L::T_;
  float* sE = smem + L::E_;
  float* sDX = smem + L::DX_;
  float* sCum_i = smem + L::ROW_;  // phase 1: cum of the query rows
  float* sDt_j = sCum_i + KT;      // dt and cum of the key rows
  float* sCum_j = sDt_j + KT;
  float* sW = sCum_i;              // phase 2: w_k, exp(cum_end - cum_k), exp(cum_k)
  float* sDecay = sDt_j;
  float* sEcum = sCum_j;
  float* sDcum = smem + L::DCUM_;
  float* sDdt = smem + L::DDT_;
  float* sWdw = smem + L::WDW_;
  float* sRed = smem + L::RED_;  // (WARPS, head_block): each warp's share of dD
  float* sDc = sS;              // phase 2: a piece of dchunk_in, (P, NCH)
  float* sHin = sS + P * LDD;   // and of h_in

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int R = H / G, nhb = (R + head_block - 1) / head_block;
  const int bc = blockIdx.x / (G * nhb), g = (blockIdx.x / nhb) % G, hb = blockIdx.x % nhb;
  const int b = bc / nc, c = bc % nc;
  const int h_first = g * R + hb * head_block, nh = min(head_block, R - hb * head_block);
  const size_t S = (size_t)nc * chunk;
  const size_t t0 = (size_t)b * S + (size_t)c * chunk;  // the chunk's first row
  const int nt = (chunk + KT - 1) / KT;
  float* dC_blk = dC_part + ((size_t)hb * Bt * S + t0) * G * N + (size_t)g * N;
  float* dB_blk = dB_part + ((size_t)hb * Bt * S + t0) * G * N + (size_t)g * N;
  const size_t row_gn = (size_t)G * N;  // row stride of B, C, dB, dC

  for (int e = tid; e < MAX_HEAD_BLOCK * MAX_CHUNK; e += THREADS) {
    sDcum[e] = 0.f;
    sDdt[e] = 0.f;
    sWdw[e] = 0.f;
  }
  if (tid < WARPS * MAX_HEAD_BLOCK) sRed[tid] = 0.f;

  for (int j = 0; j < nt; ++j) {
    const int k0 = j * KT, kvalid = min(KT, chunk - k0);
    load_rows(sB, L::LDB, Bm + (t0 + k0) * row_gn + (size_t)g * N, row_gn, N, kvalid, tid);
    for (int e = tid; e < MAX_HEAD_BLOCK * KT * P; e += THREADS) sDX[e] = 0.f;
    float dBacc[KT / 16][N / 16];
    zero(dBacc);

    // 1. the intra-chunk term, query tiles i >= j
    for (int i = j; i < nt; ++i) {
      const int q0 = i * KT, qvalid = min(KT, chunk - q0);
      load_rows(sC, L::LDC, Cm + (t0 + q0) * row_gn + (size_t)g * N, row_gn, N, qvalid, tid);
      __syncthreads();
      {
        float s[KT / 16][KT / 16];
        zero(s);
        mm(s, sC, L::LDC, 1, sB, 1, L::LDB, N, ty, tx);  // s_qk = C_q . B_k
#pragma unroll
        for (int a = 0; a < KT / 16; ++a)
#pragma unroll
          for (int bb = 0; bb < KT / 16; ++bb) sS[(ty + 16 * a) * LDT + tx + 16 * bb] = s[a][bb];
      }  // each thread reads back only the elements it wrote
      for (int hh = 0; hh < nh; ++hh) {
        const int h = h_first + hh;
        load_rows(sX, L::LDX, x + ((t0 + k0) * H + h) * P, (size_t)H * P, P, kvalid, tid);
        load_rows(sY, L::LDY, dy + ((t0 + q0) * H + h) * P, (size_t)H * P, P, qvalid, tid);
        if (tid < KT) {
          sCum_i[tid] = tid < qvalid ? cum[(t0 + q0 + tid) * H + h] : 0.f;
        } else if (tid < 2 * KT) {
          const int r = tid - KT;
          sDt_j[r] = r < kvalid ? dt[(t0 + k0 + r) * H + h] : 0.f;
          sCum_j[r] = r < kvalid ? cum[(t0 + k0 + r) * H + h] : 0.f;
        }
        __syncthreads();
        float gm[KT / 16][KT / 16];  // dy_q . x_k
        zero(gm);
        mm(gm, sY, L::LDY, 1, sX, 1, L::LDX, P, ty, tx);
#pragma unroll
        for (int a = 0; a < KT / 16; ++a)
#pragma unroll
          for (int bb = 0; bb < KT / 16; ++bb) {
            const int r = ty + 16 * a, cc = tx + 16 * bb;
            const bool valid = r < qvalid && cc < kvalid && k0 + cc <= q0 + r;
            // masked before the exp: a masked difference is positive
            const float l = valid ? expf(sCum_i[r] - sCum_j[cc]) : 0.f;
            const float sl = sS[r * LDT + cc] * l, ldt = l * sDt_j[cc];
            sE[r * LDT + cc] = sl * gm[a][bb];
            sT[r * LDT + cc] = sl * sDt_j[cc];
            sCB[r * LDT + cc] = (hh == 0 ? 0.f : sCB[r * LDT + cc]) + ldt * gm[a][bb];
          }
        __syncthreads();
        float dxa[KT / 16][P / 16];  // dx_k += sum_q T_qk dy_q
        zero(dxa);
        mm(dxa, sT, 1, LDT, sY, L::LDY, 1, qvalid, ty, tx);
        float* dxh = sDX + hh * KT * P;
#pragma unroll
        for (int a = 0; a < KT / 16; ++a)
#pragma unroll
          for (int bb = 0; bb < P / 16; ++bb) dxh[(ty + 16 * a) * P + tx + 16 * bb] += dxa[a][bb];
        if (tid < KT) {
          // row q: cum_q's share, sum_k dt_k E_qk; column k: ddt_k's share,
          // sum_q E_qk, and cum_k's, -dt_k times it (the same thread takes
          // row and column tid, so a diagonal tile's element is updated in
          // one order)
          float rs = 0.f, cs = 0.f;
          for (int k = 0; k < KT; ++k) rs += sDt_j[k] * sE[tid * LDT + k];
          for (int q = 0; q < KT; ++q) cs += sE[q * LDT + tid];
          float* dcum_h = sDcum + hh * MAX_CHUNK;
          if (tid < qvalid) dcum_h[q0 + tid] += rs;
          if (tid < kvalid) {
            sDdt[hh * MAX_CHUNK + k0 + tid] += cs;
            dcum_h[k0 + tid] -= sDt_j[tid] * cs;
          }
        }
        __syncthreads();
      }
      // dC_i += dCB B_j and dB_j += dCB^T C_i, in the block's partials
      {
        float dc[KT / 16][N / 16];
        zero(dc);
        mm(dc, sCB, LDT, 1, sB, L::LDB, 1, kvalid, ty, tx);
#pragma unroll
        for (int a = 0; a < KT / 16; ++a) {
          const int r = ty + 16 * a;
          if (r < qvalid)
#pragma unroll
            for (int bb = 0; bb < N / 16; ++bb)
              dC_blk[(q0 + r) * row_gn + tx + 16 * bb] += dc[a][bb];
        }
      }
      mm(dBacc, sCB, 1, LDT, sC, L::LDC, 1, qvalid, ty, tx);
      __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < KT / 16; ++a) {
      const int r = ty + 16 * a;
      if (r < kvalid)
#pragma unroll
        for (int bb = 0; bb < N / 16; ++bb) dB_blk[(k0 + r) * row_gn + tx + 16 * bb] = dBacc[a][bb];
    }
    // 2. each chunk's input to the state and the carry, rows of tile j
    load_rows(sC, L::LDC, Cm + (t0 + k0) * row_gn + (size_t)g * N, row_gn, N, kvalid, tid);
    for (int hh = 0; hh < nh; ++hh) {
      const int h = h_first + hh;
      load_rows(sX, L::LDX, x + ((t0 + k0) * H + h) * P, (size_t)H * P, P, kvalid, tid);
      load_rows(sY, L::LDY, dy + ((t0 + k0) * H + h) * P, (size_t)H * P, P, kvalid, tid);
      if (tid < KT) {
        const float cum_end = cum[(t0 + chunk - 1) * H + h];
        const float ck = tid < kvalid ? cum[(t0 + k0 + tid) * H + h] : 0.f;
        const float dtk = tid < kvalid ? dt[(t0 + k0 + tid) * H + h] : 0.f;
        sDecay[tid] = expf(cum_end - ck);
        sW[tid] = dtk * sDecay[tid];  // 0 past the chunk
        sEcum[tid] = tid < kvalid ? expf(ck) : 0.f;
      }
      const float* dc_h = dchunk_in + (((size_t)b * nc + c) * H + h) * P * N;
      const float* hin_h = h_ins + (((size_t)b * nc + c) * H + h) * P * N;
      float dcb[KT / 16][P / 16];  // (B_j dchunk_in^T)_kp
      zero(dcb);
#pragma unroll
      for (int ch = 0; ch < N / NCH; ++ch) {
        const int n0 = ch * NCH;
        __syncthreads();  // the previous piece has been read
        for (int e = tid; e < P * NCH; e += THREADS) {
          const int p = e / NCH, n = e % NCH;
          sDc[p * LDD + n] = dc_h[p * N + n0 + n];
          sHin[p * LDD + n] = hin_h[p * N + n0 + n];
        }
        __syncthreads();
        mm(dcb, sB + n0, L::LDB, 1, sDc, 1, LDD, NCH, ty, tx);
        {  // one product's registers live at a time
          float xdc[KT / 16][NCH / 16];
          zero(xdc);
          mm(xdc, sX, L::LDX, 1, sDc, LDD, 1, P, ty, tx);
#pragma unroll
          for (int a = 0; a < KT / 16; ++a) {
            const int r = ty + 16 * a;
            if (r < kvalid)
#pragma unroll
              for (int bb = 0; bb < NCH / 16; ++bb)
                dB_blk[(k0 + r) * row_gn + n0 + tx + 16 * bb] += sW[r] * xdc[a][bb];
          }
        }
        float dyh[KT / 16][NCH / 16];
        zero(dyh);
        mm(dyh, sY, L::LDY, 1, sHin, LDD, 1, P, ty, tx);
#pragma unroll
        for (int a = 0; a < KT / 16; ++a) {
          const int r = ty + 16 * a;
          float carry = 0.f;
#pragma unroll
          for (int bb = 0; bb < NCH / 16; ++bb) {
            const int n = n0 + tx + 16 * bb;
            carry += sC[r * L::LDC + n] * dyh[a][bb];
            if (r < kvalid) dC_blk[(k0 + r) * row_gn + n] += sEcum[r] * dyh[a][bb];
          }
          carry = sum16(carry);
          if (tx == 0 && r < kvalid) sDcum[hh * MAX_CHUNK + k0 + r] += sEcum[r] * carry;
        }
      }
      const float Dh = Dv[h];
      float dd = 0.f;  // this thread's share of sum dy . x
#pragma unroll
      for (int a = 0; a < KT / 16; ++a) {
        const int r = ty + 16 * a;
        float dw = 0.f;  // x_k . (dchunk_in B_k)
#pragma unroll
        for (int bb = 0; bb < P / 16; ++bb) dw += sX[r * L::LDX + tx + 16 * bb] * dcb[a][bb];
        dw = sum16(dw);
        if (r < kvalid) {
          T* out = dx + ((t0 + k0 + r) * H + h) * P;
          const float* dxh = sDX + hh * KT * P + r * P;
#pragma unroll
          for (int bb = 0; bb < P / 16; ++bb) {
            const int p = tx + 16 * bb;
            const float yv = sY[r * L::LDY + p];
            out[p] = from_f32<T>(dxh[p] + sW[r] * dcb[a][bb] + Dh * yv);
            dd += yv * sX[r * L::LDX + p];
          }
          if (tx == 0) {
            const float wdw = sW[r] * dw;
            sDdt[hh * MAX_CHUNK + k0 + r] += sDecay[r] * dw;
            sDcum[hh * MAX_CHUNK + k0 + r] -= wdw;
            sWdw[hh * MAX_CHUNK + k0 + r] = wdw;
          }
        }
      }
      dd = sum32(dd);
      if (tid % 32 == 0) sRed[(tid / 32) * MAX_HEAD_BLOCK + hh] += dd;  // one writer a slot
      __syncthreads();
    }
  }

  // 3. cum's gradient: the chunk-end terms, then the reverse cumsum
  float* sDtAll = sDX;  // (head_block, chunk) dt
  for (int e = tid; e < nh * chunk; e += THREADS) {
    const int hh = e / chunk, t = e % chunk;
    sDtAll[hh * MAX_CHUNK + t] = dt[(t0 + t) * H + h_first + hh];
  }
  __syncthreads();
  if (tid < nh) {
    const int hh = tid, h = h_first + hh;
    float* dcum_h = sDcum + hh * MAX_CHUNK;
    float* ddt_h = sDdt + hh * MAX_CHUNK;
    const float* dt_h = sDtAll + hh * MAX_CHUNK;
    float wdw = 0.f;
    for (int k = 0; k < chunk; ++k) wdw += sWdw[hh * MAX_CHUNK + k];
    dcum_h[chunk - 1] += wdw + end_term[((size_t)b * nc + c) * H + h];
    const float Ah = A[h];
    float rc = 0.f, da = 0.f;
    for (int t = chunk - 1; t >= 0; --t) {
      rc += dcum_h[t];
      ddt_h[t] += Ah * rc;
      da += dt_h[t] * rc;
    }
    float d = 0.f;
    for (int w = 0; w < WARPS; ++w) d += sRed[w * MAX_HEAD_BLOCK + hh];
    dA_part[((size_t)b * nc + c) * H + h] = da;
    dD_part[((size_t)b * nc + c) * H + h] = d;
  }
  __syncthreads();
  for (int e = tid; e < nh * chunk; e += THREADS) {
    const int t = e / nh, hh = e % nh;
    ddt[(t0 + t) * H + h_first + hh] = sDdt[hh * MAX_CHUNK + t];
  }
}

template <int P, int N, typename T>
int launch_dstate(const void* dy, const void* cum, const void* C, void* dS, int Bt, int S,
                  int H, int G, int chunk, cudaStream_t stream) {
  const long long blocks = (long long)Bt * (S / chunk) * H;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ssd_bwd_dstate_kernel<P, N, T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const float*>(cum), static_cast<const T*>(C),
      static_cast<float*>(dS), S / chunk, H, G, chunk);
  return (int)cudaGetLastError();
}

template <int P, int N, typename T>
int launch_chunk(const void* x, const void* dt, const void* A, const void* cum, const void* B,
                 const void* C, const void* D, const void* dy, const void* h_ins,
                 const void* dchunk_in, const void* end_term, void* dx, void* ddt, void* dB_part,
                 void* dC_part, void* dA_part, void* dD_part, int Bt, int S, int H, int G,
                 int chunk, int head_block, cudaStream_t stream) {
  using L = ChunkSmem<P, N>;
  auto kernel = ssd_bwd_chunk_kernel<P, N, T>;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            L::BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)Bt * (S / chunk) * G * ((H / G + head_block - 1) / head_block);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, L::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(cum), static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(D), static_cast<const T*>(dy),
      static_cast<const float*>(h_ins), static_cast<const float*>(dchunk_in),
      static_cast<const float*>(end_term), static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part), static_cast<float*>(dA_part),
      static_cast<float*>(dD_part), Bt, S / chunk, H, G, chunk, head_block);
  return (int)cudaGetLastError();
}

bool valid(int Bt, int S, int H, int G, int chunk) {
  return Bt >= 1 && chunk >= 1 && chunk <= MAX_CHUNK && S >= chunk && S % chunk == 0 &&
         G >= 1 && H % G == 0;
}

}  // namespace

// Each entry launches on `stream` and returns the CUDA error of the launch (0
// on success).  The caller has checked shapes, types (x, B, C, dy, dx one
// type: dtype 0 = float32, 1 = bfloat16; the rest f32), contiguity and the
// device; (P, N) is one of (16, 16), (16, 32), (32, 16), (64, 128).

#define SSD_BWD_PN(X) X(16, 16) X(16, 32) X(32, 16) X(64, 128)

extern "C" int ssd_bwd_dstate(const void* dy, const void* cum, const void* C, void* dS, int Bt,
                              int S, int H, int G, int P, int N, int chunk, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(Bt, S, H, G, chunk) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
#define DSTATE(p, n)                                                                     \
  if (P == p && N == n)                                                                  \
    return dtype ? launch_dstate<p, n, __nv_bfloat16>(dy, cum, C, dS, Bt, S, H, G, chunk, st) \
                 : launch_dstate<p, n, float>(dy, cum, C, dS, Bt, S, H, G, chunk, st);
  SSD_BWD_PN(DSTATE)
#undef DSTATE
  return (int)cudaErrorInvalidValue;
}

// dh_final may be null (zeros).  end_part is (Bt, nc, H, parts) with parts =
// ceil(P * N / 4 / 256).
extern "C" int ssd_bwd_state_pass(const void* dS, const void* cum, const void* h_ins,
                                  const void* dh_final, void* dchunk_in, void* dh0,
                                  void* end_part, int Bt, int S, int H, int P, int N, int chunk,
                                  void* stream) {
  if (!valid(Bt, S, H, 1, chunk) || P < 1 || N < 1 || (P * N) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int PN4 = P * N / 4, parts = (PN4 + PASS_THREADS - 1) / PASS_THREADS;
  if ((long long)Bt * H > INT_MAX || parts > 65535) return (int)cudaErrorInvalidValue;
  ssd_bwd_state_pass_kernel<<<dim3((unsigned)(Bt * H), parts), PASS_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(dS), static_cast<const float*>(cum),
      static_cast<const float4*>(h_ins), static_cast<const float4*>(dh_final),
      static_cast<float4*>(dchunk_in), static_cast<float4*>(dh0), static_cast<float*>(end_part),
      S / chunk, H, PN4, chunk);
  return (int)cudaGetLastError();
}

// dB_part and dC_part are (ceil(H / G / head_block), Bt, S, G, N), dC_part
// zeroed by the caller; dA_part and dD_part (Bt, nc, H); 1 <= head_block <= 4.
extern "C" int ssd_bwd_chunk(const void* x, const void* dt, const void* A, const void* cum,
                             const void* B, const void* C, const void* D, const void* dy,
                             const void* h_ins, const void* dchunk_in, const void* end_term,
                             void* dx, void* ddt, void* dB_part, void* dC_part, void* dA_part,
                             void* dD_part, int Bt, int S, int H, int G, int P, int N,
                             int chunk, int head_block, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid(Bt, S, H, G, chunk) || head_block < 1 || head_block > MAX_HEAD_BLOCK ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
#define CHUNK(p, n)                                                                        \
  if (P == p && N == n)                                                                    \
    return dtype ? launch_chunk<p, n, __nv_bfloat16>(x, dt, A, cum, B, C, D, dy, h_ins,     \
                                                     dchunk_in, end_term, dx, ddt, dB_part, \
                                                     dC_part, dA_part, dD_part, Bt, S, H, G, \
                                                     chunk, head_block, st)                 \
                 : launch_chunk<p, n, float>(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in,  \
                                             end_term, dx, ddt, dB_part, dC_part, dA_part,  \
                                             dD_part, Bt, S, H, G, chunk, head_block, st);
  SSD_BWD_PN(CHUNK)
#undef CHUNK
  return (int)cudaErrorInvalidValue;
}

// Registers, local bytes (spills and stack) and shared bytes (static plus
// dynamic) of ssd_bwd_dstate (which = 0) or ssd_bwd_chunk (which = 2) at (P, N)
// in bf16 (dtype 1) or f32, or of ssd_bwd_state_pass (which = 1); returns a
// CUDA error code (0 on success).
extern "C" int ssd_bwd_attributes(int which, int P, int N, int dtype, int* regs,
                                  int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  int dynamic_smem = 0, err = (int)cudaErrorInvalidValue;
  if (which == 1) err = (int)cudaFuncGetAttributes(&attr, ssd_bwd_state_pass_kernel);
#define ATTR(p, n)                                                                        \
  if (P == p && N == n && which == 0)                                                     \
    err = dtype ? (int)cudaFuncGetAttributes(&attr, ssd_bwd_dstate_kernel<p, n, __nv_bfloat16>) \
                : (int)cudaFuncGetAttributes(&attr, ssd_bwd_dstate_kernel<p, n, float>);   \
  if (P == p && N == n && which == 2) {                                                   \
    dynamic_smem = ChunkSmem<p, n>::BYTES;                                                \
    err = dtype ? (int)cudaFuncGetAttributes(&attr, ssd_bwd_chunk_kernel<p, n, __nv_bfloat16>) \
                : (int)cudaFuncGetAttributes(&attr, ssd_bwd_chunk_kernel<p, n, float>);    \
  }
  SSD_BWD_PN(ATTR)
#undef ATTR
  if (err) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes + dynamic_smem;
  return 0;
}
