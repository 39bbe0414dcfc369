// Flash-attention backward for Hopper (sm_90a): the gradient of the forward
// kernel of flash_attn_fwd.cu (causal, local-window or non-causal GQA
// self-attention), from the log-sum-exp L that the forward wrote.
//
// The TPU package has no backward kernel: `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py) cannot be differentiated,
// and the reference's gradients come from its jnp paths.  These kernels
// compute what the plain `attention_bwd_ref` (ref.py) writes out:
//   P   = exp(scale q.k - L)          (recomputed, never stored in full)
//   D   = rowsum(dO o O)               flash_attn_bwd_pre_kernel
//   dV  = P^T dO,  dK = scale dS^T Q   flash_attn_bwd_dkdv_kernel
//   dS  = P o (dO V^T - D)
//   dQ  = scale dS K                   flash_attn_bwd_dq_kernel
// with dK and dV summed over the H/KH query heads of each KV group.
// Layouts are those of the forward: q, o, dO and dq (B, S, H, hd); k, v, dk
// and dv (B, S, KH, hd); L and D f32 (B, H, S); all contiguous.  Inputs are
// f32 or bf16; every sum and the softmax are f32, and only the outputs are
// rounded to the input type.  Masked keys (causal, window, the ragged tail
// past S) get P = 0 exactly, and the tiles that the masks hide entirely are
// neither loaded nor computed, as in the forward: any S >= 1.
//
// What bounds it on the H100: at qwen3-0.6b's training shape (B 4, S 2048,
// H 16, KH 8, hd 64, causal, bf16) the gradient is five products of the
// forward's size, 85.9 GFLOP (0.087 ms at 989 TFLOP/s), against about 101
// MB of q, k, v, o, dO, L, dq, dk and dv (0.030 ms at 3.35 TB/s): bound by
// operations; at recurrentgemma-2b's (B 4, S 2048, H 10, KH 1, hd 256,
// window 2048) 215 GFLOP (0.217 ms) against about 185 MB, also operations.
// The layout of the work is the same for every design below, and
// deterministic:
//   * dK and dV: a block per (batch * KV head, 64-key tile) keeps K, V and
//     the dK and dV accumulators of its keys on chip and walks the group's
//     query heads and the query tiles that can see the tile; dK and dV are
//     written once (bf16 at head_dim 256: each part of a split walk writes
//     its f32 partials once), with no atomics, so the result does not
//     depend on the order in which blocks run;
//   * dQ: a block per (batch * head, query tile) walks the key tiles, and
//     recomputes S and dP (two products more than the minimum of five);
//   * D = rowsum(dO o O) first, a warp a row.
//
// bf16 at head_dim 16 and 64 (qwen3-0.6b's, granite-moe-3b-a800m's,
// whisper-medium's and the reduced configs'): the warpgroup kernels
// (`*_wg_kernel`, described where they are defined), wgmma on bf16 tiles
// read through shared-memory descriptors, P and dS in registers.  bf16 at head_dim 256
// (recurrentgemma-2b's): the eight-warp tensor-core kernels
// (`*_wide_kernel`), P and dS through shared memory, the dK/dV walk split
// into parts so that batch 1 fills the card.
//
// f32, and bf16 at head_dim 128: the CUDA-core kernels, f32 arithmetic
// throughout, the yardstick of the f32 gates:
//   * each product is a register-tiled product on f32 tiles in shared
//     memory: a thread owns a micro-tile of outputs (4 x 4 scores at hd 64)
//     and reads float4 rows whose padded stride (hd + 4 floats) puts eight
//     consecutive rows in eight distinct 16-byte bank groups; P and dS pass
//     through shared memory between the products;
//   * bf16 inputs are widened to f32 as they are staged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

#include "flash_common.cuh"

__device__ __forceinline__ bool key_visible(int qpos, int kpos, int S, int causal, int window) {
  bool ok = kpos < S && qpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// Four consecutive values of a row, widened to f32, and back.
template <typename T> struct Io;
template <> struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};
template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &u.x, sizeof(lo));
    memcpy(&hi, &u.y, sizeof(hi));
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    memcpy(&u.x, &lo, sizeof(lo));
    memcpy(&u.y, &hi, sizeof(hi));
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x += s * x.x; acc.y += s * x.y; acc.z += s * x.z; acc.w += s * x.w;
}

// Query rows (BM) and keys (BN) of a tile, and the blocks an SM should hold
// (the register cap of __launch_bounds__), by head_dim: the f32 tiles of
// both kernels fit 227 KB of shared memory with the same design at every
// head_dim the forward takes.
template <int HD> struct BwdConfig;
template <> struct BwdConfig<16> { static constexpr int BM = 64, BN = 64, MIN_BLOCKS = 2; };
template <> struct BwdConfig<64> { static constexpr int BM = 64, BN = 64, MIN_BLOCKS = 2; };
template <> struct BwdConfig<128> { static constexpr int BM = 64, BN = 64, MIN_BLOCKS = 1; };
template <> struct BwdConfig<256> { static constexpr int BM = 32, BN = 32, MIN_BLOCKS = 1; };

// Floats between rows of a staged (rows x hd) tile, and of a P or dS tile.
template <int HD> __host__ __device__ constexpr int row_stride() { return HD + 4; }
template <int N> __host__ __device__ constexpr int score_stride() { return N + 4; }

// dK/dV kernel: K, V, Q, dO (f32 rows), P^T and dS^T, L and D of the tile.
template <int HD> __host__ __device__ constexpr int dkdv_smem_bytes() {
  constexpr int BM = BwdConfig<HD>::BM, BN = BwdConfig<HD>::BN;
  return 4 * ((2 * BN + 2 * BM) * row_stride<HD>() + 2 * BN * score_stride<BM>() + 2 * BM);
}
// dQ kernel: Q, dO, K, V (f32 rows), dS, L and D of the tile.
template <int HD> __host__ __device__ constexpr int dq_smem_bytes() {
  constexpr int BM = BwdConfig<HD>::BM, BN = BwdConfig<HD>::BN;
  return 4 * ((2 * BN + 2 * BM) * row_stride<HD>() + BM * score_stride<BN>() + 2 * BM);
}

// Stage `rows` rows of a (B, S, heads, HD) tensor, from sequence position
// `pos0` of head `head`, as f32 rows of row_stride<HD>() floats; rows past
// S are zeros.
template <int HD, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int b, int pos0,
                                           int rows, int S, int heads, int head) {
  constexpr int C4 = HD / 4;
  for (int idx = threadIdx.x; idx < rows * C4; idx += THREADS) {
    const int r = idx / C4, c = idx % C4;
    const int pos = pos0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S) x = Io<T>::load4(src + (((size_t)b * S + pos) * heads + head) * HD + 4 * c);
    *reinterpret_cast<float4*>(dst + r * row_stride<HD>() + 4 * c) = x;
  }
}

// acc[x][y] = sum_d A[x rows][d] B[y rows][d] for the thread's micro-tile:
// rows xr + 16 x of A and yr + 16 y of B, reading float4s.
template <int HD, int NX, int NY>
__device__ __forceinline__ void tile_product(float (&acc)[NX][NY], const float* A, int xr,
                                             const float* Bm, int yr) {
  constexpr int RS = row_stride<HD>();
#pragma unroll
  for (int x = 0; x < NX; ++x)
#pragma unroll
    for (int y = 0; y < NY; ++y) acc[x][y] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 bv[NY];
#pragma unroll
    for (int y = 0; y < NY; ++y)
      bv[y] = *reinterpret_cast<const float4*>(Bm + (yr + 16 * y) * RS + d);
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      const float4 av = *reinterpret_cast<const float4*>(A + (xr + 16 * x) * RS + d);
#pragma unroll
      for (int y = 0; y < NY; ++y) acc[x][y] += dot4(av, bv[y]);
    }
  }
}

// ---------------------------------------------------------------------------
// D = rowsum(dO o O): a warp per (b, s, h) row.
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_pre_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, int rows, int S, int H) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * (THREADS / 32) + warp;  // row in (b, s, h) order
  if (r >= rows) return;                             // the whole warp
  float acc = 0.f;
  for (int d = 4 * lane; d < HD; d += 128)
    acc += dot4(Io<T>::load4(o + (size_t)r * HD + d), Io<T>::load4(dout + (size_t)r * HD + d));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = r % H, s = (r / H) % S, b = r / H / S;
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// dK and dV of one (batch * KV head, key tile).
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS, BwdConfig<HD>::MIN_BLOCKS)
flash_attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KH,
                           float scale, int causal, int window) {
  constexpr int BM = BwdConfig<HD>::BM, BN = BwdConfig<HD>::BN;
  constexpr int RS = row_stride<HD>(), PS = score_stride<BM>();
  // the score tiles: thread (tj, ti) owns keys tj + 16 a and queries ti + 16 c
  constexpr int JA = BN / 16, IA = BM / 16;
  // the dK, dV tiles: thread (tjb, td) owns keys tjb + TJ jj, dims 4 td .. 4 td + 3
  constexpr int TD = HD / 4, TJ = THREADS / TD, JPT = BN / TJ;
  static_assert(THREADS % TD == 0 && BN % TJ == 0, "whole dK/dV tiles");

  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * RS;
  float* Qs = Vs + BN * RS;
  float* Gs = Qs + BM * RS;  // dO
  float* Ps = Gs + BM * RS;  // P^T (keys x queries)
  float* Ss = Ps + BN * PS;  // dS^T
  float* Ls = Ss + BN * PS;
  float* Ds = Ls + BM;

  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int G = H / KH;
  const int n0 = blockIdx.y * BN;  // tile 0, the most expensive under a causal mask, first
  const int tj = threadIdx.x / 16, ti = threadIdx.x % 16;
  const int tjb = threadIdx.x / TD, td = threadIdx.x % TD;

  stage_rows<HD>(Ks, k, b, n0, BN, S, KH, kh);
  stage_rows<HD>(Vs, v, b, n0, BN, S, KH, kh);

  // The queries that can see a key of this tile.
  int m_begin = 0, m_end = S;
  if (causal) m_begin = n0 / BM * BM;
  if (window > 0) m_end = (int)min((long long)S, (long long)n0 + BN - 1 + window);

  float4 dk_acc[JPT], dv_acc[JPT];
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) {
    dk_acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* Lrow = lse + ((size_t)b * H + h) * S;
    const float* Drow = delta + ((size_t)b * H + h) * S;
    for (int m0 = m_begin; m0 < m_end; m0 += BM) {
      __syncthreads();  // every thread is done with the previous tile
      stage_rows<HD>(Qs, q, b, m0, BM, S, H, h);
      stage_rows<HD>(Gs, dout, b, m0, BM, S, H, h);
      for (int i = threadIdx.x; i < BM; i += THREADS) {
        const bool ok = m0 + i < S;
        Ls[i] = ok ? Lrow[m0 + i] : 0.f;
        Ds[i] = ok ? Drow[m0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T; then P^T and dS^T into shared memory.
      {
        float s[JA][IA], dp[JA][IA];
        tile_product<HD>(s, Ks, tj, Qs, ti);
        tile_product<HD>(dp, Vs, tj, Gs, ti);
#pragma unroll
        for (int a = 0; a < JA; ++a)
#pragma unroll
          for (int c = 0; c < IA; ++c) {
            const int j = tj + 16 * a, i = ti + 16 * c;
            const bool seen = key_visible(m0 + i, n0 + j, S, causal, window);
            const float p = seen ? expf(s[a][c] * scale - Ls[i]) : 0.f;
            Ps[j * PS + i] = p;
            Ss[j * PS + i] = p * (dp[a][c] - Ds[i]);
          }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q (the scale is applied once, at the end)
#pragma unroll 2
      for (int i = 0; i < BM; ++i) {
        const float4 gv = *reinterpret_cast<const float4*>(Gs + i * RS + 4 * td);
        const float4 qv = *reinterpret_cast<const float4*>(Qs + i * RS + 4 * td);
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj) {
          const int j = tjb + TJ * jj;
          fma4(dv_acc[jj], Ps[j * PS + i], gv);
          fma4(dk_acc[jj], Ss[j * PS + i], qv);
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) {
    const int pos = n0 + tjb + TJ * jj;
    if (pos < S) {
      const size_t off = (((size_t)b * S + pos) * KH + kh) * HD + 4 * td;
      const float4 x = dk_acc[jj];
      Io<T>::store4(dk + off, make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
      Io<T>::store4(dv + off, dv_acc[jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ of one (batch * head, query tile).
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS, BwdConfig<HD>::MIN_BLOCKS)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, int S, int H, int KH, float scale, int causal,
                         int window) {
  constexpr int BM = BwdConfig<HD>::BM, BN = BwdConfig<HD>::BN;
  constexpr int RS = row_stride<HD>(), SS = score_stride<BN>();
  // the score tiles: thread (ti, tj) owns queries ti + 16 c and keys tj + 16 a
  constexpr int IA = BM / 16, JA = BN / 16;
  // the dQ tile: thread (tib, td) owns queries tib + TI ii, dims 4 td .. 4 td + 3
  constexpr int TD = HD / 4, TI = THREADS / TD, IPT = BM / TI;
  static_assert(THREADS % TD == 0 && BM % TI == 0, "whole dQ tiles");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + BM * RS;  // dO
  float* Ks = Gs + BM * RS;
  float* Vs = Ks + BN * RS;
  float* Ss = Vs + BN * RS;  // dS (queries x keys)
  float* Ls = Ss + BM * SS;
  float* Ds = Ls + BM;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal tiles first
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  const int tib = threadIdx.x / TD, td = threadIdx.x % TD;

  stage_rows<HD>(Qs, q, b, m0, BM, S, H, h);
  stage_rows<HD>(Gs, dout, b, m0, BM, S, H, h);
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const bool ok = m0 + i < S;
    Ls[i] = ok ? lse[((size_t)b * H + h) * S + m0 + i] : 0.f;
    Ds[i] = ok ? delta[((size_t)b * H + h) * S + m0 + i] : 0.f;
  }

  // The keys any row of this tile can see.
  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, m0 + BM);
  if (window > 0) k_begin = max(0, m0 - window + 1) / BN * BN;

  float4 dq_acc[IPT];
#pragma unroll
  for (int ii = 0; ii < IPT; ++ii) dq_acc[ii] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int n0 = k_begin; n0 < k_end; n0 += BN) {
    __syncthreads();  // every thread is done with the previous tile
    stage_rows<HD>(Ks, k, b, n0, BN, S, KH, kh);
    stage_rows<HD>(Vs, v, b, n0, BN, S, KH, kh);
    __syncthreads();

    // S = Q K^T and dP = dO V^T; then dS into shared memory.
    {
      float s[IA][JA], dp[IA][JA];
      tile_product<HD>(s, Qs, ti, Ks, tj);
      tile_product<HD>(dp, Gs, ti, Vs, tj);
#pragma unroll
      for (int c = 0; c < IA; ++c)
#pragma unroll
        for (int a = 0; a < JA; ++a) {
          const int i = ti + 16 * c, j = tj + 16 * a;
          const bool seen = key_visible(m0 + i, n0 + j, S, causal, window);
          const float p = seen ? expf(s[c][a] * scale - Ls[i]) : 0.f;
          Ss[i * SS + j] = p * (dp[c][a] - Ds[i]);
        }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + j * RS + 4 * td);
#pragma unroll
      for (int ii = 0; ii < IPT; ++ii) fma4(dq_acc[ii], Ss[(tib + TI * ii) * SS + j], kv);
    }
  }

#pragma unroll
  for (int ii = 0; ii < IPT; ++ii) {
    const int pos = m0 + tib + TI * ii;
    if (pos < S) {
      const float4 x = dq_acc[ii];
      Io<T>::store4(dq + (((size_t)b * S + pos) * H + h) * HD + 4 * td,
                    make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
    }
  }
}


// ---------------------------------------------------------------------------
// Tiles of the tensor-core kernels: 64 rows of bf16 in XOR-swizzled shared
// memory (flash_common.cuh), copied by `cp.async`; the wide kernels below
// read them by `ldmatrix` for mma.sync, the warpgroup kernels through wgmma
// descriptors.

constexpr int TC_THREADS = 128;  // four warps: one warpgroup
constexpr int TC_ROWS = 64;      // query rows and keys of a tile
template <int HD> __host__ __device__ constexpr int tc_tile_bytes() { return TC_ROWS * HD * 2; }

// Copies a 64-row bf16 tile of a (B, S, heads, HD) tensor, from position
// pos0 of head `head`, into a swizzled tile at `dst`; rows past S are zeros.
// NTHREADS threads take part.
template <int HD, int NTHREADS = TC_THREADS>
__device__ __forceinline__ void tc_load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                             int b, int pos0, int S, int heads, int head) {
  constexpr int W = HD / 8;                // 16-byte chunks per row
  constexpr int RS = NTHREADS / W;         // rows per round
  static_assert(NTHREADS % W == 0 && TC_ROWS % RS == 0 && RS >= 8, "whole copy rounds");
  const int r = threadIdx.x / W, c = threadIdx.x % W;
  const __nv_bfloat16* base = src + ((size_t)b * S * heads + head) * HD;
#pragma unroll
  for (int i = 0; i < TC_ROWS / RS; ++i) {
    const int row = r + i * RS, pos = pos0 + row;
    const bool ok = pos < S;
    cp_async16(dst + swizzle<W>(row, c), ok ? base + (size_t)pos * heads * HD + 8 * c : base, ok);
  }
}

// Products of a warp's 16 rows of A (a swizzled tile at `aw`, its rows
// 16 w ..) with NB rows of B (at `bt`, a multiple of 16 rows into its tile)
// over head_dim: acc[n] holds columns 8 n .. 8 n + 7 (rows of B).
template <int HD, int NB = TC_ROWS>
__device__ __forceinline__ void tc_rows_by_rows(float (&acc)[NB / 8][4], uint32_t aw,
                                                uint32_t bt, const LaneReads<HD / 8>& a_reads,
                                                const LaneReads<HD / 8>& b_reads) {
#pragma unroll
  for (int n = 0; n < NB / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, aw + a_reads.at(0, 2 * kk));
#pragma unroll
    for (int p = 0; p < NB / 16; ++p) {
      uint32_t bm[4];
      ldmatrix_x4(bm, bt + b_reads.at(16 * p, 2 * kk));
      mma_bf16(acc[2 * p], a, bm[0], bm[1]);
      mma_bf16(acc[2 * p + 1], a, bm[2], bm[3]);
    }
  }
}

// Two neighbouring values of an output row, as bf16 or f32.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Writes a warp's 16 rows (row0 + g, row0 + g + 8) of an f32 accumulator of
// NC columns, times `mul`, into columns col0 .. col0 + NC - 1 of a
// (B, S, heads, HD) tensor of bf16 or f32.  The accumulator layout is
// mma.sync's m16n8 one and, for the warp's rows, wgmma's m64nN one.
template <int HD, int NC = HD, typename T>
__device__ __forceinline__ void tc_store_rows(T* __restrict__ dst, const float (&acc)[NC / 8][4],
                                              float mul, int b, int row0, int S, int heads,
                                              int head, int col0 = 0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = row0 + g + 8 * i;
    if (pos < S) {
      T* out = dst + (((size_t)b * S + pos) * heads + head) * HD + col0 + 2 * t;
#pragma unroll
      for (int d = 0; d < NC / 8; ++d)
        store2(out + 8 * d, acc[d][2 * i] * mul, acc[d][2 * i + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at head_dim 16 and 64: the warpgroup kernels (wgmma.mma_async).  A
// block is one warpgroup (four warps) and owns 64 rows: keys in dK/dV,
// queries in dQ; three blocks share an SM.
//   * dK/dV: a block per (batch * KV head, 64 keys) walks the group's H/KH
//     query heads and the 64-query tiles that can see its keys, Q, dO, L
//     and D of each tile in a ring of WG_STAGES stages filled by cp.async
//     two tiles ahead.  Per tile: S^T = K Q^T and dP^T = V dO^T as
//     m64n64k16 over head_dim (A the K or V tile, B the Q or dO tile, both
//     K-major in shared memory), P and dS in f32 in the accumulators, then
//     dV += P^T dO and dK += dS^T Q as m64n{hd}k16 with A = P^T or dS^T
//     packed to bf16 in registers (the m64 accumulator of 16 query columns
//     is, element for element, the A fragment of one k-step) and B the dO
//     or Q tile read MN-major;
//   * dQ: a block per (batch * head, 64 queries) walks the key tiles with K
//     and V in the ring: S = Q K^T and dP = dO V^T (Q and dO the A tiles),
//     dQ += dS K (B the K tile, MN-major).  dQ recomputes S and dP, so that
//     no output is summed across blocks: no atomics, the same bits every run.
// The S and dP products are committed as two groups, so the exponentials of
// P run while dP is in flight.  The walks' bounds are exact at 64 rows: every
// tile of a walk has a pair the masks keep, so no branch skips a wgmma
// (ptxas serializes every wgmma of a kernel where a divergent path may skip
// one).  The masks are evaluated only on tiles that cross the diagonal, the
// window's edge or S, as two comparisons against the bounds of the columns
// that each of a thread's rows sees.
// What bounds them on the H100: the four products of dK/dV and three of dQ
// at the tensor cores' rate, and between them a block's own exponentials
// (the SFU's 16 a clock an SM), scaling and packing of P and dS, which its
// next products wait for.  So a block is one warpgroup and three blocks
// share an SM (dK/dV holds S, dP, dK and dV, 128 f32 registers a thread,
// within the 168 that three blocks allow): one block's products run while
// another computes its exponentials.  Two warpgroups in one block met at
// every tile's barrier and computed their exponentials in step, with the
// tensor cores idle.

constexpr int WG_STAGES = 3;  // tiles of the walk in shared memory
template <int HD> __host__ __device__ constexpr bool tc_path() { return HD == 16 || HD == 64; }
// dK/dV: K and V of the block, WG_STAGES tiles of Q, of dO, then
// [stage][L | D][64] f32.  dQ: Q and dO of the block, WG_STAGES tiles of K,
// of V.  Each 1024 bytes more, to align the tiles for the swizzles.
template <int HD> __host__ __device__ constexpr int wg_dkdv_smem_bytes() {
  return 1024 + (2 + 2 * WG_STAGES) * tc_tile_bytes<HD>() + WG_STAGES * 2 * TC_ROWS * 4;
}
template <int HD> __host__ __device__ constexpr int wg_dq_smem_bytes() {
  return 1024 + (2 + 2 * WG_STAGES) * tc_tile_bytes<HD>();
}

// The A fragments of four k-steps (16 columns each) of a 64-column f32
// accumulator, packed to bf16.
__device__ __forceinline__ void wg_acc_to_a(uint32_t (&a)[4][4], const float (&x)[TC_ROWS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc (64 x 64) = A B^T over head_dim: A and B 64-row tiles at `a` and `b`.
template <int HD>
__device__ __forceinline__ void wg_rows_by_rows(float (&acc)[TC_ROWS / 8][4], uint32_t a,
                                                uint32_t b) {
  const uint64_t da = wgmma_desc<HD / 8>(a), db = wgmma_desc<HD / 8>(b);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)  // k-steps of 32 bytes along the rows
    wgmma_ss(acc, da + 2 * kk, db + 2 * kk, kk);
}

// out (64 x HD) += X T: X the A fragments of 64 columns, T a 64-row tile at
// `tt` (its rows the k dimension, read MN-major).
template <int HD>
__device__ __forceinline__ void wg_acc_times_tile(float (&out)[HD / 8][4], const uint32_t (&x)[4][4],
                                                  uint32_t tt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // k-steps of 16 rows
    wgmma_rs<HD>(out, x[kk], wgmma_desc<HD / 8>(tt + kk * 16 * HD * 2));
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 3)
flash_attn_bwd_dkdv_wg_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              int S, int H, int KH, float scale, int causal, int window) {
  constexpr int NT = TC_ROWS / 8, TILE = tc_tile_bytes<HD>();
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem), base = (raw + 1023) & ~1023u;
  const uint32_t ks = base, vs = ks + TILE;
  const uint32_t qs = vs + TILE;  // WG_STAGES tiles of Q, then of dO
  const uint32_t gs = qs + WG_STAGES * TILE;
  const float* rowstat = reinterpret_cast<const float*>(wg_smem + (base - raw) +
                                                       (2 + 2 * WG_STAGES) * TILE);

  const int b = blockIdx.x / KH, kh = blockIdx.x % KH, G = H / KH;
  const int n0 = blockIdx.y * TC_ROWS;  // tile 0, the most expensive under a causal mask, first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wk0 = n0 + 16 * warp;  // the warp's first key
  const float scale_log2 = scale * LOG2E;

  // The query tiles that can see a key of the block, for each head of the group.
  int m_begin = 0, m_end = S;
  if (causal) m_begin = n0;
  if (window > 0) m_end = (int)min((long long)S, (long long)n0 + TC_ROWS - 1 + window);
  const int per_head = (m_end - m_begin + TC_ROWS - 1) / TC_ROWS;
  const int n_iter = G * per_head;

  auto load_queries = [&](int it, int stage) {
    const int h = kh * G + it / per_head, m0 = m_begin + (it % per_head) * TC_ROWS;
    tc_load_tile<HD>(qs + stage * TILE, q, b, m0, S, H, h);
    tc_load_tile<HD>(gs + stage * TILE, dout, b, m0, S, H, h);
    const int i = threadIdx.x % TC_ROWS, which = threadIdx.x / TC_ROWS;  // L, then D
    const float* src = (which ? delta : lse) + ((size_t)b * H + h) * S;
    const bool ok = m0 + i < S;
    cp_async4(smem_addr(rowstat + (2 * stage + which) * TC_ROWS + i), ok ? src + m0 + i : src, ok);
  };

  tc_load_tile<HD>(ks, k, b, n0, S, KH, kh);
  tc_load_tile<HD>(vs, v, b, n0, S, KH, kh);
  load_queries(0, 0);
  cp_async_commit();
  if (n_iter > 1) load_queries(1, 1);
  cp_async_commit();

  // The queries [lo, hi) that each of the thread's two keys sees.
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = wk0 + g + 8 * i;
    lo[i] = causal ? key : 0;
    hi[i] = key >= S ? 0 : window > 0 ? (int)min((long long)S, (long long)key + window) : S;
  }

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % WG_STAGES;
    cp_async_wait<1>();  // tile it has arrived; tile it + 1 may be in flight
    fence_async_smem();
    __syncthreads();     // ... for every thread; every warp is done with tile it - 1
    if (it + 2 < n_iter) load_queries(it + 2, (it + 2) % WG_STAGES);
    cp_async_commit();

    const int m0 = m_begin + (it % per_head) * TC_ROWS;
    const uint32_t qst = qs + stage * TILE, gst = gs + stage * TILE;
    float p[NT][4], ds[NT][4];
    wgmma_fence();
    wg_rows_by_rows<HD>(p, ks, qst);  // S^T = K Q^T
    wgmma_commit();
    wg_rows_by_rows<HD>(ds, vs, gst);  // dP^T = V dO^T
    wgmma_commit();
    const bool edge = n0 + TC_ROWS > S || m0 + TC_ROWS > S ||
                      (causal && m0 < n0 + TC_ROWS - 1) ||
                      (window > 0 && m0 + TC_ROWS - 1 - n0 >= window);
    // L and D of the thread's 16 queries: 2 t and 2 t + 1 of each 8
    const float* Ls = rowstat + 2 * stage * TC_ROWS;
    const float* Ds = Ls + TC_ROWS;
    wgmma_wait<1>();  // S^T
    wgmma_hold(p);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(Ls + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[n][e] = fast_exp2(fmaf(p[n][e], scale_log2, -(e & 1 ? l.y : l.x) * LOG2E));
    }
    if (edge) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = m0 + 8 * n + 2 * t + (e & 1), i = e >> 1;
          if (query < lo[i] || query >= hi[i]) p[n][e] = 0.f;
        }
    }
    wgmma_wait<0>();  // dP^T
    wgmma_hold(ds);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(Ds + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - (e & 1 ? d.y : d.x));
    }
    uint32_t pa[4][4], dsa[4][4];
    wg_acc_to_a(pa, p);
    wg_acc_to_a(dsa, ds);
    wgmma_fence();  // the A fragments are written
    wg_acc_times_tile<HD>(dv_acc, pa, gst);   // dV += P^T dO
    wg_acc_times_tile<HD>(dk_acc, dsa, qst);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();  // before the stage is refilled
    wgmma_hold(dv_acc);
    wgmma_hold(dk_acc);
  }
  cp_async_wait<0>();
  tc_store_rows<HD>(dk, dk_acc, scale, b, wk0, S, KH, kh);
  tc_store_rows<HD>(dv, dv_acc, 1.f, b, wk0, S, KH, kh);
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 3)
flash_attn_bwd_dq_wg_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int S, int H, int KH, float scale,
                            int causal, int window) {
  constexpr int NT = TC_ROWS / 8, TILE = tc_tile_bytes<HD>();
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem), base = (raw + 1023) & ~1023u;
  const uint32_t qs = base, gs = qs + TILE;
  const uint32_t ks = gs + TILE;  // WG_STAGES tiles of K, then of V
  const uint32_t vs = ks + WG_STAGES * TILE;

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / KH);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // longest causal tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wq0 = m0 + 16 * warp;  // the warp's first query
  const float scale_log2 = scale * LOG2E;

  // The keys any row of the block can see: at least one tile, since m0 < S.
  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, m0 + TC_ROWS);
  if (window > 0) k_begin = max(0, m0 - window + 1) / TC_ROWS * TC_ROWS;
  const int n_tiles = (k_end - k_begin + TC_ROWS - 1) / TC_ROWS;

  auto load_keys = [&](int j, int stage) {
    tc_load_tile<HD>(ks + stage * TILE, k, b, k_begin + j * TC_ROWS, S, KH, kh);
    tc_load_tile<HD>(vs + stage * TILE, v, b, k_begin + j * TC_ROWS, S, KH, kh);
  };
  tc_load_tile<HD>(qs, q, b, m0, S, H, h);
  tc_load_tile<HD>(gs, dout, b, m0, S, H, h);
  load_keys(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_keys(1, 1);
  cp_async_commit();

  // L (in base 2) and D of the thread's two rows, wq0 + g and wq0 + g + 8,
  // and the keys [lo, hi) that each sees
  float lrow[2], drow[2];
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = wq0 + g + 8 * i;
    const size_t off = ((size_t)b * H + h) * S + pos;
    lrow[i] = pos < S ? lse[off] * LOG2E : 0.f;
    drow[i] = pos < S ? delta[off] : 0.f;
    lo[i] = window > 0 ? max(0, pos - window + 1) : 0;
    hi[i] = pos >= S ? 0 : causal ? min(S, pos + 1) : S;
  }

  float dq_acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) dq_acc[d][0] = dq_acc[d][1] = dq_acc[d][2] = dq_acc[d][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = k_begin + j * TC_ROWS;
    const int stage = j % WG_STAGES;
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    if (j + 2 < n_tiles) load_keys(j + 2, (j + 2) % WG_STAGES);
    cp_async_commit();

    const uint32_t kst = ks + stage * TILE, vst = vs + stage * TILE;
    float p[NT][4], ds[NT][4];
    wgmma_fence();
    wg_rows_by_rows<HD>(p, qs, kst);  // S = Q K^T
    wgmma_commit();
    wg_rows_by_rows<HD>(ds, gs, vst);  // dP = dO V^T
    wgmma_commit();
    const bool edge = n0 + TC_ROWS > S || m0 + TC_ROWS > S ||
                      (causal && n0 + TC_ROWS - 1 > m0) ||
                      (window > 0 && m0 + TC_ROWS - 1 - n0 >= window);
    wgmma_wait<1>();
    wgmma_hold(p);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = fast_exp2(fmaf(p[n][e], scale_log2, -lrow[e >> 1]));
    if (edge) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + 8 * n + 2 * t + (e & 1), i = e >> 1;
          if (key < lo[i] || key >= hi[i]) p[n][e] = 0.f;
        }
    }
    wgmma_wait<0>();
    wgmma_hold(ds);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - drow[e >> 1]);
    uint32_t dsa[4][4];
    wg_acc_to_a(dsa, ds);
    wgmma_fence();
    wg_acc_times_tile<HD>(dq_acc, dsa, kst);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(dq_acc);
  }
  cp_async_wait<0>();
  tc_store_rows<HD>(dq, dq_acc, scale, b, wq0, S, H, h);
}

// One warpgroup product as the kernels above issue them, for the tests of
// the descriptors and operand layouts: which 0, d (64 x 64 f32) = x y^T
// with x and y (64, HD) bf16 (wg_rows_by_rows: both K-major); which 1,
// d (64 x HD) = x y with x (64, 64) taken as A fragments in registers and
// y (64, HD) read MN-major (wg_acc_times_tile).
template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_attn_bwd_wgmma_probe_kernel(const __nv_bfloat16* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ y, float* __restrict__ d,
                                  int which) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem), xs = (raw + 1023) & ~1023u;
  const uint32_t ys = xs + tc_tile_bytes<HD>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if (which == 0) tc_load_tile<HD>(xs, x, 0, 0, TC_ROWS, 1, 0);
  tc_load_tile<HD>(ys, y, 0, 0, TC_ROWS, 1, 0);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  if (which == 0) {
    float s[TC_ROWS / 8][4];
    wgmma_fence();
    wg_rows_by_rows<HD>(s, xs, ys);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s);
    tc_store_rows<TC_ROWS>(d, s, 1.f, 0, 16 * warp, TC_ROWS, 1, 0);
  } else {
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * warp + g + 8 * (r & 1), col = 16 * kk + 2 * t + 8 * (r >> 1);
        a[kk][r] = *reinterpret_cast<const uint32_t*>(x + row * TC_ROWS + col);
      }
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    wgmma_fence();
    wg_acc_times_tile<HD>(o, a, ys);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(o);
    tc_store_rows<HD>(d, o, 1.f, 0, 16 * warp, TC_ROWS, 1, 0);
  }
}

// ---------------------------------------------------------------------------
// bf16 at head_dim 256 (recurrentgemma-2b): the wide tensor-core kernels.
// The products, tiles and copies are those of the kernels above, with 64
// rows a tile; what head_dim 256 changes:
//   * registers: dK and dV of 16 keys at 256 columns would be 256 f32 a
//     thread.  So a block has eight warps: warp w owns row group w % 4 (16
//     of the 64 rows) and half w / 4 of the columns.  For S and dP (dkdv:
//     S^T = K Q^T, dP^T = V dO^T; dq: S = Q K^T, dP = dO V^T, contracted
//     over all 256 columns) the half is one of the tile's two 32-row halves
//     of queries (dkdv) or keys (dq); P and dS, rounded to bf16, go through
//     a 64 x 64 swizzled tile in shared memory, and every warp then
//     multiplies its row group's 16 rows of them by its 128 columns of dO
//     and Q (dkdv) or K (dq).  Accumulators: 2 x 64 f32 a thread in dkdv,
//     64 in dq; 256 threads at up to 255 registers, one block an SM;
//   * shared memory: K and V (dkdv) or Q and dO (dq) of the block, two
//     cp.async stages of the other pair, and the P / dS tiles: 214,016 and
//     204,800 bytes;
//   * blocks: dkdv has a block per (batch * KV head, 64 keys), only 32 at
//     recurrentgemma-2b's batch 1 and S 2048 for 132 SMs.  So each key
//     tile's walk over (query head, query tile) is cut into `splits` equal
//     parts, one block each (the wrapper picks splits from the grid and the
//     SM count); with splits > 1 each part writes f32 partial dK and dV
//     ((splits, B, S, KH, 256), dK already scaled) and the wrapper sums
//     them over the parts in one fixed-order PyTorch sum, then rounds once
//     to bf16: every element is written by one thread in one order, no
//     atomics.  dq has a block per (batch * head, 64 queries), 320 at batch
//     1, and needs no split.
// Skips and masks are the kernels' above, by row group.

constexpr int WIDE_THREADS = 256;  // eight warps
template <int HD> __host__ __device__ constexpr bool wide_path() { return HD == 256; }
constexpr int PS_TILE = TC_ROWS * TC_ROWS * 2;  // a 64 x 64 bf16 tile of P or dS
template <int HD> __host__ __device__ constexpr int wide_dkdv_smem_bytes() {
  return 6 * tc_tile_bytes<HD>() + 2 * PS_TILE + 2 * 2 * TC_ROWS * 4;
}
template <int HD> __host__ __device__ constexpr int wide_dq_smem_bytes() {
  return 6 * tc_tile_bytes<HD>() + PS_TILE;
}

// Writes a warp's 16 x 32 block of an f32 accumulator (rows 16 rg + g and
// + 8, columns 32 hf + 8 n + 2 t and + 1) as bf16 into the swizzled 64 x 64
// tile at `tile`.
__device__ __forceinline__ void wide_put_scores(uint32_t tile, const float (&x)[4][4], int rg,
                                                int hf) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int chunk = 4 * hf + n;
    st_shared_b32(tile + swizzle<8>(16 * rg + g, chunk) + 4 * t, pack_bf16(x[n][0], x[n][1]));
    st_shared_b32(tile + swizzle<8>(16 * rg + g + 8, chunk) + 4 * t, pack_bf16(x[n][2], x[n][3]));
  }
}

// out += X . T over the 64 rows of T, for the warp's 16 rows of X (bf16 in
// the swizzled 64 x 64 tile, from `xw`, its 16-row block) and columns
// 16 c0 .. of T (a swizzled 64-row tile at `tt`, read by ldmatrix.trans).
template <int HD>
__device__ __forceinline__ void wide_tile_times_tile(float (&out)[HD / 16][4], uint32_t xw,
                                                     uint32_t tt, const LaneReads<8>& x_reads,
                                                     const LaneReads<HD / 8>& t_reads, int c0) {
#pragma unroll
  for (int kk = 0; kk < TC_ROWS / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, xw + x_reads.at(0, 2 * kk));
#pragma unroll
    for (int p = 0; p < HD / 32; ++p) {
      uint32_t bm[4];
      ldmatrix_x4_trans(bm, tt + t_reads.at(16 * kk, c0 + 2 * p));
      mma_bf16(out[2 * p], a, bm[0], bm[1]);
      mma_bf16(out[2 * p + 1], a, bm[2], bm[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_attn_bwd_dkdv_wide_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                float* __restrict__ dk_part, float* __restrict__ dv_part, int S,
                                int H, int KH, float scale, int causal, int window, int splits) {
  constexpr int W = HD / 8, TILE = tc_tile_bytes<HD>(), HALF = HD / 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t ks = smem_addr(tc_smem), vs = ks + TILE;
  const uint32_t qs = vs + TILE;  // two stages of Q, then two of dO
  const uint32_t gs = qs + 2 * TILE;
  const uint32_t ps = gs + 2 * TILE, dss = ps + PS_TILE;  // P^T and dS^T: [key][query]
  float* rowstat = reinterpret_cast<float*>(tc_smem + 6 * TILE + 2 * PS_TILE);  // [stage][L | D][64]

  const int split = blockIdx.x % splits, bkh = blockIdx.x / splits;
  const int b = bkh / KH, kh = bkh % KH, G = H / KH;
  const int n0 = blockIdx.y * TC_ROWS;  // tile 0, the most expensive under a causal mask, first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, hf = warp / 4;
  const int g = lane / 4, t = lane % 4, mat = lane / 8, r8 = lane % 8;
  const int wk0 = n0 + 16 * rg;  // the row group's first key
  const float scale_log2 = scale * LOG2E;

  // The query tiles that can see a key of this tile, for each head of the
  // group, and this block's part of them.
  int m_begin = 0, m_end = S;
  if (causal) m_begin = n0;
  if (window > 0) m_end = (int)min((long long)S, (long long)n0 + TC_ROWS - 1 + window);
  const int per_head = (m_end - m_begin + TC_ROWS - 1) / TC_ROWS;
  const long long n_iter = (long long)G * per_head;
  const int it_begin = (int)(n_iter * split / splits), it_end = (int)(n_iter * (split + 1) / splits);

  auto load_queries = [&](int it, int stage) {
    const int h = kh * G + it / per_head, m0 = m_begin + (it % per_head) * TC_ROWS;
    tc_load_tile<HD, WIDE_THREADS>(qs + stage * TILE, q, b, m0, S, H, h);
    tc_load_tile<HD, WIDE_THREADS>(gs + stage * TILE, dout, b, m0, S, H, h);
    if (threadIdx.x < 2 * TC_ROWS) {  // L and D of the tile's rows
      const int i = threadIdx.x % TC_ROWS, which = threadIdx.x / TC_ROWS;
      const float* src = (which ? delta : lse) + ((size_t)b * H + h) * S;
      const bool ok = m0 + i < S;
      const uint32_t dst = smem_addr(rowstat + (2 * stage + which) * TC_ROWS + i);
      cp_async4(dst, ok ? src + m0 + i : src, ok);
    }
  };

  tc_load_tile<HD, WIDE_THREADS>(ks, k, b, n0, S, KH, kh);
  tc_load_tile<HD, WIDE_THREADS>(vs, v, b, n0, S, KH, kh);
  if (it_begin < it_end) load_queries(it_begin, 0);
  cp_async_commit();

  const LaneReads<W> a_reads(r8, mat & 1, mat >> 1), b_reads(r8, mat >> 1, mat & 1);
  const LaneReads<8> x_reads(r8, mat & 1, mat >> 1);
  const uint32_t kw = ks + 16 * rg * W * 16, vw = vs + 16 * rg * W * 16;
  const uint32_t pw = ps + 16 * rg * 8 * 16, dsw = dss + 16 * rg * 8 * 16;
  float dk_acc[HD / 16][4], dv_acc[HD / 16][4];
#pragma unroll
  for (int d = 0; d < HD / 16; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int it = it_begin; it < it_end; ++it) {
    const int stage = (it - it_begin) & 1;
    cp_async_wait<0>();  // tile it has arrived
    __syncthreads();     // ... for every thread; every warp is done with tile it - 1
    if (it + 1 < it_end) {
      load_queries(it + 1, stage ^ 1);  // in flight while tile it is computed
      cp_async_commit();
    }
    const int m0 = m_begin + (it % per_head) * TC_ROWS;
    // Skip a tile none of whose queries sees a key of the row group (uniform
    // over both warps of the group).
    const bool unseen = wk0 >= S || (causal && m0 + TC_ROWS - 1 < wk0) ||
                        (window > 0 && m0 - (wk0 + 15) >= window);
    const uint32_t qst = qs + stage * TILE, gst = gs + stage * TILE;
    if (!unseen) {
      const float* Ls = rowstat + 2 * stage * TC_ROWS + 32 * hf;  // the warp's 32 queries
      const float* Ds = Ls + TC_ROWS;
      const int mq0 = m0 + 32 * hf;
      float p[4][4], ds[4][4];
      tc_rows_by_rows<HD, 32>(p, kw, qst + 32 * hf * W * 16, a_reads, b_reads);   // S^T
      tc_rows_by_rows<HD, 32>(ds, vw, gst + 32 * hf * W * 16, a_reads, b_reads);  // dP^T
      const bool edge = wk0 + 16 > S || mq0 + 32 > S || (causal && mq0 < wk0 + 15) ||
                        (window > 0 && mq0 + 31 - wk0 >= window);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1);  // the query, in the warp's 32
          float pe = fast_exp2(fmaf(p[n][e], scale_log2, -Ls[col] * LOG2E));
          if (edge && !key_visible(mq0 + col, wk0 + g + 8 * (e >> 1), S, causal, window)) pe = 0.f;
          p[n][e] = pe;
          ds[n][e] = pe * (ds[n][e] - Ds[col]);
        }
      wide_put_scores(ps, p, rg, hf);
      wide_put_scores(dss, ds, rg, hf);
    }
    __syncthreads();  // P^T and dS^T of both halves of every row group are in place
    if (!unseen) {
      wide_tile_times_tile<HD>(dv_acc, pw, gst, x_reads, a_reads, HALF / 8 * hf);   // dV += P^T dO
      wide_tile_times_tile<HD>(dk_acc, dsw, qst, x_reads, a_reads, HALF / 8 * hf);  // dK += dS^T Q
    }
  }
  cp_async_wait<0>();  // a block with no part of the walk still loaded K and V
  if (splits == 1) {
    tc_store_rows<HD, HALF>(dk, dk_acc, scale, b, wk0, S, KH, kh, HALF * hf);
    tc_store_rows<HD, HALF>(dv, dv_acc, 1.f, b, wk0, S, KH, kh, HALF * hf);
  } else {
    const size_t part = (size_t)split * (gridDim.x / splits) * S * HD;  // (B * KH) * S * HD each
    tc_store_rows<HD, HALF>(dk_part + part, dk_acc, scale, b, wk0, S, KH, kh, HALF * hf);
    tc_store_rows<HD, HALF>(dv_part + part, dv_acc, 1.f, b, wk0, S, KH, kh, HALF * hf);
  }
}

template <int HD>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_attn_bwd_dq_wide_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int S, int H, int KH, float scale,
                              int causal, int window) {
  constexpr int W = HD / 8, TILE = tc_tile_bytes<HD>(), HALF = HD / 2;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t qs = smem_addr(tc_smem), gs = qs + TILE;
  const uint32_t ks = gs + TILE;  // two stages of K, then two of V
  const uint32_t vs = ks + 2 * TILE;
  const uint32_t dss = vs + 2 * TILE;  // dS: [query][key]

  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / KH);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;  // longest causal tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, hf = warp / 4;
  const int g = lane / 4, t = lane % 4, mat = lane / 8, r8 = lane % 8;
  const int wq0 = m0 + 16 * rg;  // the row group's first query
  const float scale_log2 = scale * LOG2E;

  // The keys any row of this tile can see: at least one tile, since m0 < S.
  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, m0 + TC_ROWS);
  if (window > 0) k_begin = max(0, m0 - window + 1) / TC_ROWS * TC_ROWS;
  const int n_tiles = (k_end - k_begin + TC_ROWS - 1) / TC_ROWS;

  tc_load_tile<HD, WIDE_THREADS>(qs, q, b, m0, S, H, h);
  tc_load_tile<HD, WIDE_THREADS>(gs, dout, b, m0, S, H, h);
  tc_load_tile<HD, WIDE_THREADS>(ks, k, b, k_begin, S, KH, kh);
  tc_load_tile<HD, WIDE_THREADS>(vs, v, b, k_begin, S, KH, kh);
  cp_async_commit();

  // L (in base 2) and D of the thread's two rows, wq0 + g and wq0 + g + 8
  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = wq0 + g + 8 * i;
    const size_t off = ((size_t)b * H + h) * S + pos;
    lrow[i] = pos < S ? lse[off] * LOG2E : 0.f;
    drow[i] = pos < S ? delta[off] : 0.f;
  }

  const LaneReads<W> a_reads(r8, mat & 1, mat >> 1), b_reads(r8, mat >> 1, mat & 1);
  const LaneReads<8> x_reads(r8, mat & 1, mat >> 1);
  const uint32_t qw = qs + 16 * rg * W * 16, gw = gs + 16 * rg * W * 16;
  const uint32_t dsw = dss + 16 * rg * 8 * 16;
  float dq_acc[HD / 16][4];
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) dq_acc[d][0] = dq_acc[d][1] = dq_acc[d][2] = dq_acc[d][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = k_begin + j * TC_ROWS;
    const int stage = j & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) {
      tc_load_tile<HD, WIDE_THREADS>(ks + (stage ^ 1) * TILE, k, b, n0 + TC_ROWS, S, KH, kh);
      tc_load_tile<HD, WIDE_THREADS>(vs + (stage ^ 1) * TILE, v, b, n0 + TC_ROWS, S, KH, kh);
      cp_async_commit();
    }
    const bool unseen = wq0 >= S || (causal && n0 > wq0 + 15) ||
                        (window > 0 && n0 + TC_ROWS - 1 <= wq0 - window);
    const uint32_t kst = ks + stage * TILE, vst = vs + stage * TILE;
    if (!unseen) {
      const int nk0 = n0 + 32 * hf;  // the warp's first key
      float p[4][4], ds[4][4];
      tc_rows_by_rows<HD, 32>(p, qw, kst + 32 * hf * W * 16, a_reads, b_reads);   // S = Q K^T
      tc_rows_by_rows<HD, 32>(ds, gw, vst + 32 * hf * W * 16, a_reads, b_reads);  // dP = dO V^T
      const bool edge = nk0 + 32 > S || wq0 + 16 > S || (causal && nk0 + 31 > wq0) ||
                        (window > 0 && wq0 + 15 - nk0 >= window);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float pe = fast_exp2(fmaf(p[n][e], scale_log2, -lrow[i]));
          const int key = nk0 + 8 * n + 2 * t + (e & 1);
          if (edge && !key_visible(wq0 + g + 8 * i, key, S, causal, window)) pe = 0.f;
          ds[n][e] = pe * (ds[n][e] - drow[i]);
        }
      wide_put_scores(dss, ds, rg, hf);
    }
    __syncthreads();  // dS of both halves of every row group is in place
    if (!unseen) wide_tile_times_tile<HD>(dq_acc, dsw, kst, x_reads, a_reads, HALF / 8 * hf);
  }
  tc_store_rows<HD, HALF>(dq, dq_acc, scale, b, wq0, S, H, h, HALF * hf);
}

// ---------------------------------------------------------------------------
// Launchers, by head_dim and type (dtype 0 = float32, 1 = bfloat16): bf16 at
// head_dim 16 and 64 takes the tensor-core kernels, bf16 at 256 the wide
// ones, the rest the CUDA-core ones.

template <int HD, typename T>
int pre_t(const void* o, const void* dout, void* delta, int B, int S, int H, cudaStream_t st) {
  const int rows = B * S * H;
  const int per_block = THREADS / 32;
  flash_attn_bwd_pre_kernel<HD, T><<<(rows + per_block - 1) / per_block, THREADS, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), rows,
      S, H);
  return (int)cudaGetLastError();
}

template <typename T, int HD> constexpr bool use_tc() {
  return sizeof(T) == 2 && tc_path<HD>();
}
template <typename T, int HD> constexpr bool use_wide() {
  return sizeof(T) == 2 && wide_path<HD>();
}

template <int HD, typename T>
int dkdv_t(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, void* dk_part, void* dv_part, int B, int S,
           int H, int KH, float scale, int causal, int window, int splits, cudaStream_t st) {
  if constexpr (use_wide<T, HD>()) {
    auto kernel = flash_attn_bwd_dkdv_wide_kernel<HD>;
    if (splits < 1 || (long long)B * KH * splits > INT_MAX || (splits > 1 && !(dk_part && dv_part)))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           wide_dkdv_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * KH * splits, (S + TC_ROWS - 1) / TC_ROWS);
    kernel<<<grid, WIDE_THREADS, wide_dkdv_smem_bytes<HD>(), st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        static_cast<float*>(dk_part), static_cast<float*>(dv_part), S, H, KH, scale, causal,
        window, splits);
    return (int)cudaGetLastError();
  } else if constexpr (use_tc<T, HD>()) {
    if (splits != 1) return (int)cudaErrorInvalidValue;  // only the wide kernel splits
    auto kernel = flash_attn_bwd_dkdv_wg_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           wg_dkdv_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * KH, (S + TC_ROWS - 1) / TC_ROWS);
    kernel<<<grid, TC_THREADS, wg_dkdv_smem_bytes<HD>(), st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H, KH, scale,
        causal, window);
    return (int)cudaGetLastError();
  } else {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    auto kernel = flash_attn_bwd_dkdv_kernel<HD, T>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           dkdv_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * KH, (S + BwdConfig<HD>::BN - 1) / BwdConfig<HD>::BN);
    kernel<<<grid, THREADS, dkdv_smem_bytes<HD>(), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), S, H, KH,
        scale, causal, window);
    return (int)cudaGetLastError();
  }
}

template <int HD, typename T>
int dq_t(const void* q, const void* k, const void* v, const void* dout, const void* lse,
         const void* delta, void* dq, int B, int S, int H, int KH, float scale, int causal,
         int window, cudaStream_t st) {
  if constexpr (use_wide<T, HD>()) {
    auto kernel = flash_attn_bwd_dq_wide_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           wide_dq_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * H, (S + TC_ROWS - 1) / TC_ROWS);
    kernel<<<grid, WIDE_THREADS, wide_dq_smem_bytes<HD>(), st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<__nv_bfloat16*>(dq), S, H, KH, scale, causal, window);
    return (int)cudaGetLastError();
  } else if constexpr (use_tc<T, HD>()) {
    auto kernel = flash_attn_bwd_dq_wg_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           wg_dq_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * H, (S + TC_ROWS - 1) / TC_ROWS);
    kernel<<<grid, TC_THREADS, wg_dq_smem_bytes<HD>(), st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<__nv_bfloat16*>(dq), S, H, KH, scale, causal, window);
    return (int)cudaGetLastError();
  } else {
    auto kernel = flash_attn_bwd_dq_kernel<HD, T>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           dq_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * H, (S + BwdConfig<HD>::BM - 1) / BwdConfig<HD>::BM);
    kernel<<<grid, THREADS, dq_smem_bytes<HD>(), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), S, H, KH, scale, causal, window);
    return (int)cudaGetLastError();
  }
}

template <int HD, typename T>
int attributes_t(int which, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  int dynamic = 0;
  if (which == 0) {
    err = cudaFuncGetAttributes(&attr, flash_attn_bwd_pre_kernel<HD, T>);
  } else if (which == 1) {
    if constexpr (use_wide<T, HD>()) {
      err = cudaFuncGetAttributes(&attr, flash_attn_bwd_dkdv_wide_kernel<HD>);
      dynamic = wide_dkdv_smem_bytes<HD>();
    } else if constexpr (use_tc<T, HD>()) {
      err = cudaFuncGetAttributes(&attr, flash_attn_bwd_dkdv_wg_kernel<HD>);
      dynamic = wg_dkdv_smem_bytes<HD>();
    } else {
      err = cudaFuncGetAttributes(&attr, flash_attn_bwd_dkdv_kernel<HD, T>);
      dynamic = dkdv_smem_bytes<HD>();
    }
  } else if (which == 2) {
    if constexpr (use_wide<T, HD>()) {
      err = cudaFuncGetAttributes(&attr, flash_attn_bwd_dq_wide_kernel<HD>);
      dynamic = wide_dq_smem_bytes<HD>();
    } else if constexpr (use_tc<T, HD>()) {
      err = cudaFuncGetAttributes(&attr, flash_attn_bwd_dq_wg_kernel<HD>);
      dynamic = wg_dq_smem_bytes<HD>();
    } else {
      err = cudaFuncGetAttributes(&attr, flash_attn_bwd_dq_kernel<HD, T>);
      dynamic = dq_smem_bytes<HD>();
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes + dynamic;
  return 0;
}

// Returns CALL with HD and T bound to the runtime (hd, dtype).
#define DISPATCH(hd, dtype, CALL)                                                   \
  do {                                                                              \
    if (dtype == 0) {                                                               \
      using T = float;                                                              \
      switch (hd) {                                                                 \
        case 16: { constexpr int HD = 16; return CALL; }                            \
        case 64: { constexpr int HD = 64; return CALL; }                            \
        case 128: { constexpr int HD = 128; return CALL; }                          \
        case 256: { constexpr int HD = 256; return CALL; }                          \
      }                                                                             \
    } else if (dtype == 1) {                                                        \
      using T = __nv_bfloat16;                                                      \
      switch (hd) {                                                                 \
        case 16: { constexpr int HD = 16; return CALL; }                            \
        case 64: { constexpr int HD = 64; return CALL; }                            \
        case 128: { constexpr int HD = 128; return CALL; }                          \
        case 256: { constexpr int HD = 256; return CALL; }                          \
      }                                                                             \
    }                                                                               \
    return (int)cudaErrorInvalidValue;                                              \
  } while (0)

}  // namespace

// Each launches one kernel on `stream` and returns cudaGetLastError() of
// the launch (0 on success).  dtype: 0 = float32, 1 = bfloat16; window <= 0
// means no window.  The caller has checked shapes, types, contiguity,
// alignment and the device, and runs them in this order: pre (D), then dkdv
// and dq, which read D.
extern "C" int flash_attn_bwd_pre(const void* o, const void* dout, void* delta, int B, int S,
                                  int H, int hd, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH(hd, dtype, (pre_t<HD, T>(o, dout, delta, B, S, H, st)));
}

// splits: the parts of each key tile's query walk, one block each (1 but at
// bf16 head_dim 256); with splits > 1 the kernel writes f32 partial dK (times
// the scale) and dV into dk_part and dv_part, (splits, B, S, KH, hd) each, and
// leaves dk and dv to the caller's sum over the parts.
extern "C" int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   void* dk_part, void* dv_part, int B, int S, int H, int KH,
                                   int hd, int dtype, float scale, int causal, int window,
                                   int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH(hd, dtype, (dkdv_t<HD, T>(q, k, v, dout, lse, delta, dk, dv, dk_part, dv_part, B, S,
                                     H, KH, scale, causal, window, splits, st)));
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int S,
                                 int H, int KH, int hd, int dtype, float scale, int causal,
                                 int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DISPATCH(hd, dtype, (dq_t<HD, T>(q, k, v, dout, lse, delta, dq, B, S, H, KH, scale, causal,
                                   window, st)));
}

// Registers, local bytes and shared bytes of kernel `which` (0 pre, 1 dkdv,
// 2 dq) at (hd, dtype); returns a CUDA error code (0 on success).
extern "C" int flash_attn_bwd_attributes(int which, int hd, int dtype, int* regs,
                                         int* local_bytes, int* smem_bytes) {
  DISPATCH(hd, dtype, (attributes_t<HD, T>(which, regs, local_bytes, smem_bytes)));
}

// One warpgroup product of flash_attn_bwd_wgmma_probe_kernel<hd> (hd 16 or
// 64; which 0 or 1, as described there) on x, y (bf16) into d (f32), for
// the tests; returns a CUDA error code (0 on success).
extern "C" int flash_attn_bwd_wgmma_probe(const void* x, const void* y, void* d, int hd,
                                          int which, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + 2 * TC_ROWS * TC_ROWS * 2;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  if (hd == 16) {
    flash_attn_bwd_wgmma_probe_kernel<16><<<1, TC_THREADS, smem, st>>>(
        xb, yb, static_cast<float*>(d), which);
  } else if (hd == 64) {
    flash_attn_bwd_wgmma_probe_kernel<64><<<1, TC_THREADS, smem, st>>>(
        xb, yb, static_cast<float*>(d), which);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
