// Flash-attention forward for Hopper (sm_90a): causal, local-window or
// non-causal GQA self-attention with an online softmax.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_kernel`) of
// src/repro/kernels/flash_attention/kernel.py.  It computes what that kernel
// computes, not block by block:
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / (H/KH)] / sqrt(hd)) v[b, j, h / (H/KH)]
// over the keys j that the masks allow (causal: j <= i; window: i - j < window).
// Layouts are those of the JAX package's public function: q and o are
// (B, S, H, hd), k and v are (B, S, KH, hd), all contiguous.
//
// Numerics follow the TPU kernel: scores, running max m, denominator l and
// the output accumulator are f32; the finite -1e30 sentinel marks masked
// scores and l is guarded by max(l, 1e-30).  A masked key adds exactly zero,
// so rows that see no key in a tile are untouched by it, and a ragged tail
// (S not a multiple of the tile) is masked like any other key: any S >= 1.
// The KV loop bounds are computed per query tile from the causal and window
// masks, so fully masked KV tiles are neither loaded nor computed (the TPU
// kernel's block skip), and the most expensive causal tiles are issued first
// so the tail of the grid is short.
//
// Two kernels, chosen by the input type:
//
// bf16 inputs: `flash_attn_fwd_tc_kernel`, both products on the tensor cores.
// What bounds it on the H100: at qwen3-0.6b's serving shape (B=4, S=2048,
// H=16, KH=8, hd=64, causal) the work is 34.4 GFLOP (0.0348 ms at 989
// TFLOP/s) against about 50 MB of q, k, v and o (0.015 ms at 3.35 TB/s); at
// recurrentgemma-2b's (B=4, S=2048, H=10, KH=1, hd=256, window 2048) 85.9
// GFLOP (0.0869 ms) against 92.3 MB (0.028 ms).  Both are bound by
// operations, so the design keeps the tensor cores fed:
//   * S = Q.K^T and O += P.V are `mma.sync.aligned.m16n8k16` with bf16
//     operands and f32 accumulators; each warp owns 16 query rows, so its
//     row statistics live in the four lanes of a quad (two shuffles reduce
//     a row);
//   * Q, K and V stay bf16 in shared memory, in rows of 16-byte chunks whose
//     chunk index is XOR-swizzled by the row, so every `ldmatrix` (eight rows
//     at one chunk column) and every `cp.async` store touches eight distinct
//     bank groups; K is read as the B operand by `ldmatrix`, V by
//     `ldmatrix.trans`;
//   * K and V tiles come in by `cp.async` (16 bytes a thread) into two
//     stages, so tile j+1 is in flight while tile j is computed; shared
//     memory above 48 KB is dynamic, after
//     cudaFuncAttributeMaxDynamicSharedMemorySize;
//   * P never leaves registers: the S accumulator fragment of two key
//     n-tiles is, element for element, the A fragment of one k-slice of
//     P.V, so it is rescaled, exponentiated and packed to bf16 in place (the
//     one rounding the CUDA-core kernel does not make; l sums P in f32);
//   * the softmax works in base 2 with scale * log2(e) folded into one
//     FFMA a score, p = 2^(s c - m c), and exp2f's one-instruction form
//     (ex2.approx.ftz); masks are tested only in tiles that cross the
//     diagonal, the window's edge or the ragged tail, interior tiles take no
//     per-element test, and a warp whose 16 rows see no key of a tile skips
//     it;
//   * Q stays in shared memory and each 16-wide k-slice of it is loaded by
//     `ldmatrix` just before its mma: holding Q's fragments in registers for
//     the whole KV loop spilled at hd 64 under the 128-register cap that two
//     256-thread blocks an SM need, and ran no faster; at hd 256 the O
//     accumulator alone is 128 f32 a thread;
//   * the tiling (TcConfig) is chosen from ptxas's report and the card's
//     times (tools/flash_tiles.py times other rows beside it): 128 query
//     rows and 8 warps a block and 64 keys a tile at both serving head_dims;
//     two blocks an SM at hd 64 (48 KB of shared memory, the 128-register
//     cap), one at hd 256 (192 KB), where 64-key tiles read Q half as often
//     per mma as 32-key tiles would.
// What still holds it above that bound (PERF.md): each mma.sync of a
// 16-row warp reads its B operand (256 bytes of K or V) from shared memory,
// so `ldmatrix` traffic rather than the tensor cores sets the pace, and at
// hd 64 the exponentials (one SFU op a score) cost about as much as the
// products and do not overlap them.  wgmma, TMA and warp specialisation are
// later work.
//
// f32 inputs: `flash_attn_fwd_simt_kernel`, both products on the CUDA cores
// in f32 with no rounding of P; its numerics are the yardstick of the f32
// gates.  One block per (batch * head, query tile); four threads per query
// row (eight at hd 128 and sixteen at hd 256, so that a thread holds at
// most four float4 chunks of q and of the accumulator and stays under 128
// registers without spilling), each owning float4 chunks of head_dim
// interleaved across the lanes, so a K or V read from shared memory is a
// conflict-free 16-byte load broadcast to the warp's rows; K and V tiles of
// at most 4096 values staged as f32.
//
// Both kernels also write, when the caller passes an `lse` buffer (the
// training path's forward, for the backward kernels of flash_attn_bwd.cu),
// the log-sum-exp of each row's scaled scores, L = m + log l, as f32 in
// (B, H, S): the softmax is then P = exp(scale q.k - L).  Serving passes
// null; the tensor-core kernel then runs an instantiation without the
// write (WITH_LSE), so the served code is what it was without L.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ bool key_visible(int qpos, int kpos, int S, int causal, int window) {
  bool ok = kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel.

constexpr int SIMT_THREADS = 256;
// Threads per query row and query rows per block, by head_dim.
template <int HD> __host__ __device__ constexpr int simt_lanes() {
  return HD == 256 ? 16 : HD == 128 ? 8 : 4;
}
template <int HD> __host__ __device__ constexpr int simt_block_q() {
  return SIMT_THREADS / simt_lanes<HD>();
}
constexpr int CH = 16;  // keys per online-softmax update

template <int HD>
__global__ void __launch_bounds__(SIMT_THREADS, 2)
flash_attn_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int S, int H, int KH, float scale,
                           int causal, int window) {
  constexpr int LANES = simt_lanes<HD>();
  constexpr int BLOCK_Q = simt_block_q<HD>();
  constexpr int BK = HD > 64 ? 4096 / HD : 64;  // keys per shared-memory tile
  constexpr int C4 = HD / 4;      // float4 chunks per head_dim row
  constexpr int MY4 = C4 / LANES; // chunks owned by one thread
  __shared__ float4 ks[BK * C4];
  __shared__ float4 vs[BK * C4];

  const int bh = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int row = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int q0 = tile * BLOCK_Q;
  const int qpos = q0 + row;
  const bool live = qpos < S;

  const size_t q_stride = (size_t)H * HD;   // between sequence positions of q and o
  const size_t kv_stride = (size_t)KH * HD; // between sequence positions of k and v
  const size_t q_off = ((size_t)b * S + qpos) * q_stride + (size_t)h * HD;
  const float* kbase = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
  const float* vbase = v + (size_t)b * S * kv_stride + (size_t)kh * HD;

  float4 qr[MY4], acc[MY4];
#pragma unroll
  for (int i = 0; i < MY4; ++i) {
    const int d = 4 * (lane + LANES * i);
    qr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      const float* src = q + q_off + d;
      qr[i] = make_float4(src[0] * scale, src[1] * scale, src[2] * scale, src[3] * scale);
    }
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;

  // The keys any row of this tile can see.
  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, q0 + BLOCK_Q);
  if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;

  float* kf = reinterpret_cast<float*>(ks);
  float* vf = reinterpret_cast<float*>(vs);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // every row is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * HD; idx += SIMT_THREADS) {
      const int j = idx / HD, d = idx % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < S) {
        const size_t off = (size_t)(k0 + j) * kv_stride + d;
        kx = kbase[off];
        vx = vbase[off];
      }
      kf[idx] = kx;
      vf[idx] = vx;
    }
    __syncthreads();

    // The tile's keys in chunks of CH, one online-softmax update per chunk:
    // few live scores keep the thread under 128 registers (two blocks per SM).
#pragma unroll 1
    for (int c0 = 0; c0 < BK && k0 + c0 < k_end; c0 += CH) {
      float s[CH];
      float chunk_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < MY4; ++i) {
          const float4 kk = ks[(c0 + j) * C4 + lane + LANES * i];
          part += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z + qr[i].w * kk.w;
        }
        // all 32 lanes take part: rows past S compute on zeros and store nothing
#pragma unroll
        for (int off = 1; off < LANES; off *= 2)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[j] = key_visible(qpos, k0 + c0 + j, S, causal, window) ? part : NEG_INF;
        chunk_max = fmaxf(chunk_max, s[j]);
      }
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < MY4; ++i) {
        acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p =
            key_visible(qpos, k0 + c0 + j, S, causal, window) ? expf(s[j] - m_new) : 0.f;
        l += p;
#pragma unroll
        for (int i = 0; i < MY4; ++i) {
          const float4 vv = vs[(c0 + j) * C4 + lane + LANES * i];
          acc[i].x += p * vv.x; acc[i].y += p * vv.y; acc[i].z += p * vv.z; acc[i].w += p * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (live) {
    const float denom = fmaxf(l, 1e-30f);
    // m and l are the same in every lane of the row (the scores are reduced
    // across its lanes); the scores were scaled with q
    if (lse != nullptr && lane == 0) lse[((size_t)b * H + h) * S + qpos] = m + logf(denom);
#pragma unroll
    for (int i = 0; i < MY4; ++i) {
      float* dst = o + q_off + 4 * (lane + LANES * i);
      dst[0] = acc[i].x / denom;
      dst[1] = acc[i].y / denom;
      dst[2] = acc[i].z / denom;
      dst[3] = acc[i].w / denom;
    }
  }
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int H, int KH, float scale, int causal, int window, cudaStream_t stream) {
  const dim3 grid(B * H, (S + simt_block_q<HD>() - 1) / simt_block_q<HD>());
  flash_attn_fwd_simt_kernel<HD><<<grid, SIMT_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KH, scale, causal,
      window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel.

// Query rows (BM, 16 per warp) and keys (BN) of a tile, and the blocks an SM
// should hold (the register cap of __launch_bounds__), by head_dim.
template <int HD> struct TcConfig;
template <> struct TcConfig<16> { static constexpr int BM = 64, BN = 64, MIN_BLOCKS = 4; };
template <> struct TcConfig<64> { static constexpr int BM = 128, BN = 64, MIN_BLOCKS = 2; };
template <> struct TcConfig<128> { static constexpr int BM = 64, BN = 64, MIN_BLOCKS = 2; };
template <> struct TcConfig<256> { static constexpr int BM = 128, BN = 64, MIN_BLOCKS = 1; };

// A warp per 16 query rows.
template <int HD> __host__ __device__ constexpr int tc_threads() { return TcConfig<HD>::BM * 2; }
// Q tile, then two stages of K, then two of V, all bf16.
template <int HD> __host__ __device__ constexpr int tc_smem_bytes() {
  return (TcConfig<HD>::BM + 4 * TcConfig<HD>::BN) * HD * 2;
}

#include "flash_common.cuh"

// Fragment layouts of m16n8k16 (lane = 4 g + t): the A fragment holds rows g
// and g + 8 at columns 2t, 2t + 1 (regs 0, 1) and 2t + 8, 2t + 9 (regs 2,
// 3); the B fragment rows (k) 2t, 2t + 1 and 2t + 8, 2t + 9 at column g; the
// f32 accumulator rows g (elements 0, 1) and g + 8 (2, 3) at columns 2t, 2t + 1.
template <int HD, bool WITH_LSE>
__global__ void __launch_bounds__(TcConfig<HD>::BM * 2, TcConfig<HD>::MIN_BLOCKS)
flash_attn_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int S, int H, int KH, float scale_log2,
                         int causal, int window) {
  constexpr int BM = TcConfig<HD>::BM, BN = TcConfig<HD>::BN;
  constexpr int THREADS = tc_threads<HD>();
  constexpr int W = HD / 8;    // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-slices of Q.K^T
  constexpr int NT = BN / 8;   // key n-tiles of S
  constexpr int DT = HD / 8;   // head_dim n-tiles of O
  constexpr uint32_t STAGE_BYTES = BN * HD * 2;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_addr(smem);
  const uint32_t ks = qs + BM * HD * 2;
  const uint32_t vs = ks + 2 * STAGE_BYTES;

  const int tile = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = tile * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;    // fragment row group and column pair
  const int mat = lane / 8, r8 = lane % 8; // ldmatrix: which 8x8 matrix, which row of it
  const int wq0 = q0 + 16 * warp;          // the warp's first query row
  const int rows[2] = {wq0 + g, wq0 + g + 8};

  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KH * HD;
  const __nv_bfloat16* qbase = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const __nv_bfloat16* kbase = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
  const __nv_bfloat16* vbase = v + (size_t)b * S * kv_stride + (size_t)kh * HD;

  // The keys any row of this tile can see: at least one tile, since q0 < S.
  int k_begin = 0, k_end = S;
  if (causal) k_end = min(S, q0 + BM);
  if (window > 0) k_begin = max(0, q0 - window + 1) / BN * BN;
  const int n_tiles = (k_end - k_begin + BN - 1) / BN;

  // Copies: each thread moves chunk c_ld of rows r_ld, r_ld + RS, ... of a
  // tile, walking a pointer; the swizzle repeats every PERIOD of those rows.
  constexpr int RS = THREADS / W;
  constexpr int PERIOD = RS >= 8 ? 1 : 8 / RS;
  static_assert(THREADS % W == 0 && (BM % (RS * PERIOD)) == 0 && (BN % (RS * PERIOD)) == 0,
                "whole copy rounds");
  const int r_ld = threadIdx.x / W, c_ld = threadIdx.x % W;
  uint32_t dst_ld[PERIOD];
#pragma unroll
  for (int i = 0; i < PERIOD; ++i) dst_ld[i] = swizzle<W>(r_ld + i * RS, c_ld);
  auto dst_of = [&](int i) {
    return dst_ld[i % PERIOD] + (uint32_t)((i / PERIOD) * PERIOD * RS * W * 16);
  };

  auto load_kv = [&](int k0, uint32_t stage) {
    const size_t first = (size_t)(k0 + r_ld) * kv_stride + 8 * c_ld;
    const __nv_bfloat16* ksrc = kbase + first;
    const __nv_bfloat16* vsrc = vbase + first;
#pragma unroll
    for (int i = 0; i < BN / RS; ++i) {
      const bool ok = k0 + r_ld + i * RS < S;
      const uint32_t dst = stage * STAGE_BYTES + dst_of(i);
      cp_async16(ks + dst, ok ? ksrc : kbase, ok);
      cp_async16(vs + dst, ok ? vsrc : vbase, ok);
      ksrc += RS * kv_stride;
      vsrc += RS * kv_stride;
    }
  };

  {
    const __nv_bfloat16* qsrc = qbase + (size_t)(q0 + r_ld) * q_stride + 8 * c_ld;
#pragma unroll
    for (int i = 0; i < BM / RS; ++i) {
      const bool ok = q0 + r_ld + i * RS < S;
      cp_async16(qs + dst_of(i), ok ? qsrc : qbase, ok);
      qsrc += RS * q_stride;
    }
  }
  load_kv(k_begin, 0);
  cp_async_commit();  // Q and the first K and V tile, one group

  // ldmatrix reads: the A operand (Q, and V by .trans) takes rows + 8 in
  // matrices 1 and 3 and chunk + 1 in matrices 2 and 3; the B operand (K)
  // the other way round.
  const LaneReads<W> a_reads(r8, mat & 1, mat >> 1), b_reads(r8, mat >> 1, mat & 1);
  const uint32_t qw = qs + 16 * warp * W * 16;  // the warp's 16 rows of Q

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g and g + 8; l of this lane's keys

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BN;
    const uint32_t stage = j & 1;
    if (j + 1 < n_tiles) {
      load_kv(k0 + BN, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile j has arrived; tile j + 1 is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Skip a tile none of the warp's rows can see (warp-uniform).
    const bool unseen = (causal && k0 > wq0 + 15) || (window > 0 && k0 + BN - 1 <= wq0 - window);
    if (!unseen) {
      const uint32_t kst = ks + stage * STAGE_BYTES, vst = vs + stage * STAGE_BYTES;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];  // the A fragment of k-slice kk of the warp's 16 rows of Q
        ldmatrix_x4(a, qw + a_reads.at(0, 2 * kk));
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {  // key n-tiles 2p and 2p + 1
          uint32_t bk[4];
          ldmatrix_x4(bk, kst + b_reads.at(16 * p, 2 * kk));
          mma_bf16(s[2 * p], a, bk[0], bk[1]);
          mma_bf16(s[2 * p + 1], a, bk[2], bk[3]);
        }
      }

      // Masks only where the tile crosses an edge: a masked score becomes
      // the sentinel.
      const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > wq0) ||
                        (window > 0 && wq0 + 15 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!key_visible(rows[e >> 1], k0 + 8 * n + 2 * t + (e & 1), S, causal, window))
              s[n][e] = NEG_INF;
      }

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      // The running max stays in the scores' scale; each exponent is one
      // FFMA, p = 2^(s c - m c) with c = scale * log2(e).
      float alpha[2], mc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = fast_exp2((m[i] - mx[i]) * scale_log2);
        m[i] = mx[i];
        // A row that has seen no key yet (m is the sentinel) takes mc = 0,
        // so its masked scores still give 2^(-1e30 c) = 0.
        mc[i] = mx[i] == NEG_INF ? 0.f : mx[i] * scale_log2;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= alpha[0]; acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1]; acc[d][3] *= alpha[1];
      }
      // P in place of S: l sums it in f32, the P.V product takes it packed
      // to bf16 pairs (rows g and g + 8).  A masked score gives
      // 2^(-1e30 c - mc) = 0 with no test.
      uint32_t pk[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = fast_exp2(fmaf(s[n][e], scale_log2, -mc[e >> 1]));
          l[e >> 1] += s[n][e];
        }
        pk[n][0] = pack_bf16(s[n][0], s[n][1]);
        pk[n][1] = pack_bf16(s[n][2], s[n][3]);
      }

      // O += P.V: the P pairs of key n-tiles 2kk and 2kk + 1 are the A
      // fragment of k-slice kk.
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                               pk[2 * kk + 1][1]};
#pragma unroll
        for (int p = 0; p < DT / 2; ++p) {  // head_dim n-tiles 2p and 2p + 1
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vst + a_reads.at(16 * kk, 2 * p));
          mma_bf16(acc[2 * p], a, bv[0], bv[1]);
          mma_bf16(acc[2 * p + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    // m is the raw score's max, the same in the four lanes of the quad:
    // L = scale m + ln l = (m c + log2 l) ln 2
    if constexpr (WITH_LSE) {
      if (t == 0 && rows[i] < S)
        lse[((size_t)b * H + h) * S + rows[i]] = (m[i] * scale_log2 + log2f(denom)) * LN2;
    }
    if (rows[i] < S) {
      __nv_bfloat16* dst = o + ((size_t)b * S + rows[i]) * q_stride + (size_t)h * HD + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<uint32_t*>(dst + 8 * d) =
            pack_bf16(acc[d][2 * i] / denom, acc[d][2 * i + 1] / denom);
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
              int H, int KH, float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = lse != nullptr ? flash_attn_fwd_tc_kernel<HD, true>
                               : flash_attn_fwd_tc_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tc_smem_bytes<HD>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + TcConfig<HD>::BM - 1) / TcConfig<HD>::BM);
  kernel<<<grid, tc_threads<HD>(), tc_smem_bytes<HD>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, H, KH,
      scale * LOG2E, causal, window);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v, void* o, float* lse, int B,
              int S, int H, int KH, float scale, int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch_simt<HD>(q, k, v, o, lse, B, S, H, KH, scale, causal, window, stream);
  if (dtype == 1)
    return launch_tc<HD>(q, k, v, o, lse, B, S, H, KH, scale, causal, window, stream);
  return (int)cudaErrorInvalidValue;
}

// The compiled kernel's registers, local memory (spills and stack) and the
// shared memory a block takes (static plus dynamic); for bf16 the served
// instantiation, without L.
template <int HD>
int attributes_hd(int dtype, int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = dtype == 0
                        ? cudaFuncGetAttributes(&attr, flash_attn_fwd_simt_kernel<HD>)
                        : cudaFuncGetAttributes(&attr, flash_attn_fwd_tc_kernel<HD, false>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes + (dtype == 0 ? 0 : tc_smem_bytes<HD>());
  return 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).  dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
// window <= 0 means no window.  `lse`, when not null, receives each row's
// log-sum-exp of its scaled scores as f32 in (B, H, S).  The caller has
// checked shapes, types, contiguity and the device.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int S, int H, int KH, int hd, int dtype,
                              float scale, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* L = static_cast<float*>(lse);
  switch (hd) {
    case 16: return launch_hd<16>(dtype, q, k, v, o, L, B, S, H, KH, scale, causal, window, st);
    case 64: return launch_hd<64>(dtype, q, k, v, o, L, B, S, H, KH, scale, causal, window, st);
    case 128: return launch_hd<128>(dtype, q, k, v, o, L, B, S, H, KH, scale, causal, window, st);
    case 256: return launch_hd<256>(dtype, q, k, v, o, L, B, S, H, KH, scale, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers, local bytes and shared bytes of the kernel that (hd, dtype)
// launches; returns a CUDA error code (0 on success).
extern "C" int flash_attn_fwd_attributes(int hd, int dtype, int* regs, int* local_bytes,
                                         int* smem_bytes) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return attributes_hd<16>(dtype, regs, local_bytes, smem_bytes);
    case 64: return attributes_hd<64>(dtype, regs, local_bytes, smem_bytes);
    case 128: return attributes_hd<128>(dtype, regs, local_bytes, smem_bytes);
    case 256: return attributes_hd<256>(dtype, regs, local_bytes, smem_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}
