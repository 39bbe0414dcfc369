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
//
// What bounds it on the H100.  At qwen3-0.6b's serving shape (B=4, S=2048,
// H=16, KH=8, hd=64, bf16, causal) the work is about 34 GFLOP against about
// 50 MB of q, k, v and o: the least time is the tensor cores' (about 35 us at
// 989 TFLOP/s), not memory.  At recurrentgemma-2b's (B=4, S=2048, H=10,
// KH=1, hd=256, window 2048, bf16, causal) it is 85.9 GFLOP, 0.0869 ms at
// 989 TFLOP/s, against 92.3 MB of q, k, v and o (0.028 ms at 3.35 TB/s):
// bound by operations too.  This first version does both products on the
// CUDA cores in f32, so it is bound by FMA issue and by shared-memory reads,
// far above that bound; wgmma, TMA and warp specialisation are later work.
// What the design does about the FMA/shared-memory limit:
//   * one block per (batch * head, query tile); the most expensive
//     causal tiles are issued first so the tail of the grid is short;
//   * four threads per query row (64 rows a block), each owning a quarter of
//     head_dim as float4 chunks interleaved across the four lanes, so a K or V
//     read from shared memory is one conflict-free 16-byte load broadcast to
//     the warp's eight rows, and a score needs two shuffles to finish;
//   * at hd 256, sixteen threads per query row (16 rows a block), so a thread
//     still owns 16 values of q and 16 of the accumulator, as at hd 64, and
//     stays under 128 registers without spilling; a warp's K or V read is 16
//     distinct float4s broadcast to its two rows, and a score takes four
//     shuffles;
//   * a K and a V tile of at most 4096 values each are staged in shared memory as f32
//     once per block and shared by all its rows (and, through the GQA map, the
//     same KV head serves H/KH query heads);
//   * the KV loop bounds are computed per query tile from the causal and
//     window masks, so fully masked KV tiles are neither loaded nor computed
//     (the TPU kernel's block skip).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // threads per block
// Threads per query row and query rows per block, by head_dim.
template <int HD> __host__ __device__ constexpr int lanes() { return HD == 256 ? 16 : 4; }
template <int HD> __host__ __device__ constexpr int block_q() { return THREADS / lanes<HD>(); }
constexpr int CH = 16;       // keys per online-softmax update
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool key_visible(int qpos, int kpos, int S, int causal, int window) {
  bool ok = kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      int S, int H, int KH, float scale, int causal, int window) {
  constexpr int LANES = lanes<HD>();
  constexpr int BLOCK_Q = block_q<HD>();
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
  const T* kbase = k + (size_t)b * S * kv_stride + (size_t)kh * HD;
  const T* vbase = v + (size_t)b * S * kv_stride + (size_t)kh * HD;

  float4 qr[MY4], acc[MY4];
#pragma unroll
  for (int i = 0; i < MY4; ++i) {
    const int d = 4 * (lane + LANES * i);
    qr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      const T* src = q + q_off + d;
      qr[i] = make_float4(to_f32(src[0]) * scale, to_f32(src[1]) * scale,
                          to_f32(src[2]) * scale, to_f32(src[3]) * scale);
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
    for (int idx = threadIdx.x; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD, d = idx % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < S) {
        const size_t off = (size_t)(k0 + j) * kv_stride + d;
        kx = to_f32(kbase[off]);
        vx = to_f32(vbase[off]);
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
#pragma unroll
    for (int i = 0; i < MY4; ++i) {
      T* dst = o + q_off + 4 * (lane + LANES * i);
      dst[0] = from_f32<T>(acc[i].x / denom);
      dst[1] = from_f32<T>(acc[i].y / denom);
      dst[2] = from_f32<T>(acc[i].z / denom);
      dst[3] = from_f32<T>(acc[i].w / denom);
    }
  }
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, T* o, int B, int S, int H, int KH,
              float scale, int causal, int window, cudaStream_t stream) {
  const dim3 grid(B * H, (S + block_q<HD>() - 1) / block_q<HD>());
  flash_attn_fwd_kernel<T, HD><<<grid, THREADS, 0, stream>>>(q, k, v, o, S, H, KH, scale,
                                                             causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int hd, float scale, int causal, int window,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  switch (hd) {
    case 16: return launch_hd<T, 16>(qt, kt, vt, ot, B, S, H, KH, scale, causal, window, stream);
    case 64: return launch_hd<T, 64>(qt, kt, vt, ot, B, S, H, KH, scale, causal, window, stream);
    case 128: return launch_hd<T, 128>(qt, kt, vt, ot, B, S, H, KH, scale, causal, window, stream);
    case 256: return launch_hd<T, 256>(qt, kt, vt, ot, B, S, H, KH, scale, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).  dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// The caller has checked shapes, types, contiguity and the device.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              int B, int S, int H, int KH, int hd, int dtype,
                              float scale, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, B, S, H, KH, hd, scale, causal, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KH, hd, scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
