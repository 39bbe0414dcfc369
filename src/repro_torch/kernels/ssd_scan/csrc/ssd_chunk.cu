// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_chunk_pallas` (body `_kernel`) of
// src/repro/kernels/ssd_scan/kernel.py.  It computes what that kernel
// computes, not block by block.  For each (batch b, head h, chunk c of Q
// sequence rows), with g = h / (H/G) the group of head h and all sums in f32:
//   y_intra[q]  = sum_{k <= q} (C_q . B_k) * exp(cum_q - cum_k) * dt_k * x_k   (Q x P)
//   chunk_in    = sum_k (x_k * dt_k * exp(cum_end - cum_k)) (outer) B_k        (P x N)
// where cum is the within-chunk cumulative sum of A * dt (made outside).  The
// state passing between chunks and the carry term stay in PyTorch (ops.py),
// as they stay in jnp in the JAX package.
//
// Layouts are the model's, not the TPU kernel's head-flattened ones: x is
// (Bt, S, H, P); dt and cum are (Bt, S, H) f32; B and C are (Bt, S, G, N),
// read by group (never repeated to every head); y_intra is (Bt, S, H, P) f32
// and chunk_in (Bt, nc, H, P, N) f32.  x, B and C are f32 or bf16.
//
// Numerics.  The decay is formed as exp(cum_q - cum_k) only where q >= k
// (masked BEFORE the exp, as the TPU kernel does): with mamba2-780m's A down
// to -16 and dt near 0.8, cum falls to about -3,000 within a 256-row chunk,
// and the factored form exp(cum_q) * exp(-cum_k) would overflow to inf and
// give NaN.  exp(cum_end - cum_k) <= 1 is safe.  Built without fast math.
//
// What bounds it on the H100.  At mamba2-780m's serving shape (Bt 4, S 2048,
// H 48, P 64, G 1, N 128, chunk 256, bf16 inputs) it must move about 209 MB
// (x 50 MB, dt and cum 3 MB, B and C 4 MB, y_intra 101 MB and chunk_in 50 MB,
// both f32) and do about 26 GFLOP: bytes bound it (0.062 ms at 3.35 TB/s
// against 0.026 ms of bf16 tensor-core work).  This first version does its
// products on the CUDA cores in f32 (67 TFLOP/s), so it cannot beat about
// 0.4 ms; tensor cores (mma/wgmma), TMA, and sharing C.B^T across the heads of
// a group (with G = 1 it does not depend on the head) are later work.
// What the design does about the FMA and shared-memory limits:
//   * one block per (batch * head, chunk): 1,536 blocks at the serving shape;
//   * cum and dt of the chunk are staged once; the chunk is walked in 64-row
//     query tiles, and for each in the 64-row key tiles at or below it (the
//     causal mask skips the rest), with C of the query tile, B and x of the
//     key tile staged in shared memory as f32 and reused by all 256 threads;
//   * a thread forms a 4 x 4 block of scores from float4 reads of rows padded
//     to N + 4 floats (conflict-free), masks and decays them, and the tile of
//     scores goes through shared memory into y's f32 accumulators (registers);
//   * chunk_in is a second pass over the chunk's key tiles, each thread
//     accumulating a (P x 4) strip of the (P x N) state term in registers;
//   * the shared memory (104 KB at the serving shape) leaves room for two
//     blocks per SM; above 48 KB it is dynamic shared memory, asked for with
//     cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;         // rows of a query or key tile
constexpr int MAX_CHUNK = 256;   // the wrapper refuses larger chunks
constexpr int S_LD = TILE + 16;  // row stride of the score tile: conflict-free stores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Rows [0, TILE) of a global array (row stride `ld` elements, W wide) into
// shared memory [TILE][LDS] as f32, each row scaled by `w[row]` if given.
// Rows at or past `rows` become zero.
template <typename T, int W, int LDS>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t ld, int rows,
                                      const float* w = nullptr) {
  constexpr int W4 = W / 4;
  for (int idx = threadIdx.x; idx < TILE * W4; idx += THREADS) {
    const int r = idx / W4, col = 4 * (idx % W4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const T* s = src + r * ld + col;
      const float scale = w ? w[r] : 1.f;
      v = make_float4(to_f32(s[0]) * scale, to_f32(s[1]) * scale,
                      to_f32(s[2]) * scale, to_f32(s[3]) * scale);
    }
    *reinterpret_cast<float4*>(dst + r * LDS + col) = v;
  }
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x += a * b.x; acc.y += a * b.y; acc.z += a * b.z; acc.w += a * b.w;
}

template <int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * MAX_CHUNK + 2 * TILE * (N + 4) + TILE * P + TILE * S_LD);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ chunk_in, int S, int H, int G, int chunk) {
  static_assert(P % 4 == 0 && N % 4 == 0 && THREADS % (P / 4) == 0, "bad (P, N)");
  constexpr int N_LD = N + 4;  // padded rows of the B and C tiles
  extern __shared__ float4 smem4[];
  float* cum_s = reinterpret_cast<float*>(smem4);  // [MAX_CHUNK]
  float* dt_s = cum_s + MAX_CHUNK;                 // [MAX_CHUNK], later the chunk_in weight
  float* c_s = dt_s + MAX_CHUNK;                   // [TILE][N_LD]
  float* b_s = c_s + TILE * N_LD;                  // [TILE][N_LD]
  float* x_s = b_s + TILE * N_LD;                  // [TILE][P]
  float* s_s = x_s + TILE * P;                     // [TILE][S_LD]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const size_t row0 = (size_t)b * S + (size_t)c * chunk;  // the chunk's first row
  const size_t x_ld = (size_t)H * P, bc_ld = (size_t)G * N;
  const T* xc = x + row0 * x_ld + (size_t)h * P;
  const T* bc = Bm + row0 * bc_ld + (size_t)g * N;
  const T* cc = Cm + row0 * bc_ld + (size_t)g * N;
  float* yc = y + row0 * x_ld + (size_t)h * P;

  for (int k = tid; k < MAX_CHUNK; k += THREADS) {
    const bool in = k < chunk;
    cum_s[k] = in ? cum[(row0 + k) * H + h] : 0.f;
    dt_s[k] = in ? dt[(row0 + k) * H + h] : 0.f;
  }
  const int n_tiles = (chunk + TILE - 1) / TILE;

  // ---- y_intra.  Scores: a 16 x 16 grid of threads, each with rows
  // sy + 16 i and keys sx + 16 j (i, j < 4).  y: CG groups of 4 columns of P,
  // each thread with rows yr + RG i (i < RPT).
  const int sy = tid / 16, sx = tid % 16;
  constexpr int CG = P / 4, RG = THREADS / CG, RPT = TILE / RG;
  const int yr = tid / CG, ycol = 4 * (tid % CG);

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // cum_s and dt_s are written; no thread still reads c_s
    stage<T, N, N_LD>(c_s, cc + q0 * bc_ld, bc_ld, chunk - q0);
    float4 acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * TILE;
      __syncthreads();  // no thread still reads b_s, x_s or s_s
      stage<T, N, N_LD>(b_s, bc + k0 * bc_ld, bc_ld, chunk - k0);
      stage<T, P, P>(x_s, xc + k0 * x_ld, x_ld, chunk - k0);
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(c_s + (sy + 16 * i) * N_LD + n);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(b_s + (sx + 16 * j) * N_LD + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] += cv[i].x * bv[j].x + cv[i].y * bv[j].y + cv[i].z * bv[j].z +
                       cv[i].w * bv[j].w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = sy + 16 * i, q = q0 + ql;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kl = sx + 16 * j, k = k0 + kl;
          // mask before the exp: exp(cum_q - cum_k) only where q >= k
          s_s[ql * S_LD + kl] =
              (k <= q && q < chunk) ? s[i][j] * expf(cum_s[q] - cum_s[k]) * dt_s[k] : 0.f;
        }
      }
      __syncthreads();

      const int k_hi = min(TILE, chunk - k0);  // keys past the chunk add zero
      for (int kk = 0; kk < k_hi; kk += 4) {
        float4 xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          xv[u] = *reinterpret_cast<const float4*>(x_s + (kk + u) * P + ycol);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float4 sv = *reinterpret_cast<const float4*>(s_s + (yr + RG * i) * S_LD + kk);
          fma4(acc[i], sv.x, xv[0]);
          fma4(acc[i], sv.y, xv[1]);
          fma4(acc[i], sv.z, xv[2]);
          fma4(acc[i], sv.w, xv[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int q = q0 + yr + RG * i;
      if (q < chunk) *reinterpret_cast<float4*>(yc + q * x_ld + ycol) = acc[i];
    }
  }

  // ---- chunk_in.  NG groups of 4 columns of N; thread rows cp + PG i of P.
  constexpr int NG = N / 4;
  constexpr int PG = THREADS / NG < P ? THREADS / NG : P;
  constexpr int RPC = P / PG;
  const int cp = tid / NG, cn = 4 * (tid % NG);
  const bool live = tid < NG * PG;
  __syncthreads();  // phase 1 is done with dt_s
  const float cum_end = cum_s[chunk - 1];
  for (int k = tid; k < chunk; k += THREADS) dt_s[k] *= expf(cum_end - cum_s[k]);
  float4 cacc[RPC];
#pragma unroll
  for (int i = 0; i < RPC; ++i) cacc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the weights are written; no thread still reads b_s or x_s
    stage<T, N, N_LD>(b_s, bc + k0 * bc_ld, bc_ld, chunk - k0);
    stage<T, P, P>(x_s, xc + k0 * x_ld, x_ld, chunk - k0, dt_s + k0);
    __syncthreads();
    if (live) {
      const int k_hi = min(TILE, chunk - k0);
      for (int kk = 0; kk < k_hi; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(b_s + kk * N_LD + cn);
#pragma unroll
        for (int i = 0; i < RPC; ++i) fma4(cacc[i], x_s[kk * P + cp + PG * i], bv);
      }
    }
  }
  if (live) {
    float* dst = chunk_in + (((size_t)b * nc + c) * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < RPC; ++i)
      *reinterpret_cast<float4*>(dst + (size_t)(cp + PG * i) * N + cn) = cacc[i];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* cum, const void* B, const void* C,
           void* y, void* chunk_in, int Bt, int S, int H, int G, int chunk,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, N>();
  auto kernel = ssd_chunk_kernel<T, P, N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Bt * H, S / chunk);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<float*>(y), static_cast<float*>(chunk_in), S, H, G, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pn(const void* x, const void* dt, const void* cum, const void* B, const void* C,
              void* y, void* chunk_in, int Bt, int S, int H, int G, int P, int N,
              int chunk, cudaStream_t st) {
  if (P == 16 && N == 16) return launch<T, 16, 16>(x, dt, cum, B, C, y, chunk_in, Bt, S, H, G, chunk, st);
  if (P == 16 && N == 32) return launch<T, 16, 32>(x, dt, cum, B, C, y, chunk_in, Bt, S, H, G, chunk, st);
  if (P == 32 && N == 16) return launch<T, 32, 16>(x, dt, cum, B, C, y, chunk_in, Bt, S, H, G, chunk, st);
  if (P == 64 && N == 128) return launch<T, 64, 128>(x, dt, cum, B, C, y, chunk_in, Bt, S, H, G, chunk, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on
// success).  dtype of x, B and C: 0 = float32, 1 = bfloat16.  The caller has
// checked shapes, types, contiguity, the device, S % chunk == 0,
// 1 <= chunk <= 256 and H % G == 0.
extern "C" int ssd_chunk(const void* x, const void* dt, const void* cum, const void* B,
                         const void* C, void* y, void* chunk_in, int Bt, int S, int H,
                         int G, int P, int N, int chunk, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > MAX_CHUNK || S % chunk != 0 || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_pn<float>(x, dt, cum, B, C, y, chunk_in, Bt, S, H, G, P, N, chunk, st);
  if (dtype == 1)
    return launch_pn<__nv_bfloat16>(x, dt, cum, B, C, y, chunk_in, Bt, S, H, G, P, N, chunk, st);
  return (int)cudaErrorInvalidValue;
}
