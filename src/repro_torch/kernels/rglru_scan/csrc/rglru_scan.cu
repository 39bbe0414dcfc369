// RG-LRU linear recurrence for Hopper (sm_90a):
//   h_t = a_t * h_{t-1} + u_t   over t = 0 .. S-1, from h_{-1} = h0 (or 0),
// per (batch b, channel r), with h in f32 and h_seq written in u's dtype.
//
// Replaces the TPU kernel `rglru_scan_pallas` (body `_kernel`) of
// src/repro/kernels/rglru_scan/kernel.py.  It computes what that kernel
// computes, not block by block: the TPU kernel walks a sequential grid axis
// over blocks of S and carries h across them in VMEM; Hopper's blocks run in
// no order, so here the sequence is cut into chunks of `chunk` steps that run
// at once, and the state is carried across them by composing chunk
// summaries.  Any B, S >= 1, R and chunk >= 1.  h_final is written in f32
// (the reference's Pallas path takes it from the output after the cast to
// u's dtype).
//
// Layouts are those of the JAX package's public function: a, u and h_seq
// are (B, S, R) and h0, h_final (B, R), all contiguous; a and u share one
// type, f32 or bf16; h0 and h_final are f32.  For training, the scan can
// also write every state in f32 (h_state, (B, S, R)), which the backward
// reads where h_seq is rounded to bf16.
//
// The forward is two kernels in stream order, with C = ceil(S / chunk)
// chunks and one thread per (b, chunk c, r), neighbouring threads on
// neighbouring r, so that every load and store is coalesced:
//   1. rglru_chunk_summary_kernel, chunks 0 .. C-2: walks its chunk from
//      h = 0 and writes (P_c, H_c) in f32 to the workspace ws (2, B, C, R):
//      P_c the product of the chunk's a (from 1), H_c its state from 0.
//   2. rglru_chunk_scan_kernel, chunks 0 .. C-1: composes h0 (or 0) with
//      (P_0, H_0) .. (P_{c-1}, H_{c-1}), h <- P h + H, at most C - 1 reads
//      of 8 bytes, then walks its chunk from that h, writing h_seq, h_state
//      when asked, and h_final from the last chunk.
// At C = 1 the first kernel is not launched and the second (its CHUNKED =
// false instantiation, with no composition) is one thread per (b, r) walking
// all S steps from h0.
//
// rglru_scan_bwd is the gradient, which the TPU has no kernel for (the JAX
// package differentiates its jnp scan): the same recurrence run backward,
//   g_t = dh_seq_t + a_{t+1} g_{t+1}  (g_{S-1} = dh_seq_{S-1} + dh_final),
//   du_t = g_t,  da_t = g_t h_{t-1},  dh0 = a_0 g_0,
// in the same two passes, run in reverse: rglru_chunk_summary_bwd_kernel
// walks chunks 1 .. C-1 backward from a carry of 0 and writes (P_c, X_c), the
// product of the chunk's a and the carry it hands to the chunk before;
// rglru_chunk_scan_bwd_kernel composes dh_final (or 0) with (P_{C-1},
// X_{C-1}) .. (P_{c+1}, X_{c+1}), x <- P x + X, then walks its chunk backward,
// writing da and du, and dh0 from the first chunk.
//
// Numerics.  Each step of a walk is a rounded f32 product and a rounded f32
// sum, __fmul_rn and __fadd_rn, which the compiler may not contract into an
// FMA; so is each composition.  The plain mirrors `rglru_scan_chunked_ref`
// and `rglru_scan_bwd_chunked_ref` (ref.py) take the same roundings in the
// same order, so kernels and mirrors agree to the bit.  Against the
// sequential oracles (`rglru_scan_ref`, `rglru_scan_bwd_ref`) the order of
// f32 operations changes only where a chunk's start state is composed: a few
// ulps there, which the decay then damps; at C = 1 they agree to the bit.
//
// What bounds it on the H100.  Bytes: at recurrentgemma-2b's training shape
// (B 1, S 2048, R 2560, a and u f32 from the gates) the forward must read a
// and u once and write h_seq once, 12 bytes an element, 62,914,560 B and
// 0.0188 ms at 3.35 TB/s; the backward reads a, h_state and dh_seq and writes
// da and du, 20 bytes an element, 0.0313 ms.  Their 2 and 3 flops an element
// are negligible.  Each step depends on the one before, so a thread keeps the
// loads of its next UNROLL steps in flight while it walks the current ones
// (2 x UNROLL loads in flight; a chunk's first loads are issued before its
// composition), and the card needs many threads to keep megabytes in flight:
// B x R = 2,560 chains at batch 1 are far too few, while B x C x R (66,560 at
// the 80-step chunks the wrapper takes there, about one wave of the scan
// kernels at 128 registers) are enough.  The chunked scan moves more bytes:
// the summary pass reads a and u (8 bytes an element) before the scan pass
// (12), and the backward's reads a and dh_seq (8) before its scan pass (20).
// Where B x R chains already fill the card, the wrapper (kernel.py,
// `chunk_length`) takes C = 1, and the extra pass is not run.  The loads past
// a chunk's edge are predicated, never branched around.  64 threads a block;
// __restrict__ pointers, no spills (`-Xptxas -v`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int THREADS = 64;  // channels r per block
constexpr int UNROLL = 16;   // steps a thread loads ahead of its chain

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Steps t0 .. t0 + UNROLL - 1 of one chain; at or past `end`, a = 1 and
// u = -0 leave h unchanged (1 * h + -0 == h exactly, and 1 * P == P).
template <typename T>
__device__ __forceinline__ void load_steps(const T* __restrict__ a, const T* __restrict__ u,
                                           int t0, int end, size_t R, float* ar, float* ur) {
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const int t = t0 + i;
    ar[i] = t < end ? to_f32(a[(size_t)t * R]) : 1.f;
    ur[i] = t < end ? to_f32(u[(size_t)t * R]) : -0.f;
  }
}

// Steps t0, t0 - 1, .. t0 - UNROLL + 1 of one chain, backward; below `lo`,
// a = 1 and d = -0 leave the carry unchanged (1 * (-0 + x) == x exactly).
template <typename T>
__device__ __forceinline__ void load_steps_back(const T* __restrict__ a, const T* __restrict__ d,
                                                int t0, int lo, size_t R, float* ar, float* dr) {
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const int t = t0 - i;
    ar[i] = t >= lo ? to_f32(a[(size_t)t * R]) : 1.f;
    dr[i] = t >= lo ? to_f32(d[(size_t)t * R]) : -0.f;
  }
}

// The same steps with the state entering each (h_{t-1}; h0 or 0 at t = 0):
// h_lo = max(lo, 1), one comparison, so that every load is predicated.
template <typename T>
__device__ __forceinline__ void load_steps_bwd(const T* __restrict__ a, const float* __restrict__ hst,
                                               const T* __restrict__ d, float h_init, int t0,
                                               int lo, int h_lo, size_t R, float* ar, float* hr,
                                               float* dr) {
  load_steps_back(a, d, t0, lo, R, ar, dr);
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const int t = t0 - i;
    hr[i] = t >= h_lo ? hst[(size_t)(t - 1) * R] : h_init;
  }
}

// Summaries of chunks 0 .. C-2: (P_c, H_c) into ws[0] and ws[1], each
// (B, C, R).  Grid (R / THREADS, C - 1, B).  Without a minimum of blocks in
// its launch bounds, ptxas held the f32 summary kernels to 64 registers and
// spilled.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
rglru_chunk_summary_kernel(const T* __restrict__ a, const T* __restrict__ u,
                           float* __restrict__ ws, int S, int R, int chunk) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (r >= R) return;
  const int C = (S + chunk - 1) / chunk;
  const int s0 = c * chunk, end = min(S, s0 + chunk);
  const size_t chain = (size_t)b * S * R + r;  // element (b, 0, r)
  const T* ab = a + chain;
  const T* ub = u + chain;
  float p = 1.f, h = 0.f;

  float a_cur[UNROLL], u_cur[UNROLL];
  load_steps(ab, ub, s0, end, R, a_cur, u_cur);
  for (int t0 = s0; t0 < end; t0 += UNROLL) {
    float a_next[UNROLL], u_next[UNROLL];
    load_steps(ab, ub, t0 + UNROLL, end, R, a_next, u_next);  // in flight meanwhile
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      p = __fmul_rn(a_cur[i], p);
      h = __fadd_rn(__fmul_rn(a_cur[i], h), u_cur[i]);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      a_cur[i] = a_next[i];
      u_cur[i] = u_next[i];
    }
  }
  const size_t k = ((size_t)b * C + c) * R + r;
  ws[k] = p;
  ws[(size_t)gridDim.z * C * R + k] = h;
}

// Chunk c's walk from h0 composed with the summaries of chunks 0 .. c-1.
// Grid (R / THREADS, C, B).  CHUNKED = false (C = 1) leaves the composition
// out: one thread walks its chain from h0.
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
rglru_chunk_scan_kernel(const T* __restrict__ a, const T* __restrict__ u,
                        const float* __restrict__ h0, const float* __restrict__ ws,
                        T* __restrict__ hs, float* __restrict__ h_final,
                        float* __restrict__ h_state, int S, int R, int chunk) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int c = CHUNKED ? blockIdx.y : 0, b = blockIdx.z;
  if (r >= R) return;
  const int C = CHUNKED ? gridDim.y : 1;
  const int s0 = c * chunk, end = CHUNKED ? min(S, s0 + chunk) : S;
  const size_t chain = (size_t)b * S * R + r;  // element (b, 0, r)
  const T* ab = a + chain;
  const T* ub = u + chain;
  T* ob = hs + chain;
  float a_cur[UNROLL], u_cur[UNROLL];
  load_steps(ab, ub, s0, end, R, a_cur, u_cur);  // in flight during the composition

  float h = h0 ? h0[(size_t)b * R + r] : 0.f;
  if (CHUNKED && c > 0) {
    const float* P = ws + (size_t)b * C * R + r;
    const float* H = P + (size_t)gridDim.z * C * R;
    for (int j0 = 0; j0 < c; j0 += UNROLL) {
      float p[UNROLL], x[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {  // all loads first: in flight together
        const int j = j0 + i;
        p[i] = j < c ? P[(size_t)j * R] : 1.f;
        x[i] = j < c ? H[(size_t)j * R] : -0.f;
      }
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) h = __fadd_rn(__fmul_rn(p[i], h), x[i]);
    }
  }

  for (int t0 = s0; t0 < end; t0 += UNROLL) {
    float a_next[UNROLL], u_next[UNROLL];
    load_steps(ab, ub, t0 + UNROLL, end, R, a_next, u_next);  // in flight meanwhile
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      h = __fadd_rn(__fmul_rn(a_cur[i], h), u_cur[i]);
      if (t0 + i < end) {
        ob[(size_t)(t0 + i) * R] = from_f32<T>(h);
        if (h_state) h_state[chain + (size_t)(t0 + i) * R] = h;
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      a_cur[i] = a_next[i];
      u_cur[i] = u_next[i];
    }
  }
  if (c == C - 1) h_final[(size_t)b * R + r] = h;
}

// Summaries of chunks 1 .. C-1 of the backward: (P_c, X_c) into ws[0] and
// ws[1].  Grid (R / THREADS, C - 1, B).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
rglru_chunk_summary_bwd_kernel(const T* __restrict__ a, const T* __restrict__ dh_seq,
                               float* __restrict__ ws, int S, int R, int chunk) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y + 1, b = blockIdx.z;
  if (r >= R) return;
  const int C = (S + chunk - 1) / chunk;
  const int s0 = c * chunk, end = min(S, s0 + chunk);
  const size_t chain = (size_t)b * S * R + r;
  const T* ab = a + chain;
  const T* db = dh_seq + chain;
  float p = 1.f, x = 0.f;

  float a_cur[UNROLL], d_cur[UNROLL];
  load_steps_back(ab, db, end - 1, s0, R, a_cur, d_cur);
  for (int t0 = end - 1; t0 >= s0; t0 -= UNROLL) {
    float a_next[UNROLL], d_next[UNROLL];
    load_steps_back(ab, db, t0 - UNROLL, s0, R, a_next, d_next);
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      p = __fmul_rn(a_cur[i], p);
      x = __fmul_rn(a_cur[i], __fadd_rn(d_cur[i], x));
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      a_cur[i] = a_next[i];
      d_cur[i] = d_next[i];
    }
  }
  const size_t k = ((size_t)b * C + c) * R + r;
  ws[k] = p;
  ws[(size_t)gridDim.z * C * R + k] = x;
}

// Chunk c's backward walk from dh_final composed with the summaries of
// chunks C-1 .. c+1.  Grid (R / THREADS, C, B); CHUNKED as in the forward.
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
rglru_chunk_scan_bwd_kernel(const T* __restrict__ a, const float* __restrict__ h_state,
                            const float* __restrict__ h0, const T* __restrict__ dh_seq,
                            const float* __restrict__ dh_final, const float* __restrict__ ws,
                            T* __restrict__ da, T* __restrict__ du, float* __restrict__ dh0,
                            int S, int R, int chunk) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int c = CHUNKED ? blockIdx.y : 0, b = blockIdx.z;
  if (r >= R) return;
  const int C = CHUNKED ? gridDim.y : 1;
  const int s0 = c * chunk, end = CHUNKED ? min(S, s0 + chunk) : S;
  const size_t chain = (size_t)b * S * R + r;
  const T* ab = a + chain;
  const float* hb = h_state + chain;
  const T* db = dh_seq + chain;
  const float h_init = (c == 0 && h0) ? h0[(size_t)b * R + r] : 0.f;
  const int h_lo = max(s0, 1);
  float a_cur[UNROLL], h_cur[UNROLL], d_cur[UNROLL];
  // in flight during the composition
  load_steps_bwd(ab, hb, db, h_init, end - 1, s0, h_lo, R, a_cur, h_cur, d_cur);

  float carry = dh_final ? dh_final[(size_t)b * R + r] : 0.f;  // a_{t+1} g_{t+1}
  if (CHUNKED && c < C - 1) {
    const float* P = ws + (size_t)b * C * R + r;
    const float* X = P + (size_t)gridDim.z * C * R;
    for (int j0 = C - 1; j0 > c; j0 -= UNROLL) {
      float p[UNROLL], x[UNROLL];
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {  // all loads first: in flight together
        const int j = j0 - i;
        p[i] = j > c ? P[(size_t)j * R] : 1.f;
        x[i] = j > c ? X[(size_t)j * R] : -0.f;
      }
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) carry = __fadd_rn(__fmul_rn(p[i], carry), x[i]);
    }
  }

  for (int t0 = end - 1; t0 >= s0; t0 -= UNROLL) {
    float a_next[UNROLL], h_next[UNROLL], d_next[UNROLL];
    load_steps_bwd(ab, hb, db, h_init, t0 - UNROLL, s0, h_lo, R, a_next, h_next, d_next);
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int t = t0 - i;
      if (t >= s0) {
        const float g = __fadd_rn(d_cur[i], carry);
        du[chain + (size_t)t * R] = from_f32<T>(g);
        da[chain + (size_t)t * R] = from_f32<T>(__fmul_rn(g, h_cur[i]));
        carry = __fmul_rn(a_cur[i], g);
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      a_cur[i] = a_next[i];
      h_cur[i] = h_next[i];
      d_cur[i] = d_next[i];
    }
  }
  if (c == 0 && dh0) dh0[(size_t)b * R + r] = carry;
}

// CUDA kernels launched without error by the entries, over the library's
// life (`rglru_scan_kernel_launches`).
std::atomic<unsigned long long> kernel_launches{0};

// err as an int; counts one launch where it is cudaSuccess.
int counted(cudaError_t err) {
  if (err == cudaSuccess) kernel_launches.fetch_add(1, std::memory_order_relaxed);
  return (int)err;
}

template <typename T>
int launch(const void* a, const void* u, const float* h0, void* hs, float* h_final,
           float* h_state, float* ws, int B, int S, int R, int chunk, cudaStream_t stream) {
  const int C = (S + chunk - 1) / chunk;
  const unsigned blocks_r = (R + THREADS - 1) / THREADS;
  if (C > 1) {
    rglru_chunk_summary_kernel<T><<<dim3(blocks_r, C - 1, B), THREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(u), ws, S, R, chunk);
    const int err = counted(cudaGetLastError());
    if (err) return err;
  }
  auto kernel = C > 1 ? rglru_chunk_scan_kernel<T, true> : rglru_chunk_scan_kernel<T, false>;
  kernel<<<dim3(blocks_r, C, B), THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u), h0, ws, static_cast<T*>(hs),
      h_final, h_state, S, R, chunk);
  return counted(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* a, const float* h_state, const float* h0, const void* dh_seq,
               const float* dh_final, float* ws, void* da, void* du, float* dh0, int B,
               int S, int R, int chunk, cudaStream_t stream) {
  const int C = (S + chunk - 1) / chunk;
  const unsigned blocks_r = (R + THREADS - 1) / THREADS;
  if (C > 1) {
    rglru_chunk_summary_bwd_kernel<T><<<dim3(blocks_r, C - 1, B), THREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(dh_seq), ws, S, R, chunk);
    const int err = counted(cudaGetLastError());
    if (err) return err;
  }
  auto kernel =
      C > 1 ? rglru_chunk_scan_bwd_kernel<T, true> : rglru_chunk_scan_bwd_kernel<T, false>;
  kernel<<<dim3(blocks_r, C, B), THREADS, 0, stream>>>(
      static_cast<const T*>(a), h_state, h0, static_cast<const T*>(dh_seq), dh_final, ws,
      static_cast<T*>(da), static_cast<T*>(du), dh0, S, R, chunk);
  return counted(cudaGetLastError());
}

// A workspace of (2, B, C, R) f32 is needed when there is more than one chunk.
bool bad_chunk(int S, int chunk, const void* ws) {
  return chunk < 1 || ((S + chunk - 1) / chunk > 1 && ws == nullptr);
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() of its
// launches (0 on success): two kernels when S > chunk, else one.  The caller
// has checked shapes, types, contiguity and the device, and allocated ws,
// (2, B, ceil(S / chunk), R) f32 (null when chunk >= S).

// dtype of a, u and hs: 0 = float32, 1 = bfloat16.  h0 may be null (zeros);
// h_state may be null (not written).
extern "C" int rglru_scan(const void* a, const void* u, const void* h0, void* hs,
                          void* h_final, void* h_state, void* ws, int B, int S, int R,
                          int chunk, int dtype, void* stream) {
  if (bad_chunk(S, chunk, ws)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_final);
  float* hst = static_cast<float*>(h_state);
  float* w = static_cast<float*>(ws);
  if (dtype == 0) return launch<float>(a, u, h0f, hs, hf, hst, w, B, S, R, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, u, h0f, hs, hf, hst, w, B, S, R, chunk, st);
  return (int)cudaErrorInvalidValue;
}

// dtype of a, dh_seq, da and du: 0 = float32, 1 = bfloat16; h_state, h0,
// dh_final and dh0 are f32.  h0 and dh_final may be null (zeros), dh0 may be
// null (not written).
extern "C" int rglru_scan_bwd(const void* a, const void* h_state, const void* h0,
                              const void* dh_seq, const void* dh_final, void* ws, void* da,
                              void* du, void* dh0, int B, int S, int R, int chunk, int dtype,
                              void* stream) {
  if (bad_chunk(S, chunk, ws)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hst = static_cast<const float*>(h_state);
  const float* h0f = static_cast<const float*>(h0);
  const float* dhf = static_cast<const float*>(dh_final);
  float* w = static_cast<float*>(ws);
  float* dh0f = static_cast<float*>(dh0);
  if (dtype == 0)
    return launch_bwd<float>(a, hst, h0f, dh_seq, dhf, w, da, du, dh0f, B, S, R, chunk, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, hst, h0f, dh_seq, dhf, w, da, du, dh0f, B, S, R,
                                     chunk, st);
  return (int)cudaErrorInvalidValue;
}

// The CUDA kernels the entries above have launched, summary and scan
// kernels alike, since the library was loaded: a call adds 2 where it scans
// in more than one chunk, else 1.
extern "C" unsigned long long rglru_scan_kernel_launches() {
  return kernel_launches.load(std::memory_order_relaxed);
}
