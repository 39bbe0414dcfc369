// RG-LRU linear recurrence for Hopper (sm_90a):
//   h_t = a_t * h_{t-1} + u_t   over t = 0 .. S-1, from h_{-1} = h0 (or 0),
// per (batch b, channel r), with h in f32 and h_seq written in u's dtype.
//
// Replaces the TPU kernel `rglru_scan_pallas` (body `_kernel`) of
// src/repro/kernels/rglru_scan/kernel.py.  It computes what that kernel
// computes, not block by block: the TPU kernel walks a sequential grid axis
// over blocks of S and carries h across them in VMEM; Hopper's blocks run in
// no order, so here the whole loop over S lives inside one thread, which
// keeps h in a register from t = 0 to S - 1.  Any B, S >= 1 and R: there is
// no block of S or R to divide them.  h_final is written in f32 from the
// register (the reference's Pallas path takes it from the output after the
// cast to u's dtype).  Each step is a rounded f32 product and a rounded f32
// sum, __fmul_rn then __fadd_rn, which the compiler may not contract into an
// FMA: the plain version (`rglru_scan_ref`) takes the same two roundings in
// the same order, so kernel and oracle agree to the bit.
//
// Layouts are those of the JAX package's public function: a, u and h_seq
// are (B, S, R) and h0, h_final (B, R), all contiguous; a and u share one
// type, f32 or bf16; h0 and h_final are f32.  For training, the kernel can
// also write every state in f32 (h_state, (B, S, R)), which the backward
// reads where h_seq is rounded to bf16.
//
// rglru_scan_bwd_kernel is the gradient, which the TPU has no kernel for (the
// JAX package differentiates its jnp scan): the same recurrence run backward,
//   g_t = dh_seq_t + a_{t+1} g_{t+1}  (g_{S-1} = dh_seq_{S-1} + dh_final),
//   du_t = g_t,  da_t = g_t h_{t-1},  dh0 = a_0 g_0,
// one thread per (b, r) walking t from S - 1 down to 0, with the loads of the
// next UNROLL steps in flight while it walks the current ones, as the forward
// does.  Each step rounds one f32 sum and one f32 product, __fadd_rn then
// __fmul_rn, as the plain version (`rglru_scan_bwd_ref`) does, so they agree
// to the bit in f32.  It reads a, h_state (f32) and dh_seq and writes da and du
// (in a's type): 5 x 4 bytes an element in f32, 419,430,400 B at (B 4, S 2048,
// R 2560), 0.125 ms at 3.35 TB/s; bound by bytes, and held back by the same
// few chains as the forward.
//
// What bounds it on the H100.  At the serving shape (recurrentgemma-2b
// prefill: B 4, S 2048, R 2560, a and u f32 from the gates) the kernel must
// read a and u once and write h_seq once: 3 x 4 x 2048 x 2560 x 4 B =
// 251,658,240 B, 0.0751 ms at 3.35 TB/s.  Its operations (2 flops per
// element) are negligible.  So it is bound by bytes, but B x R = 10,240
// independent chains are far fewer threads than 132 SMs keep in flight, and
// each step depends on the one before: a thread that loaded one step at a
// time would wait a full memory latency per step.  What the design does:
//   * one thread per (b, r), neighbouring threads on neighbouring r, so every
//     load of a row of a or u, and every store of h_seq, is coalesced;
//   * 64 threads a block, so the 160 blocks of the serving shape spread over
//     all 132 SMs;
//   * the loads run ahead of the dependent chain: a thread loads the next
//     UNROLL steps of a and u into registers while it walks the current
//     UNROLL steps (double buffering), so 2 x UNROLL loads are in flight per
//     thread at any time;
//   * __restrict__ pointers, and no spills (`-Xptxas -v`).
// Later work, not built here: a chunked two-pass scan over S (chunk-local
// scans with their decay products, then a pass that carries h across chunks)
// would give B x R x S/chunk threads and take the kernel to its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Steps t0 .. t0 + UNROLL - 1 of one chain; past S, a = 1 and u = 0 leave h
// unchanged (1 * h + 0 == h exactly).
template <typename T>
__device__ __forceinline__ void load_steps(const T* __restrict__ a, const T* __restrict__ u,
                                           int t0, int S, size_t R, float* ar, float* ur) {
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const int t = t0 + i;
    ar[i] = t < S ? to_f32(a[(size_t)t * R]) : 1.f;
    ur[i] = t < S ? to_f32(u[(size_t)t * R]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ u,
                  const float* __restrict__ h0, T* __restrict__ hs,
                  float* __restrict__ h_final, float* __restrict__ h_state, int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t chain = (size_t)b * S * R + r;  // element (b, 0, r)
  const T* ab = a + chain;
  const T* ub = u + chain;
  T* ob = hs + chain;
  float h = h0 ? h0[(size_t)b * R + r] : 0.f;

  float a_cur[UNROLL], u_cur[UNROLL];
  load_steps(ab, ub, 0, S, R, a_cur, u_cur);
  for (int t0 = 0; t0 < S; t0 += UNROLL) {
    float a_next[UNROLL], u_next[UNROLL];
    load_steps(ab, ub, t0 + UNROLL, S, R, a_next, u_next);  // in flight meanwhile
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      h = __fadd_rn(__fmul_rn(a_cur[i], h), u_cur[i]);
      if (t0 + i < S) {
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
  h_final[(size_t)b * R + r] = h;
}

// Steps t0, t0 - 1, .. t0 - UNROLL + 1 of one chain of the backward: a_t,
// dh_seq_t and the state entering step t (h_{t-1}; h0 or 0 at t = 0).  Below
// t = 0, a = 0 and dh = 0 leave nothing to write.
template <typename T>
__device__ __forceinline__ void load_steps_bwd(const T* __restrict__ a, const float* __restrict__ hst,
                                               const T* __restrict__ dh, float h_init, int t0,
                                               size_t R, float* ar, float* hr, float* dr) {
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const int t = t0 - i;
    ar[i] = t >= 0 ? to_f32(a[(size_t)t * R]) : 0.f;
    dr[i] = t >= 0 ? to_f32(dh[(size_t)t * R]) : 0.f;
    hr[i] = t > 0 ? hst[(size_t)(t - 1) * R] : h_init;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_bwd_kernel(const T* __restrict__ a, const float* __restrict__ h_state,
                      const float* __restrict__ h0, const T* __restrict__ dh_seq,
                      const float* __restrict__ dh_final, T* __restrict__ da,
                      T* __restrict__ du, float* __restrict__ dh0, int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t chain = (size_t)b * S * R + r;
  const T* ab = a + chain;
  const float* hb = h_state + chain;
  const T* db = dh_seq + chain;
  const float h_init = h0 ? h0[(size_t)b * R + r] : 0.f;
  float carry = dh_final ? dh_final[(size_t)b * R + r] : 0.f;  // a_{t+1} g_{t+1}

  float a_cur[UNROLL], h_cur[UNROLL], d_cur[UNROLL];
  load_steps_bwd(ab, hb, db, h_init, S - 1, R, a_cur, h_cur, d_cur);
  for (int t0 = S - 1; t0 >= 0; t0 -= UNROLL) {
    float a_next[UNROLL], h_next[UNROLL], d_next[UNROLL];
    load_steps_bwd(ab, hb, db, h_init, t0 - UNROLL, R, a_next, h_next, d_next);
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int t = t0 - i;
      if (t >= 0) {
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
  if (dh0) dh0[(size_t)b * R + r] = carry;
}

template <typename T>
int launch(const void* a, const void* u, const float* h0, void* hs, float* h_final,
           float* h_state, int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u), h0, static_cast<T*>(hs),
      h_final, h_state, S, R);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* a, const float* h_state, const float* h0, const void* dh_seq,
               const float* dh_final, void* da, void* du, float* dh0, int B, int S, int R,
               cudaStream_t stream) {
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), h_state, h0, static_cast<const T*>(dh_seq), dh_final,
      static_cast<T*>(da), static_cast<T*>(du), dh0, S, R);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() of the
// launch (0 on success).  The caller has checked shapes, types, contiguity
// and the device.

// dtype of a, u and hs: 0 = float32, 1 = bfloat16.  h0 may be null (zeros);
// h_state may be null (not written).
extern "C" int rglru_scan(const void* a, const void* u, const void* h0, void* hs,
                          void* h_final, void* h_state, int B, int S, int R, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_final);
  float* hst = static_cast<float*>(h_state);
  if (dtype == 0) return launch<float>(a, u, h0f, hs, hf, hst, B, S, R, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, u, h0f, hs, hf, hst, B, S, R, st);
  return (int)cudaErrorInvalidValue;
}

// dtype of a, dh_seq, da and du: 0 = float32, 1 = bfloat16; h_state, h0,
// dh_final and dh0 are f32.  h0 and dh_final may be null (zeros), dh0 may be
// null (not written).
extern "C" int rglru_scan_bwd(const void* a, const void* h_state, const void* h0,
                              const void* dh_seq, const void* dh_final, void* da, void* du,
                              void* dh0, int B, int S, int R, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hst = static_cast<const float*>(h_state);
  const float* h0f = static_cast<const float*>(h0);
  const float* dhf = static_cast<const float*>(dh_final);
  float* dh0f = static_cast<float*>(dh0);
  if (dtype == 0)
    return launch_bwd<float>(a, hst, h0f, dh_seq, dhf, da, du, dh0f, B, S, R, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, hst, h0f, dh_seq, dhf, da, du, dh0f, B, S, R, st);
  return (int)cudaErrorInvalidValue;
}
