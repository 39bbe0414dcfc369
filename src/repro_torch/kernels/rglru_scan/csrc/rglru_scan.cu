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
// type, f32 or bf16; h0 and h_final are f32.
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
                  float* __restrict__ h_final, int S, int R) {
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
      if (t0 + i < S) ob[(size_t)(t0 + i) * R] = from_f32<T>(h);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      a_cur[i] = a_next[i];
      u_cur[i] = u_next[i];
    }
  }
  h_final[(size_t)b * R + r] = h;
}

template <typename T>
int launch(const void* a, const void* u, const float* h0, void* hs, float* h_final,
           int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u), h0, static_cast<T*>(hs),
      h_final, S, R);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).  dtype of a, u and hs: 0 = float32, 1 = bfloat16.  h0 may be
// null (zeros).  The caller has checked shapes, types, contiguity and the
// device.
extern "C" int rglru_scan(const void* a, const void* u, const void* h0, void* hs,
                          void* h_final, int B, int S, int R, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_final);
  if (dtype == 0) return launch<float>(a, u, h0f, hs, hf, B, S, R, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, u, h0f, hs, hf, B, S, R, st);
  return (int)cudaErrorInvalidValue;
}
