// The irreducible chain of one greedy add of the packing pass
// (src/repro_torch/kernels/pack_fill/csrc/pack_fill.cu), one class a lane,
// alone in a dependent loop on one warp, so that its latency on the card
// can be read. An add: the fit test of the lane's demand row against the
// capacity left, the W-term sum (W products of the lane's aggregates and
// its class's column of 1 - P, summed in ascending w), the score, the
// maximum by five rounds of __shfl_xor_sync, one __ballot_sync of the lanes
// at it and __popc of it, the end-of-fill test, on a tie only one
// __reduce_min_sync of the row keys and a second ballot, the winning lane
// by __ffs, and the winner's demand by __shfl_sync, subtracted from the
// capacity that the next add's fit test reads; at W > 0 also the winner's
// workload and throughput by __shfl_sync and the aggregates' update from
// P in shared memory, which the next add's W-term sum reads. The data make
// one lane win every add with a score of exactly 0, so the score never
// grows and no tie occurs: the chain is that of an add without a tie.
// tools/pack_fill_parts.py builds it with the port's nvcc flags and times
// it; W = 0 is the chain with interference off, where the pass skips the
// W-term sum and the aggregates exactly.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kR = 3;  // resources of a demand row

template <class T> __device__ __forceinline__ T mul(T a, T b);
template <> __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
template <> __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// in: P (W x W), then a lane's RP, penalty, demand row (kR values, 32 apart)
// and job RP x throughput at 32 apart each, then the W starting aggregates
template <class T, int W>
__global__ void chain_kernel(const T* __restrict__ in, const int* __restrict__ keys, int adds,
                             T cap, T* __restrict__ out, long long* __restrict__ cycles) {
  __shared__ T sP[W > 0 ? W * W : 1];
  const int lane = threadIdx.x;
  for (int i = lane; i < W * W; i += 32) sP[i] = in[i];
  const T* v = in + W * W;
  const int wc = W > 0 ? lane % W : 0;
  T qcol[W > 0 ? W : 1], agg[W > 0 ? W : 1];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    qcol[w] = T(1) - in[w * W + wc];
    agg[w] = v[(3 + kR) * 32 + w];
  }
  const T crp = v[lane], pen = v[32 + lane], csel = v[(2 + kR) * 32 + lane];
  T d[kR], capr[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    d[r] = v[(2 + r) * 32 + lane];
    capr[r] = cap;
  }
  const int key = keys[lane];
  const T eps = T(1e-9);
  T cur = T(0);
  int i = 0;
  __syncwarp();
  const long long t0 = clock64();
  for (; i < adds; ++i) {
    bool fit = true;
#pragma unroll
    for (int r = 0; r < kR; ++r) fit = fit && d[r] <= capr[r] + eps;
    T q = T(0);
#pragma unroll
    for (int w = 0; w < W; ++w) q = q + mul(agg[w], qcol[w]);
    const T s = fit ? cur - q + crp - pen : T(-INFINITY);
    T m = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmax(m, __shfl_xor_sync(kFull, m, off));
    const bool at = fit && s == m;
    unsigned ballot = __ballot_sync(kFull, at);
    const int n = __popc(ballot);
    if (!(n > 0 && m >= cur - eps)) break;
    if (n > 1) {
      const int kmin = __reduce_min_sync(kFull, at ? key : INT_MAX);
      ballot = __ballot_sync(kFull, at && key == kmin);
    }
    const int src = __ffs(ballot) - 1;
#pragma unroll
    for (int r = 0; r < kR; ++r) capr[r] = capr[r] - __shfl_sync(kFull, d[r], src);
    if (W > 0) {
      const int wb = __shfl_sync(kFull, wc, src);
      const T ctp = __shfl_sync(kFull, csel, src);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        T a = mul(agg[w], sP[w * W + wb]);
        if (w == wb) a = a + ctp;
        agg[w] = a;
      }
    }
    cur = m;
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = cur;
    out[1] = T(i);
    cycles[0] = t1 - t0;
  }
}

template <class T, int W>
int launch(const void* in, const int* keys, int adds, double cap, void* out, long long* cycles,
           cudaStream_t stream) {
  chain_kernel<T, W><<<dim3(1), dim3(32), 0, stream>>>(
      static_cast<const T*>(in), keys, adds, T(cap), static_cast<T*>(out), cycles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch of up to ``adds`` dependent adds (dtype 0 float32, 1 float64;
// w 0 or 12 workloads). ``in`` holds w^2 + 192 + w values of the dtype
// (see chain_kernel), ``keys`` 32 ints; ``cap`` is every resource's
// capacity at the start; ``out`` receives the last maximum and the adds
// run, ``cycles`` the loop's clock64 cycles.
int pack_fill_chain(const void* in, const int* keys, int adds, double cap, int dtype, int w,
                    void* out, long long* cycles, cudaStream_t stream) {
#define CHAIN(T)                                                              \
  switch (w) {                                                                \
    case 0: return launch<T, 0>(in, keys, adds, cap, out, cycles, stream);    \
    case 12: return launch<T, 12>(in, keys, adds, cap, out, cycles, stream);  \
    default: return (int)cudaErrorInvalidValue;                               \
  }
  if (dtype) CHAIN(double) else CHAIN(float)
#undef CHAIN
}

}  // extern "C"
