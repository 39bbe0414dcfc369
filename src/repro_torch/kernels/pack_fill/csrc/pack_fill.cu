// Eva's fleet-scale packing pass in one launch: the port of
// src/repro/core/engine_jax.py::_pack_all_types (:121). That function is
// jitted lax, not Pallas: a fori_loop over the masked-in types in
// descending cost (type_body :191), a while_loop of fills inside it, and a
// while_loop of greedy adds inside that (fill_one :149). Its loops end on
// data, so torch operations on the card would need a host round trip for
// every greedy add; the counterpart of the one fused device program is one
// launch of this kernel.
//
// Layout: one thread block walks every type, fill and add. The classes of
// interchangeable tasks are spread over the threads (class c belongs to
// thread c % blockDim.x, which alone reads and writes its count, use and
// log-throughput). Shared memory holds P and log P (W x W), the workload
// aggregates agg (W), the reduction's partials, the region budget and, where
// they fit, the per-class counts, uses and log-throughputs (else a global
// scratch buffer). The class keys (workload, RP, job RP, demand), the row
// queues and the records stay in global memory.
//
// One greedy add: each thread scores its feasible classes,
//   score_c = cur - sum_w agg[w] (1 - P[w, w_c]) + rp_c - (1 - exp(logtput_c)) jobrp_c
// (the sum in ascending w), and one reduction finds the maximal score, how
// many classes reach it (more than one: a cross-class tie) and, among them,
// the class whose next task row is lowest (the numpy engine's first-maximal-
// row rule). Every thread gets that result and applies the add to what it
// owns; one barrier makes agg visible before the next add. Every product is
// __fmul_rn / __dmul_rn, so no product is fused into a sum, and the
// arithmetic is ref.py's, operation for operation.
//
// Bound: the pass reads its inputs once and writes its records once, a few
// megabytes at most, microseconds at 3.35 TB/s; what limits it is the
// serial chain of adds, each a reduction and a barrier or two long.
// ONE_WARP (blockDim 32, for at most 32 classes) reduces with shuffles alone
// and synchronises with __syncwarp.
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBigI = 1073741823;  // int32 max // 2, as the reference
constexpr int kMaxR = 4;           // resources a demand row may have (3 here)
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

template <class T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float ex(float a) { return expf(a); }
  static constexpr float eps = FLT_EPSILON;
};
template <> struct Num<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double ex(double a) { return exp(a); }
  static constexpr double eps = DBL_EPSILON;
};

// A candidate add, or the best of several: its score, the candidate's
// throughput, how many classes reach the score, and the lowest (row key,
// class) among them.
template <class T> struct Cand {
  T val, tput;
  int n, key, c;
};

template <class T> __device__ __forceinline__ Cand<T> none() {
  return {-INFINITY, T(0), 0, INT_MAX, INT_MAX};
}

// Exactly associative and commutative (comparisons and integer sums), so
// every order of combination gives the same result on every thread.
template <class T> __device__ __forceinline__ Cand<T> combine(const Cand<T>& a, const Cand<T>& b) {
  if (a.val > b.val) return a;
  if (b.val > a.val) return b;
  const bool first = a.key < b.key || (a.key == b.key && a.c < b.c);
  Cand<T> r = first ? a : b;
  r.n = a.n + b.n;
  return r;
}

template <class T> __device__ __forceinline__ Cand<T> warp_reduce(Cand<T> x) {
  for (int off = 16; off > 0; off >>= 1) {
    Cand<T> y;
    y.val = __shfl_xor_sync(kFull, x.val, off);
    y.tput = __shfl_xor_sync(kFull, x.tput, off);
    y.n = __shfl_xor_sync(kFull, x.n, off);
    y.key = __shfl_xor_sync(kFull, x.key, off);
    y.c = __shfl_xor_sync(kFull, x.c, off);
    x = combine(x, y);
  }
  return x;
}

template <bool ONE_WARP> __device__ __forceinline__ void sync() {
  if (ONE_WARP) __syncwarp(); else __syncthreads();
}

// The block's best candidate, on every thread. The caller keeps a barrier
// between this call's reads of ``part`` and the next call's writes.
template <class T, bool ONE_WARP>
__device__ __forceinline__ Cand<T> block_reduce(Cand<T> x, Cand<T>* part) {
  x = warp_reduce(x);
  if (ONE_WARP) return x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) part[warp] = x;
  __syncthreads();
  return warp_reduce(lane < (int)(blockDim.x / 32) ? part[lane] : none<T>());
}

// Minimum (MIN) or bitwise or of one int a thread, on every thread; ends
// with a barrier, so ``ipart`` is free again on return.
template <bool MIN, bool ONE_WARP>
__device__ __forceinline__ int block_int(int x, int* ipart) {
  for (int off = 16; off > 0; off >>= 1) {
    const int y = __shfl_xor_sync(kFull, x, off);
    x = MIN ? min(x, y) : (x | y);
  }
  if (!ONE_WARP) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (lane == 0) ipart[warp] = x;
    __syncthreads();
    x = lane < (int)(blockDim.x / 32) ? ipart[lane] : (MIN ? INT_MAX : 0);
    for (int off = 16; off > 0; off >>= 1) {
      const int y = __shfl_xor_sync(kFull, x, off);
      x = MIN ? min(x, y) : (x | y);
    }
  }
  sync<ONE_WARP>();
  return x;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Bytes of dynamic shared memory, in the order the kernel carves them.
template <class T> size_t shared_bytes(int C, int W, int NR, bool per_class) {
  size_t n = align16(2 * size_t(W) * W * sizeof(T) + W * sizeof(T));
  n += align16(32 * sizeof(Cand<T>)) + align16((32 + NR) * sizeof(int));
  if (per_class) n += align16(C * sizeof(T)) + 2 * align16(C * sizeof(int));
  return n;
}

template <class T, bool ONE_WARP>
__global__ void __launch_bounds__(kMaxThreads) pack_fill_kernel(
    const T* __restrict__ cdemand, const int* __restrict__ cw, const T* __restrict__ crp,
    const T* __restrict__ cjr, const int* __restrict__ counts0, const int* __restrict__ rows_pad,
    const T* __restrict__ P, const T* __restrict__ logP, const T* __restrict__ costs,
    const T* __restrict__ caps, const int* __restrict__ fams, const int* __restrict__ rids,
    const int* __restrict__ budget_in, int C, int F, int R, int M, int W, int K, int NR,
    int max_fills, int* __restrict__ budget_out, int* __restrict__ rec_type,
    int* __restrict__ rec_rep, int* __restrict__ rec_comp, long long* __restrict__ stats,
    unsigned char* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  T* sP = reinterpret_cast<T*>(p);
  T* slogP = sP + W * W;
  T* agg = slogP + W * W;
  p += align16(2 * size_t(W) * W * sizeof(T) + W * sizeof(T));
  Cand<T>* part = reinterpret_cast<Cand<T>*>(p);
  p += align16(32 * sizeof(Cand<T>));
  int* ipart = reinterpret_cast<int*>(p);
  int* sbudget = ipart + 32;
  p += align16((32 + NR) * sizeof(int));
  if (scratch != nullptr) p = scratch;  // the per-class state did not fit
  T* logtput = reinterpret_cast<T*>(p);
  p += align16(C * sizeof(T));
  int* counts = reinterpret_cast<int*>(p);
  int* used = reinterpret_cast<int*>(p + align16(C * sizeof(int)));

  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < W * W; i += nt) {
    sP[i] = P[i];
    slogP[i] = logP[i];
  }
  for (int r = tid; r < NR; r += nt) sbudget[r] = budget_in[r];
  int left = 0;
  for (int c = tid; c < C; c += nt) {
    counts[c] = counts0[c];
    left |= counts0[c] > 0;
  }
  left = block_int<false, ONE_WARP>(left, ipart);  // also publishes the above

  const T eps = T(1e-9), rtol = T(256) * Num<T>::eps;
  int n_rec = 0, overflow = 0;
  long long adds = 0, fills = 0;
  for (int t = 0; t < K; ++t) {
    const T cost = costs[t];
    const int fam = fams[t], rid = rids[t];
    bool go = left != 0;
    while (go) {
      // fill_one: greedy-fill one fresh instance of type t
      for (int c = tid; c < C; c += nt) {
        used[c] = 0;
        logtput[c] = T(0);
      }
      for (int w = tid; w < W; w += nt) agg[w] = T(0);
      T capr[kMaxR];  // unrolled loops with static indices keep it in registers
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) capr[r] = r < R ? caps[size_t(t) * R + r] : T(0);
      T cur = T(0);
      bool tie = false;
      int n_add = 0;
      sync<ONE_WARP>();
      while (true) {
        Cand<T> best = none<T>();
        for (int c = tid; c < C; c += nt) {
          const int cnt = counts[c], u = used[c];
          if (cnt - u <= 0) continue;
          const T* dc = cdemand + (size_t(c) * F + fam) * R;
          bool fit = true;
#pragma unroll
          for (int r = 0; r < kMaxR; ++r) fit = fit && (r >= R || dc[r] <= capr[r] + eps);
          if (!fit) continue;
          const T tp = Num<T>::ex(logtput[c]);
          const int wc = cw[c];
          T q = T(0);
          for (int w = 0; w < W; ++w) q = q + Num<T>::mul(agg[w], T(1) - sP[w * W + wc]);
          const T s = cur - q + crp[c] - Num<T>::mul(T(1) - tp, cjr[c]);
          const int ptr = min(counts0[c] - cnt + u, M - 1);
          best = combine(best, Cand<T>{s, tp, 1, rows_pad[size_t(c) * M + ptr], c});
        }
        const Cand<T> b = block_reduce<T, ONE_WARP>(best, part);
        if (!(b.n > 0 && b.val >= cur - eps)) break;
        const int wb = cw[b.c];
        for (int c = tid; c < C; c += nt) {
          logtput[c] = logtput[c] + slogP[cw[c] * W + wb];
          if (c == b.c) used[c] += 1;
        }
        for (int w = tid; w < W; w += nt) {
          T a = Num<T>::mul(agg[w], sP[w * W + wb]);
          if (w == wb) a = a + Num<T>::mul(cjr[b.c], b.tput);
          agg[w] = a;
        }
        const T* db = cdemand + (size_t(b.c) * F + fam) * R;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r)
          if (r < R) capr[r] = capr[r] - db[r];
        cur = b.val;
        tie = tie || b.n > 1;
        ++n_add;
        sync<ONE_WARP>();
      }
      ++fills;
      adds += n_add;
      // the fill's replication: min over used classes of count / use
      const int bud = sbudget[rid];  // read before the barrier in block_int
      int rep_c = kBigI;
      for (int c = tid; c < C; c += nt)
        if (used[c] > 0) rep_c = min(rep_c, counts[c] / used[c]);
      rep_c = block_int<true, ONE_WARP>(rep_c, ipart);
      const bool accept = n_add > 0 && cur >= cost - eps - Num<T>::mul(rtol, cost) && bud > 0;
      const int rep = tie ? 1 : min(rep_c, bud);
      if (accept) {
        const bool can = n_rec < max_fills;
        for (int c = tid; c < C; c += nt) {
          if (can) rec_comp[size_t(n_rec) * C + c] = used[c];
          counts[c] -= rep * used[c];
        }
        if (can && tid == 0) {
          rec_type[n_rec] = t;
          rec_rep[n_rec] = rep;
        }
        overflow |= !can;
        ++n_rec;
        if (tid == 0) sbudget[rid] = bud - rep;
      }
      left = 0;
      for (int c = tid; c < C; c += nt) left |= counts[c] > 0;
      left = block_int<false, ONE_WARP>(left, ipart);
      go = accept && left != 0;
    }
  }
  for (int r = tid; r < NR; r += nt) budget_out[r] = sbudget[r];
  if (tid == 0) {
    stats[0] = n_rec;
    stats[1] = overflow;
    stats[2] = adds;
    stats[3] = fills;
  }
}

template <class T, bool ONE_WARP>
cudaError_t launch(const void* cdemand, const int* cw, const void* crp, const void* cjr,
                   const int* counts0, const int* rows_pad, const void* P, const void* logP,
                   const void* costs, const void* caps, const int* fams, const int* rids,
                   const int* budget_in, int C, int F, int R, int M, int W, int K, int NR,
                   int max_fills, int threads, int* budget_out, int* rec_type, int* rec_rep,
                   int* rec_comp, long long* stats, void* scratch, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(C, W, NR, scratch == nullptr);
  auto kernel = pack_fill_kernel<T, ONE_WARP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(1), dim3(threads), smem, stream>>>(
      static_cast<const T*>(cdemand), cw, static_cast<const T*>(crp),
      static_cast<const T*>(cjr), counts0, rows_pad, static_cast<const T*>(P),
      static_cast<const T*>(logP), static_cast<const T*>(costs), static_cast<const T*>(caps),
      fams, rids, budget_in, C, F, R, M, W, K, NR, max_fills, budget_out, rec_type, rec_rep,
      rec_comp, stats, static_cast<unsigned char*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared bytes the kernel asks for (dtype 0 float32, 1 float64), with or
// without the per-class state; the wrapper passes a scratch buffer of
// pack_fill_scratch_bytes when the latter is all that fits.
size_t pack_fill_shared_bytes(int dtype, int C, int W, int NR, int per_class) {
  return dtype ? shared_bytes<double>(C, W, NR, per_class)
               : shared_bytes<float>(C, W, NR, per_class);
}

size_t pack_fill_scratch_bytes(int dtype, int C) {
  return align16(C * (dtype ? sizeof(double) : sizeof(float))) + 2 * align16(C * sizeof(int));
}

// One launch of the whole pass. threads: a multiple of 32, at most 512;
// one_warp: 1 for the shuffle-only variant (threads must then be 32).
// Returns the CUDA error of the launch (0 on success).
int pack_fill(const void* cdemand, const int* cw, const void* crp, const void* cjr,
              const int* counts0, const int* rows_pad, const void* P, const void* logP,
              const void* costs, const void* caps, const int* fams, const int* rids,
              const int* budget_in, int C, int F, int R, int M, int W, int K, int NR,
              int max_fills, int dtype, int threads, int one_warp, int* budget_out,
              int* rec_type, int* rec_rep, int* rec_comp, long long* stats, void* scratch,
              cudaStream_t stream) {
  if (R < 1 || R > kMaxR || threads < 32 || threads > kMaxThreads || threads % 32 ||
      (one_warp && threads != 32))
    return cudaErrorInvalidValue;
#define PACK_FILL_ARGS                                                                     \
  cdemand, cw, crp, cjr, counts0, rows_pad, P, logP, costs, caps, fams, rids, budget_in, C, \
      F, R, M, W, K, NR, max_fills, threads, budget_out, rec_type, rec_rep, rec_comp, stats, \
      scratch, stream
  cudaError_t err;
  if (dtype)
    err = one_warp ? launch<double, true>(PACK_FILL_ARGS) : launch<double, false>(PACK_FILL_ARGS);
  else
    err = one_warp ? launch<float, true>(PACK_FILL_ARGS) : launch<float, false>(PACK_FILL_ARGS);
#undef PACK_FILL_ARGS
  return (int)err;
}

}  // extern "C"
