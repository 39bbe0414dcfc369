// Eva's fleet-scale packing pass in one launch: the port of
// src/repro/core/engine_jax.py::_pack_all_types (:121). That function is
// jitted lax, not Pallas: a fori_loop over the masked-in types in
// descending cost (type_body :191), a while_loop of fills inside it, and a
// while_loop of greedy adds inside that (fill_one :149). Its loops end on
// data, so torch operations on the card would need a host round trip for
// every greedy add; the counterpart of the one fused device program is one
// launch of this kernel.
//
// One greedy add scores every feasible class,
//   score_c = cur - sum_w agg[w] (1 - P[w, w_c]) + rp_c - (1 - exp(logtput_c)) jobrp_c
// (the sum in ascending w), finds the maximal score, how many classes reach
// it (more than one: a cross-class tie) and, among them, the class whose
// next task row is lowest (the numpy engine's first-maximal-row rule), and
// applies the add. Every product is __fmul_rn / __dmul_rn, so no product is
// fused into a sum, and the arithmetic is ref.py's, operation for operation.
//
// Bound: the pass reads its inputs once and writes its records once, a few
// megabytes at most, microseconds at 3.35 TB/s; what limits it is the
// serial chain of adds, one after another on one SM. So an add's latency is
// the kernel's time, and the design keeps that chain short.
//
// pack_fill_warp_kernel<T, L> (at most 32 L classes, L = 1, 2, 4 or 8, and
// at most kMaxW workloads): one warp; class j * 32 + lane belongs to the
// lane, which keeps in registers everything an add reads of it (count,
// use, log-throughput, exp of it and the penalty from it, RP, job RP,
// workload, its demand row for the type's family, loaded once per type,
// and its next two row keys; the key after those is loaded as soon as the
// class wins, so no global read waits on the chain). Every lane holds agg
// (W values) and applies the same update to it. P, log P and 1 - P stay in
// shared memory, read-only after one barrier at the start. An add: each
// lane scores its classes and keeps its best (score, count at it, lowest
// key, the candidate's workload, demand and job RP x throughput); the
// maximum by five rounds of __shfl_xor_sync of the score alone; one
// __ballot_sync of the lanes at it; at L > 1 one __reduce_add_sync of their
// counts; on a tie one __reduce_min_sync of their keys (a task row lies in
// exactly one class, so the key alone decides) and a ballot of the lane
// holding it; then one __shfl_sync from the winning lane for each of its
// values. No shared memory is written and no barrier is crossed inside an
// add. Only exact no-ops are skipped: exp is not recomputed where a class's
// log P term is 0, the W-term sum is +0 where its 1 - P column is all zeros,
// and agg is not updated where no column is nonzero (it is then never read).
//
// pack_fill_block_kernel<T> (any class count): one block walks every type,
// fill and add; class c belongs to thread c % blockDim.x, which alone reads
// and writes its count, use and log-throughput. Shared memory holds P and
// log P, agg, the reduction's partials, the region budget and, where they
// fit, the per-class counts, uses and log-throughputs (else a global
// scratch buffer). The class keys, the row queues and the records stay in
// global memory. Per add one block reduction of (score, count, lowest row,
// class) through shuffles and shared-memory partials, and two barriers.
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kBigI = 1073741823;  // int32 max // 2, as the reference
constexpr int kMaxR = 4;           // resources a demand row may have (3 here)
constexpr int kMaxW = 16;          // workloads the warp kernel holds in registers
constexpr int kMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

template <class T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float ex(float a) { return expf(a); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static constexpr float eps = FLT_EPSILON;
};
template <> struct Num<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double ex(double a) { return exp(a); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static constexpr double eps = DBL_EPSILON;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// ---------------------------------------------------------------------------
// The warp kernel.

template <class T> size_t warp_shared_bytes(int W, int NR) {
  return align16(3 * size_t(W) * W * sizeof(T)) + NR * sizeof(int);
}

template <class T, int L>
__global__ void __launch_bounds__(32, 1) pack_fill_warp_kernel(
    const T* __restrict__ cdemand, const int* __restrict__ cw, const T* __restrict__ crp_in,
    const T* __restrict__ cjr_in, const int* __restrict__ counts0, const int* __restrict__ rows_pad,
    const T* __restrict__ P, const T* __restrict__ logP, const T* __restrict__ costs,
    const T* __restrict__ caps, const int* __restrict__ fams, const int* __restrict__ rids,
    const int* __restrict__ budget_in, int C, int F, int R, int M, int W, int K, int NR,
    int max_fills, int* __restrict__ budget_out, int* __restrict__ rec_type,
    int* __restrict__ rec_rep, int* __restrict__ rec_comp, long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sP = reinterpret_cast<T*>(smem);
  T* slogP = sP + W * W;
  T* sQ = slogP + W * W;  // 1 - P, as ref.py's Q
  int* sbudget = reinterpret_cast<int*>(smem + align16(3 * size_t(W) * W * sizeof(T)));
  const int lane = threadIdx.x;
  bool q_any = false, lp_any = false;
  for (int i = lane; i < W * W; i += 32) {
    const T q = T(1) - P[i];
    sP[i] = P[i];
    slogP[i] = logP[i];
    sQ[i] = q;
    q_any = q_any || q != T(0);
    lp_any = lp_any || logP[i] != T(0);
  }
  for (int r = lane; r < NR; r += 32) sbudget[r] = budget_in[r];
  const bool interf_q = __any_sync(kFull, q_any);    // some 1 - P column is nonzero
  const bool interf_lp = __any_sync(kFull, lp_any);  // some log P term is nonzero
  __syncwarp();

  // the lane's classes: j * 32 + lane, valid below C
  int cnt[L], used[L], ptr[L], k1[L], k2[L], wc[L];
  T crp[L], cjr[L], lt[L], tp[L], pen[L], d[L][kMaxR];
  bool qz[L];
  int left = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int c = j * 32 + lane;
    const bool ok = c < C;
    cnt[j] = ok ? counts0[c] : 0;
    used[j] = 0;
    ptr[j] = 0;  // counts0 - cnt + used: the next row of the class's queue
    k1[j] = ok ? rows_pad[size_t(c) * M] : INT_MAX;
    k2[j] = ok ? rows_pad[size_t(c) * M + min(1, M - 1)] : INT_MAX;
    wc[j] = ok ? cw[c] : 0;
    crp[j] = ok ? crp_in[c] : T(0);
    cjr[j] = ok ? cjr_in[c] : T(0);
    bool z = true;
    for (int w = 0; w < W; ++w) z = z && sQ[w * W + wc[j]] == T(0);
    qz[j] = z;
    left |= cnt[j] > 0;
  }
  left = __any_sync(kFull, left);
  T agg[kMaxW];

  const T eps = T(1e-9), rtol = T(256) * Num<T>::eps;
  int n_rec = 0, overflow = 0;
  long long adds = 0, fills = 0;
  for (int t = 0; t < K; ++t) {
    const T cost = costs[t];
    const int fam = fams[t], rid = rids[t];
    T cap0[kMaxR];  // resources past R: capacity 0, demand 0, always fit
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) cap0[r] = r < R ? caps[size_t(t) * R + r] : T(0);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int c = j * 32 + lane;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r)
        d[j][r] = c < C && r < R ? cdemand[(size_t(c) * F + fam) * R + r] : T(0);
    }
    bool go = left != 0;
    while (go) {
      // fill_one: greedy-fill one fresh instance of type t
#pragma unroll
      for (int j = 0; j < L; ++j) {
        used[j] = 0;
        lt[j] = T(0);
        tp[j] = T(1);  // exp(0)
        pen[j] = Num<T>::mul(T(1) - tp[j], cjr[j]);
      }
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) agg[w] = T(0);
      T capr[kMaxR];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) capr[r] = cap0[r];
      T cur = T(0);
      bool tie = false;
      int n_add = 0;
      while (true) {
        T fit_cap[kMaxR];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) fit_cap[r] = capr[r] + eps;
        // the lane's best: score, classes at it, lowest key and local class
        // (selects, not branches: the lanes do not diverge)
        T bv = -INFINITY;
        int bn = 0, bk = INT_MAX, bj = 0;
#pragma unroll
        for (int j = 0; j < L; ++j) {
          bool fit = cnt[j] - used[j] > 0;
#pragma unroll
          for (int r = 0; r < kMaxR; ++r) fit = fit && d[j][r] <= fit_cap[r];
          T q = T(0);
          if (!qz[j]) {
#pragma unroll
            for (int w = 0; w < kMaxW; ++w)
              if (w < W) q = q + Num<T>::mul(agg[w], sQ[w * W + wc[j]]);
          }
          const T s = cur - q + crp[j] - pen[j];
          const bool gt = fit && s > bv, eq = fit && s == bv;
          const bool take = gt || (eq && k1[j] < bk);
          bn = gt ? 1 : bn + eq;
          bk = take ? k1[j] : bk;
          bj = take ? j : bj;
          bv = gt ? s : bv;
        }
        T m = bv;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = Num<T>::max(m, __shfl_xor_sync(kFull, m, off));
        const bool at = bn > 0 && bv == m;
        unsigned ballot = __ballot_sync(kFull, at);
        const int n = L == 1 ? __popc(ballot) : __reduce_add_sync(kFull, at ? bn : 0);
        if (!(n > 0 && m >= cur - eps)) break;
        if (n > 1) {  // a cross-class tie: the lowest next row wins
          const int kmin = __reduce_min_sync(kFull, at ? bk : INT_MAX);
          ballot = __ballot_sync(kFull, at && bk == kmin);
        }
        const int src = __ffs(ballot) - 1;
        // the lane's candidate's values, sent from the winning lane
        int wsel = 0;
        T csel = T(0), dsel[kMaxR];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) dsel[r] = T(0);
#pragma unroll
        for (int j = 0; j < L; ++j)
          if (j == bj) {
            wsel = wc[j];
            csel = Num<T>::mul(cjr[j], tp[j]);
#pragma unroll
            for (int r = 0; r < kMaxR; ++r) dsel[r] = d[j][r];
          }
        const int wb = __shfl_sync(kFull, wsel, src);
        const T ctp = __shfl_sync(kFull, csel, src);
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) capr[r] = capr[r] - __shfl_sync(kFull, dsel[r], src);
        if (lane == src) {
#pragma unroll
          for (int j = 0; j < L; ++j)
            if (j == bj) {
              const int c = j * 32 + lane;
              ++used[j];
              ++ptr[j];
              k1[j] = k2[j];
              k2[j] = rows_pad[size_t(c) * M + min(ptr[j] + 1, M - 1)];
            }
        }
        if (interf_lp) {
#pragma unroll
          for (int j = 0; j < L; ++j) {
            const T lp = slogP[wc[j] * W + wb];
            if (lp != T(0)) {
              lt[j] = lt[j] + lp;
              tp[j] = Num<T>::ex(lt[j]);
              pen[j] = Num<T>::mul(T(1) - tp[j], cjr[j]);
            }
          }
        }
        if (interf_q) {
#pragma unroll
          for (int w = 0; w < kMaxW; ++w)
            if (w < W) {
              T a = Num<T>::mul(agg[w], sP[w * W + wb]);
              if (w == wb) a = a + ctp;
              agg[w] = a;
            }
        }
        cur = m;
        tie = tie || n > 1;
        ++n_add;
      }
      ++fills;
      adds += n_add;
      // the fill's replication: min over used classes of count / use
      const int bud = sbudget[rid];
      int rep_c = kBigI;
#pragma unroll
      for (int j = 0; j < L; ++j)
        if (used[j] > 0) rep_c = min(rep_c, cnt[j] / used[j]);
      rep_c = __reduce_min_sync(kFull, rep_c);
      const bool accept = n_add > 0 && cur >= cost - eps - Num<T>::mul(rtol, cost) && bud > 0;
      const int rep = tie ? 1 : min(rep_c, bud);
      const int kept = accept ? rep : 0;
      if (accept) {
        const bool can = n_rec < max_fills;
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const int c = j * 32 + lane;
          if (can && c < C) rec_comp[size_t(n_rec) * C + c] = used[j];
        }
        if (can && lane == 0) {
          rec_type[n_rec] = t;
          rec_rep[n_rec] = rep;
        }
        overflow |= !can;
        ++n_rec;
        if (lane == 0) sbudget[rid] = bud - rep;
      }
      // the queues: kept fills take rep x used rows of each class, a refused
      // one none; the keys are read again where the next row moved
      left = 0;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int c = j * 32 + lane;
        cnt[j] -= kept * used[j];
        const int p = ptr[j] - used[j] + kept * used[j];
        if (p != ptr[j]) {
          ptr[j] = p;
          k1[j] = rows_pad[size_t(c) * M + min(p, M - 1)];
          k2[j] = rows_pad[size_t(c) * M + min(p + 1, M - 1)];
        }
        left |= cnt[j] > 0;
      }
      left = __any_sync(kFull, left);
      __syncwarp();  // the budget written above, before the next fill reads it
      go = accept && left != 0;
    }
  }
  for (int r = lane; r < NR; r += 32) budget_out[r] = sbudget[r];
  if (lane == 0) {
    stats[0] = n_rec;
    stats[1] = overflow;
    stats[2] = adds;
    stats[3] = fills;
  }
}

// ---------------------------------------------------------------------------
// The block kernel.

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

// The block's best candidate, on every thread. The caller keeps a barrier
// between this call's reads of ``part`` and the next call's writes.
template <class T>
__device__ __forceinline__ Cand<T> block_reduce(Cand<T> x, Cand<T>* part) {
  x = warp_reduce(x);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) part[warp] = x;
  __syncthreads();
  return warp_reduce(lane < (int)(blockDim.x / 32) ? part[lane] : none<T>());
}

// Minimum (MIN) or bitwise or of one int a thread, on every thread; ends
// with a barrier, so ``ipart`` is free again on return.
template <bool MIN>
__device__ __forceinline__ int block_int(int x, int* ipart) {
  for (int off = 16; off > 0; off >>= 1) {
    const int y = __shfl_xor_sync(kFull, x, off);
    x = MIN ? min(x, y) : (x | y);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) ipart[warp] = x;
  __syncthreads();
  x = lane < (int)(blockDim.x / 32) ? ipart[lane] : (MIN ? INT_MAX : 0);
  for (int off = 16; off > 0; off >>= 1) {
    const int y = __shfl_xor_sync(kFull, x, off);
    x = MIN ? min(x, y) : (x | y);
  }
  __syncthreads();
  return x;
}

// Bytes of dynamic shared memory, in the order the kernel carves them.
template <class T> size_t shared_bytes(int C, int W, int NR, bool per_class) {
  size_t n = align16(2 * size_t(W) * W * sizeof(T) + W * sizeof(T));
  n += align16(32 * sizeof(Cand<T>)) + align16((32 + NR) * sizeof(int));
  if (per_class) n += align16(C * sizeof(T)) + 2 * align16(C * sizeof(int));
  return n;
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads) pack_fill_block_kernel(
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
  left = block_int<false>(left, ipart);  // also publishes the above

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
      __syncthreads();
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
        const Cand<T> b = block_reduce<T>(best, part);
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
        __syncthreads();
      }
      ++fills;
      adds += n_add;
      // the fill's replication: min over used classes of count / use
      const int bud = sbudget[rid];  // read before the barrier in block_int
      int rep_c = kBigI;
      for (int c = tid; c < C; c += nt)
        if (used[c] > 0) rep_c = min(rep_c, counts[c] / used[c]);
      rep_c = block_int<true>(rep_c, ipart);
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
      left = block_int<false>(left, ipart);
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

// ---------------------------------------------------------------------------
// Launches.

struct Args {
  const void *cdemand, *crp, *cjr, *P, *logP, *costs, *caps;
  const int *cw, *counts0, *rows_pad, *fams, *rids, *budget_in;
  int C, F, R, M, W, K, NR, max_fills;
  int *budget_out, *rec_type, *rec_rep, *rec_comp;
  long long* stats;
};

template <class T, int L> cudaError_t launch_warp(const Args& a, cudaStream_t stream) {
  const size_t smem = warp_shared_bytes<T>(a.W, a.NR);
  auto kernel = pack_fill_warp_kernel<T, L>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(1), dim3(32), smem, stream>>>(
      static_cast<const T*>(a.cdemand), a.cw, static_cast<const T*>(a.crp),
      static_cast<const T*>(a.cjr), a.counts0, a.rows_pad, static_cast<const T*>(a.P),
      static_cast<const T*>(a.logP), static_cast<const T*>(a.costs),
      static_cast<const T*>(a.caps), a.fams, a.rids, a.budget_in, a.C, a.F, a.R, a.M, a.W, a.K,
      a.NR, a.max_fills, a.budget_out, a.rec_type, a.rec_rep, a.rec_comp, a.stats);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_block(const Args& a, int threads, void* scratch, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(a.C, a.W, a.NR, scratch == nullptr);
  auto kernel = pack_fill_block_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(1), dim3(threads), smem, stream>>>(
      static_cast<const T*>(a.cdemand), a.cw, static_cast<const T*>(a.crp),
      static_cast<const T*>(a.cjr), a.counts0, a.rows_pad, static_cast<const T*>(a.P),
      static_cast<const T*>(a.logP), static_cast<const T*>(a.costs),
      static_cast<const T*>(a.caps), a.fams, a.rids, a.budget_in, a.C, a.F, a.R, a.M, a.W, a.K,
      a.NR, a.max_fills, a.budget_out, a.rec_type, a.rec_rep, a.rec_comp, a.stats,
      static_cast<unsigned char*>(scratch));
  return cudaGetLastError();
}

template <class T>
cudaError_t launch(const Args& a, int per_lane, int threads, void* scratch, cudaStream_t stream) {
  switch (per_lane) {
    case 0: return launch_block<T>(a, threads, scratch, stream);
    case 1: return launch_warp<T, 1>(a, stream);
    case 2: return launch_warp<T, 2>(a, stream);
    case 4: return launch_warp<T, 4>(a, stream);
    case 8: return launch_warp<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared bytes the block kernel asks for (dtype 0 float32, 1 float64), with
// or without the per-class state; the wrapper passes a scratch buffer of
// pack_fill_scratch_bytes when the latter is all that fits.
size_t pack_fill_shared_bytes(int dtype, int C, int W, int NR, int per_class) {
  return dtype ? shared_bytes<double>(C, W, NR, per_class)
               : shared_bytes<float>(C, W, NR, per_class);
}

size_t pack_fill_scratch_bytes(int dtype, int C) {
  return align16(C * (dtype ? sizeof(double) : sizeof(float))) + 2 * align16(C * sizeof(int));
}

// Shared bytes the warp kernel asks for.
size_t pack_fill_warp_shared_bytes(int dtype, int W, int NR) {
  return dtype ? warp_shared_bytes<double>(W, NR) : warp_shared_bytes<float>(W, NR);
}

// One launch of the whole pass. per_lane: 1, 2, 4 or 8 for the warp kernel
// (C <= 32 per_lane, W <= 16, threads 32), 0 for the block kernel (threads a
// multiple of 32, at most 512). Returns the CUDA error of the launch (0 on
// success).
int pack_fill(const void* cdemand, const int* cw, const void* crp, const void* cjr,
              const int* counts0, const int* rows_pad, const void* P, const void* logP,
              const void* costs, const void* caps, const int* fams, const int* rids,
              const int* budget_in, int C, int F, int R, int M, int W, int K, int NR,
              int max_fills, int dtype, int per_lane, int threads, int* budget_out,
              int* rec_type, int* rec_rep, int* rec_comp, long long* stats, void* scratch,
              cudaStream_t stream) {
  if (R < 1 || R > kMaxR || threads < 32 || threads > kMaxThreads || threads % 32 ||
      (per_lane && (threads != 32 || W > kMaxW || C > 32 * per_lane)))
    return cudaErrorInvalidValue;
  const Args a{cdemand, crp, cjr, P, logP, costs, caps,
               cw, counts0, rows_pad, fams, rids, budget_in,
               C, F, R, M, W, K, NR, max_fills,
               budget_out, rec_type, rec_rep, rec_comp, stats};
  const cudaError_t err = dtype ? launch<double>(a, per_lane, threads, scratch, stream)
                                : launch<float>(a, per_lane, threads, scratch, stream);
  return (int)err;
}

}  // extern "C"
