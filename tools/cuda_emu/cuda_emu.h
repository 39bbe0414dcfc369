// CPU emulation of the small part of CUDA that the port's kernels use
// (rglru_scan.cu, ssd_bwd.cu, ssd_bwd_tc.cu, pack_fill.cu, flash_attn_bwd.cu),
// so that their C++
// can be run and held against the plain versions where there is no card and
// no nvcc: one fiber (ucontext) per CUDA thread, all of a block's fibers on
// the calling thread, switched at __syncthreads, at __syncwarp and in the 32-
// and 64-bit shuffles, which wait at their warp's barrier (a fiber that
// reaches a barrier first yields until its warp or block has arrived; the
// order is fixed, so a run is deterministic, and a block whose fibers all
// wait with none arriving aborts as a deadlock); blocks run one after
// another, so a kernel's __shared__ arrays become static ones.  The warp
// votes (__ballot_sync, __any_sync, __all_sync) and the 32-bit integer
// reductions (__reduce_min_sync, __reduce_max_sync, __reduce_add_sync) go
// through the warp's barrier as the shuffles do; __popc and __ffs are g++'s.  Dynamic
// shared memory is poisoned with NaN bits before each block.  Inline PTX does
// not build.  A source that wraps its PTX in functions may leave them to this
// header where CUDA_EMU_TENSOR_CORES is defined (ssd_bwd_tc.cu,
// flash_attn_bwd.cu): cp.async
// (held back per thread until its group is waited for, so a read before the
// wait sees the poison), ldmatrix.x4 (.trans) and mma.sync m16n8k16 bf16 ->
// f32 (exact products, summed in double, one rounding per output), each
// warp-collective through the warp's barrier; ex2 (exp2f) and st.shared;
// and the warpgroup product wgmma.mma_async m64nNk16 bf16 -> f32 with A from
// registers or a descriptor and B from a descriptor (128- and 32-byte
// swizzles, K-major and MN-major), which is recorded at issue and applied at
// the wgmma.wait_group that retires its group, after the warpgroup's
// barrier: an accumulator read before that wait holds its old values, and
// the shared memory read is what it holds at the wait.
// tools/cuda_emu/build.py turns a .cu file into a shared library against it.
#pragma once
#include <ucontext.h>
#include <cmath>
#include <math.h>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <functional>
#include <vector>
#include <memory>
#include <climits>
#include <array>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

struct dim3 { unsigned x = 1, y = 1, z = 1; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3e { unsigned x, y, z; };
inline uint3e threadIdx, blockIdx;  // the running fiber's, set at each switch
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes { int numRegs = 0; size_t localSizeBytes = 0, sharedSizeBytes = 0; };
template <class F> inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F> inline int cudaFuncGetAttributes(cudaFuncAttributes*, F) { return 0; }
inline int cudaGetLastError() { return 0; }

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }

// bf16 with round to nearest even
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 h) { uint32_t u = (uint32_t)h.bits << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}

inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __expf(float x) { return std::exp(x); }
inline float __frcp_rn(float x) { return 1.f / x; }
using std::min;
using std::max;
inline unsigned char emu_dyn_smem[256 * 1024] __attribute__((aligned(16)));

struct EmuCopy { uint32_t dst; const void* src; int size, src_size; };

// One wgmma.mma_async of a warpgroup: the operands every thread gave at
// issue (its accumulator's address and, for a register A, its four A
// registers) and the descriptors, the same in every thread.
struct EmuWgmma {
  int n = 0, trans_b = 0, scale_d = 0;
  bool a_regs = false, applied = false;
  uint64_t da = 0, db = 0;
  std::vector<float*> d;                      // by thread of the warpgroup
  std::vector<std::array<uint32_t, 4>> a;     // by thread, register A only
};
struct EmuWarpgroup {
  int arrived = 0;
  unsigned gen = 0;
  std::vector<EmuWgmma> ops;  // in issue order
};

struct EmuFiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
};

struct EmuBlock {
  int nt = 0;
  std::vector<EmuFiber> fibers;
  ucontext_t sched;
  int block_arrived = 0;
  unsigned block_gen = 0;
  std::vector<int> warp_arrived;
  std::vector<unsigned> warp_gen;
  uint64_t progress = 0;      // arrivals, releases and finished fibers
  std::vector<uint64_t> xch;  // per thread exchange slot (32 or 64 bits)
  std::vector<uint32_t> tc;   // per thread, one mma.sync's six operand registers
  std::vector<std::vector<EmuCopy>> open_copies;                 // per thread
  std::vector<std::vector<std::vector<EmuCopy>>> copy_groups;    // per thread
  std::vector<EmuWarpgroup> wg;            // per warpgroup (128 threads)
  std::vector<int> wg_issued;              // per thread: its wgmma ops so far
  std::vector<std::vector<int>> wg_groups; // per thread: op count at each commit
  std::function<void()> body;
};
inline EmuBlock* emu_block;
inline int emu_tid;  // the running fiber's thread, set at each switch

inline void emu_yield() { swapcontext(&emu_block->fibers[emu_tid].ctx, &emu_block->sched); }

// Arrive at a barrier of n fibers; the last to arrive releases the others.
inline void emu_wait(int& arrived, unsigned& gen, int n) {
  ++emu_block->progress;
  const unsigned g = gen;
  if (++arrived == n) {
    arrived = 0;
    ++gen;
    return;
  }
  while (gen == g) emu_yield();
}

inline void __syncthreads() { emu_wait(emu_block->block_arrived, emu_block->block_gen, emu_block->nt); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  const int w = emu_tid / 32;
  emu_wait(emu_block->warp_arrived[w], emu_block->warp_gen[w], 32);
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "32- and 64-bit shuffles only");
  const int lane = emu_tid % 32, base = emu_tid - lane;
  uint64_t u = 0; std::memcpy(&u, &v, sizeof(T));
  emu_block->xch[emu_tid] = u;
  __syncwarp();
  const int src = base + ((lane ^ mask) % 32);
  uint64_t r = emu_block->xch[src];
  __syncwarp();
  T out; std::memcpy(&out, &r, sizeof(T));
  (void)width;
  return out;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int srcLane, int width = 32) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "32- and 64-bit shuffles only");
  const int lane = emu_tid % 32, base = emu_tid - lane;
  uint64_t u = 0; std::memcpy(&u, &v, sizeof(T));
  emu_block->xch[emu_tid] = u;
  __syncwarp();
  uint64_t r = emu_block->xch[base + (srcLane % 32)];
  __syncwarp();
  T out; std::memcpy(&out, &r, sizeof(T));
  (void)width;
  return out;
}

// The warp's votes and integer reductions: every lane posts its value, the
// warp's barrier, every lane reads all 32, the barrier again (as the
// shuffles); the mask is taken to be the full warp.
template <class T, class F>
inline T emu_warp_fold(T v, T init, F f) {
  const int base = emu_tid - emu_tid % 32;
  uint64_t u = 0; std::memcpy(&u, &v, sizeof(T));
  emu_block->xch[emu_tid] = u;
  __syncwarp();
  T acc = init;
  for (int l = 0; l < 32; ++l) {
    T x; const uint64_t r = emu_block->xch[base + l]; std::memcpy(&x, &r, sizeof(T));
    acc = f(acc, x, l);
  }
  __syncwarp();
  return acc;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  return emu_warp_fold<unsigned>(pred != 0, 0u, [](unsigned a, unsigned x, int l) { return a | (x << l); });
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }
inline int __all_sync(unsigned m, int pred) { return __ballot_sync(m, pred) == 0xffffffffu; }
template <class T> inline T __reduce_min_sync(unsigned, T v) {
  static_assert(sizeof(T) == 4, "32-bit reductions only");
  return emu_warp_fold<T>(v, v, [](T a, T x, int) { return x < a ? x : a; });
}
template <class T> inline T __reduce_max_sync(unsigned, T v) {
  static_assert(sizeof(T) == 4, "32-bit reductions only");
  return emu_warp_fold<T>(v, v, [](T a, T x, int) { return x > a ? x : a; });
}
template <class T> inline T __reduce_add_sync(unsigned, T v) {
  static_assert(sizeof(T) == 4, "32-bit reductions only");
  return emu_warp_fold<T>(v, T(0), [](T a, T x, int) { return (T)(a + x); });
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

inline void emu_fiber_entry() {
  emu_block->body();
  emu_block->fibers[emu_tid].done = true;
  ++emu_block->progress;
}  // returns to the scheduler through uc_link

template <class K, class... Args>
inline void emu_launch(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t, Args... args) {
  constexpr size_t kStack = 1 << 20;  // touched pages only
  blockDim = block; gridDim = grid;
  const int nt = block.x * block.y * block.z;
  if (nt % 32) { fprintf(stderr, "emu: block of %d threads\n", nt); abort(); }
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        EmuBlock eb;
        eb.nt = nt;
        eb.fibers = std::vector<EmuFiber>(nt);
        eb.warp_arrived.assign(nt / 32, 0);
        eb.warp_gen.assign(nt / 32, 0);
        eb.xch.assign(nt, 0);
        eb.tc.assign(6 * nt, 0);
        eb.open_copies.resize(nt);
        eb.copy_groups.resize(nt);
        eb.wg.resize((nt + 127) / 128);
        eb.wg_issued.assign(nt, 0);
        eb.wg_groups.resize(nt);
        eb.body = [&] { kernel(args...); };
        emu_block = &eb;
        std::memset(emu_dyn_smem, 0xff, sizeof(emu_dyn_smem));  // poison
        for (EmuFiber& f : eb.fibers) {
          f.stack.reset(new char[kStack]);
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = f.stack.get();
          f.ctx.uc_stack.ss_size = kStack;
          f.ctx.uc_link = &eb.sched;
          makecontext(&f.ctx, emu_fiber_entry, 0);
        }
        for (int live = nt; live > 0;) {
          const uint64_t before = eb.progress;
          for (int t = 0; t < nt; ++t) {
            if (eb.fibers[t].done) continue;
            emu_tid = t;
            threadIdx = {(unsigned)(t % block.x), (unsigned)((t / block.x) % block.y), (unsigned)(t / (block.x * block.y))};
            blockIdx = {bx, by, bz};
            swapcontext(&eb.sched, &eb.fibers[t].ctx);
            live -= eb.fibers[t].done;
          }
          if (live > 0 && eb.progress == before) {
            fprintf(stderr, "emu: deadlock, %d threads wait at barriers no thread reaches\n", live);
            abort();
          }
        }
        emu_block = nullptr;
      }
}

// ---------------------------------------------------------------------------
// Tensor-core primitives (see the header's first lines).

#define CUDA_EMU_TENSOR_CORES 1

struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }

inline uint32_t smem_addr(const void* p) {
  return (uint32_t)(static_cast<const unsigned char*>(p) - emu_dyn_smem);
}

inline void emu_cp_async(uint32_t dst, const void* src, int size, bool valid) {
  emu_block->open_copies[emu_tid].push_back({dst, src, size, valid ? size : 0});
}
inline void cp_async16(uint32_t dst, const void* src, bool valid) { emu_cp_async(dst, src, 16, valid); }
inline void cp_async4(uint32_t dst, const void* src, bool valid) { emu_cp_async(dst, src, 4, valid); }
inline void cp_async_commit() {
  std::vector<EmuCopy>& open = emu_block->open_copies[emu_tid];
  emu_block->copy_groups[emu_tid].push_back(std::move(open));
  open.clear();
}
template <int N> inline void cp_async_wait() {
  std::vector<std::vector<EmuCopy>>& groups = emu_block->copy_groups[emu_tid];
  while (groups.size() > (size_t)N) {
    for (const EmuCopy& c : groups.front()) {
      std::memset(emu_dyn_smem + c.dst, 0, c.size);
      if (c.src_size) std::memcpy(emu_dyn_smem + c.dst, c.src, c.src_size);
    }
    groups.erase(groups.begin());
  }
}

// ldmatrix.sync.aligned.m8n8.x4 (.trans): lane l gives the address of row
// l % 8 of matrix l / 8; register m of lane l holds row l / 4, columns
// 2 (l % 4) and + 1 of matrix m (of its transpose with .trans).
inline void emu_ldmatrix(uint32_t (&r)[4], uint32_t addr, bool trans) {
  const int lane = emu_tid % 32, base = emu_tid - lane;
  emu_block->xch[emu_tid] = addr;
  __syncwarp();
  for (int m = 0; m < 4; ++m) {
    uint16_t v[2];
    for (int h = 0; h < 2; ++h) {
      const int row = trans ? 2 * (lane % 4) + h : lane / 4;
      const int col = trans ? lane / 4 : 2 * (lane % 4) + h;
      std::memcpy(&v[h], emu_dyn_smem + emu_block->xch[base + 8 * m + row] + 2 * col, 2);
    }
    r[m] = v[0] | ((uint32_t)v[1] << 16);
  }
  __syncwarp();
}
inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) { emu_ldmatrix(r, addr, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) { emu_ldmatrix(r, addr, true); }

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, d += a b, with the
// fragment layouts of PTX's documentation (lane = 4 g + t): a's registers
// hold (row g, columns 2t, 2t + 1), (g + 8, same), (g, 2t + 8, 2t + 9),
// (g + 8, same); b's (rows 2t, 2t + 1, column g), (rows 2t + 8, 2t + 9,
// column g); d's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int lane = emu_tid % 32, base = emu_tid - lane;
  uint32_t* mine = &emu_block->tc[6 * emu_tid];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  __syncwarp();
  auto half = [](uint32_t u, int h) { return __uint_as_float(h ? (u & 0xffff0000u) : (u << 16)); };
  const uint32_t* tc = &emu_block->tc[6 * base];
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2), col = 2 * t + (e & 1);
    double s = 0.0;
    for (int k = 0; k < 16; ++k) {
      const float av = half(tc[6 * (4 * (row % 8) + (k % 8) / 2) + row / 8 + 2 * (k / 8)], k % 2);
      const float bv = half(tc[6 * (4 * col + (k % 8) / 2) + 4 + k / 8], k % 2);
      s += (double)av * (double)bv;
    }
    d[e] = (float)((double)d[e] + s);
  }
  __syncwarp();
}

inline float fast_exp2(float x) { return exp2f(x); }
inline void st_shared_b32(uint32_t addr, uint32_t v) { std::memcpy(emu_dyn_smem + addr, &v, 4); }

// ---------------------------------------------------------------------------
// wgmma.  A descriptor (PTX's matrix descriptor): bits 0-13 the start
// address / 16, 16-29 the leading byte offset / 16, 32-45 the stride byte
// offset / 16, 62-63 the swizzle (1: 128 bytes, 3: 32; 0, none, and 2, 64
// bytes, are not emulated).  With a swizzle of Wb bytes, rows of Wb bytes, the address
// of bf16 element (mn, k) of the operand is
//   K-major:  start + (mn / 8) SBO + (mn % 8) Wb + 2 k            (k < 16)
//   MN-major: start + (mn / (Wb / 2)) LBO + (k / 8) SBO + (k % 8) Wb
//             + 2 (mn % (Wb / 2))
// and the swizzle XORs address bits 4.. (log2(Wb / 16) of them) with bits
// 7..: the layouts of CUTLASS's canonical GMMA atoms.
inline uint32_t emu_wgmma_addr(uint64_t desc, bool mn_major, int mn, int k) {
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  const int layout = (int)(desc >> 62);
  if (layout != 1 && layout != 3) { fprintf(stderr, "emu: only the 128- and 32-byte swizzles are emulated\n"); abort(); }
  const uint32_t wb = layout == 1 ? 128 : 32;
  uint32_t addr;
  if (!mn_major) {
    addr = start + (mn / 8) * sbo + (mn % 8) * wb + 2 * k;
  } else {
    const uint32_t per = wb / 2;
    addr = start + (mn / per) * lbo + (k / 8) * sbo + (k % 8) * wb + 2 * (mn % per);
  }
  const uint32_t bits = wb == 128 ? 7 : 1;
  return addr ^ (((addr >> 7) & bits) << 4);
}
inline float emu_smem_bf16(uint32_t addr) {
  uint16_t h;
  std::memcpy(&h, emu_dyn_smem + addr, 2);
  return __uint_as_float((uint32_t)h << 16);
}

inline EmuWgmma& emu_wgmma_issue(int n, int trans_b, bool a_regs, uint64_t da, uint64_t db,
                                 int scale_d, float* d) {
  if (emu_block->nt % 128) { fprintf(stderr, "emu: wgmma in a block of %d threads\n", emu_block->nt); abort(); }
  EmuWarpgroup& wg = emu_block->wg[emu_tid / 128];
  const int idx = emu_block->wg_issued[emu_tid]++;
  if ((int)wg.ops.size() <= idx) {
    wg.ops.emplace_back();
    EmuWgmma& op = wg.ops.back();
    op.n = n; op.trans_b = trans_b; op.a_regs = a_regs; op.da = da; op.db = db;
    op.scale_d = scale_d;
    op.d.assign(128, nullptr);
    op.a.resize(128);
  }
  EmuWgmma& op = wg.ops[idx];
  if (op.n != n || op.trans_b != trans_b || op.a_regs != a_regs || op.da != da || op.db != db ||
      op.scale_d != scale_d) {
    fprintf(stderr, "emu: the threads of a warpgroup issued different wgmma operands\n");
    abort();
  }
  op.d[emu_tid % 128] = d;
  return op;
}

// d (64 x n) = (scale_d ? d : 0) + A B over k = 16: the exact products,
// summed in double, one rounding per output (as mma_bf16 above).
inline void emu_wgmma_apply(EmuWgmma& op) {
  float a[64][16], b[16][256];
  for (int r = 0; r < 64; ++r)
    for (int k = 0; k < 16; ++k) {
      if (op.a_regs) {  // thread 32 (r / 16) + 4 (r % 8) + (k % 8) / 2 holds it
        const int t = 32 * (r / 16) + 4 * (r % 8) + (k % 8) / 2;
        const uint32_t u = op.a[t][(r % 16) / 8 + 2 * (k / 8)];
        a[r][k] = __uint_as_float(k % 2 ? (u & 0xffff0000u) : (u << 16));
      } else {
        a[r][k] = emu_smem_bf16(emu_wgmma_addr(op.da, false, r, k));
      }
    }
  for (int k = 0; k < 16; ++k)
    for (int c = 0; c < op.n; ++c) b[k][c] = emu_smem_bf16(emu_wgmma_addr(op.db, op.trans_b, c, k));
  for (int t = 0; t < 128; ++t) {
    float* d = op.d[t];
    if (!d) { fprintf(stderr, "emu: a thread of the warpgroup did not issue a wgmma\n"); abort(); }
    const int w = t / 32, g = (t % 32) / 4, tq = t % 4;
    for (int j = 0; j < op.n / 8; ++j)
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * w + g + 8 * (e / 2), c = 8 * j + 2 * tq + (e % 2);
        double s = 0.0;
        for (int k = 0; k < 16; ++k) s += (double)a[r][k] * (double)b[k][c];
        float& out = d[4 * j + e];
        out = (float)((op.scale_d ? (double)out : 0.0) + s);
      }
  }
  op.applied = true;
}

inline void wgmma_fence() {}
inline void fence_async_smem() {}
template <int R> inline void wgmma_hold(float (&)[R][4]) {}
inline void wgmma_commit() { emu_block->wg_groups[emu_tid].push_back(emu_block->wg_issued[emu_tid]); }
// The warpgroup's barrier, then every op of the groups older than the N
// newest is applied (once, by the first thread through), in issue order.
template <int N> inline void wgmma_wait() {
  EmuWarpgroup& wg = emu_block->wg[emu_tid / 128];
  emu_wait(wg.arrived, wg.gen, 128);
  const std::vector<int>& groups = emu_block->wg_groups[emu_tid];
  if ((int)groups.size() <= N) return;
  const int upto = groups[groups.size() - 1 - N];
  for (int i = 0; i < upto; ++i)
    if (!wg.ops[i].applied) emu_wgmma_apply(wg.ops[i]);
}

// flash_common.cuh's two forms: m64n64k16 with A and B K-major in shared
// memory, and m64nNk16 with A in registers and B MN-major (d += A B).
inline void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db, int scale_d) {
  emu_wgmma_issue(64, 0, false, da, db, scale_d != 0, &d[0][0]);
}
template <int N>
inline void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t db) {
  EmuWgmma& op = emu_wgmma_issue(N, 1, true, 0, db, 1, &d[0][0]);
  for (int i = 0; i < 4; ++i) op.a[emu_tid % 128][i] = a[i];
}
