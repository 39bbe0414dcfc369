// CPU emulation of the small part of CUDA that the port's kernels use
// (rglru_scan.cu, ssd_bwd.cu, ssd_bwd_tc.cu, pack_fill.cu), so that their C++
// can be run and held against the plain versions where there is no card and
// no nvcc: one std::thread per CUDA thread, std::barrier for __syncthreads, a
// per-warp barrier for __syncwarp and the 32- and 64-bit shuffles; blocks run one after
// another, so a kernel's __shared__ arrays become static ones.  Dynamic
// shared memory is poisoned with NaN bits before each block.  Inline PTX does
// not build.  A source that wraps its PTX in functions may leave them to this
// header where CUDA_EMU_TENSOR_CORES is defined (ssd_bwd_tc.cu): cp.async
// (held back per thread until its group is waited for, so a read before the
// wait sees the poison), ldmatrix.x4 (.trans) and mma.sync m16n8k16 bf16 ->
// f32 (exact products, summed in double, one rounding per output), each
// warp-collective through the warp's barrier.
// tools/cuda_emu/build.py turns a .cu file into a shared library against it.
#pragma once
#include <barrier>
#include <cmath>
#include <math.h>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <functional>
#include <thread>
#include <vector>
#include <memory>
#include <climits>

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
inline thread_local uint3e threadIdx, blockIdx;
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

struct EmuBlock {
  std::barrier<>* bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<uint64_t> xch;  // per thread exchange slot (32 or 64 bits)
  std::vector<uint32_t> tc;   // per thread, one mma.sync's six operand registers
};
inline EmuBlock* emu_block;
inline thread_local int emu_tid;

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warp_bars[emu_tid / 32]->arrive_and_wait(); }

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

template <class K, class... Args>
inline void emu_launch(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t, Args... args) {
  blockDim = block; gridDim = grid;
  const int nt = block.x * block.y * block.z;
  if (nt % 32) { fprintf(stderr, "emu: block of %d threads\n", nt); abort(); }
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(nt);
        EmuBlock eb; eb.bar = &bar; eb.xch.assign(nt, 0); eb.tc.assign(6 * nt, 0);
        for (int w = 0; w < nt / 32; ++w) eb.warp_bars.emplace_back(new std::barrier<>(32));
        emu_block = &eb;
        std::memset(emu_dyn_smem, 0xff, sizeof(emu_dyn_smem));  // poison
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            emu_tid = t;
            threadIdx = {(unsigned)(t % block.x), (unsigned)((t / block.x) % block.y), (unsigned)(t / (block.x * block.y))};
            blockIdx = {bx, by, bz};
            kernel(args...);
          });
        for (auto& th : ts) th.join();
      }
}

// ---------------------------------------------------------------------------
// Tensor-core primitives (see the header's first lines).

#define CUDA_EMU_TENSOR_CORES 1

struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }

inline uint32_t smem_addr(const void* p) {
  return (uint32_t)(static_cast<const unsigned char*>(p) - emu_dyn_smem);
}

struct EmuCopy { uint32_t dst; const void* src; int size, src_size; };
inline thread_local std::vector<EmuCopy> emu_open_copies;
inline thread_local std::vector<std::vector<EmuCopy>> emu_copy_groups;

inline void emu_cp_async(uint32_t dst, const void* src, int size, bool valid) {
  emu_open_copies.push_back({dst, src, size, valid ? size : 0});
}
inline void cp_async16(uint32_t dst, const void* src, bool valid) { emu_cp_async(dst, src, 16, valid); }
inline void cp_async4(uint32_t dst, const void* src, bool valid) { emu_cp_async(dst, src, 4, valid); }
inline void cp_async_commit() {
  emu_copy_groups.push_back(std::move(emu_open_copies));
  emu_open_copies.clear();
}
template <int N> inline void cp_async_wait() {
  while (emu_copy_groups.size() > (size_t)N) {
    for (const EmuCopy& c : emu_copy_groups.front()) {
      std::memset(emu_dyn_smem + c.dst, 0, c.size);
      if (c.src_size) std::memcpy(emu_dyn_smem + c.dst, c.src, c.src_size);
    }
    emu_copy_groups.erase(emu_copy_groups.begin());
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
