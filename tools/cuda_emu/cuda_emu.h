// CPU emulation of the small part of CUDA that the port's CUDA-core kernels
// use (rglru_scan.cu, ssd_bwd.cu), so that their C++ can be run and held
// against the plain versions where there is no card and no nvcc: one
// std::thread per CUDA thread, std::barrier for __syncthreads, a per-warp
// barrier for __syncwarp and the 32-bit shuffles; blocks run one after
// another, so a kernel's __shared__ arrays become static ones.  Dynamic
// shared memory is poisoned with NaN bits before each block.  No tensor-core
// instruction, cp.async or inline PTX: kernels that use them do not build.
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
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __expf(float x) { return std::exp(x); }
inline float __frcp_rn(float x) { return 1.f / x; }
using std::min;
using std::max;
inline unsigned char emu_dyn_smem[256 * 1024] __attribute__((aligned(16)));

struct EmuBlock {
  std::barrier<>* bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<uint32_t> xch;  // per thread exchange slot (32-bit)
};
inline EmuBlock* emu_block;
inline thread_local int emu_tid;

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warp_bars[emu_tid / 32]->arrive_and_wait(); }

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const int lane = emu_tid % 32, base = emu_tid - lane;
  uint32_t u; std::memcpy(&u, &v, 4);
  emu_block->xch[emu_tid] = u;
  __syncwarp();
  const int src = base + ((lane ^ mask) % 32);
  uint32_t r = emu_block->xch[src];
  __syncwarp();
  T out; std::memcpy(&out, &r, 4);
  (void)width;
  return out;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int srcLane, int width = 32) {
  const int lane = emu_tid % 32, base = emu_tid - lane;
  uint32_t u; std::memcpy(&u, &v, 4);
  emu_block->xch[emu_tid] = u;
  __syncwarp();
  uint32_t r = emu_block->xch[base + (srcLane % 32)];
  __syncwarp();
  T out; std::memcpy(&out, &r, 4);
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
        EmuBlock eb; eb.bar = &bar; eb.xch.assign(nt, 0);
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
