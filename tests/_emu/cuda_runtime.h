// CPU emulation of the CUDA subset the port's kernels use, for checking
// kernel logic without a GPU (tests/_emu/build.py).
//
// Every block runs in turn; each of its threads is a std::thread with its own
// threadIdx / blockIdx, and __syncthreads() is a std::barrier over them.
// Blocks never overlap in time, so shared memory can be single copies: a
// static __shared__ array becomes a function-level static, and the dynamic
// one (`extern __shared__ T name[]`, which build.py turns into a pointer to
// it) one global buffer.
// Warps (one-dimensional blocks): each aligned group of 32 threads has a
// std::barrier of its own for __syncwarp(); a shuffle writes the lane's value
// into its exchange slot, waits on the warp's barrier, reads the source
// lane's slot and waits again, so every lane of the warp must take part, as
// the kernels' full-mask shuffles require; __reduce_min_sync likewise
// reads every lane's slot between two waits.
// A lane's words of a call that exchanges more than one (tc.cuh's twin)
// go through emu_frag_slot the same way.
// Stream and memory calls act at once on host memory.  Device intrinsics map
// to their host meanings: __fmul_rn to one float product (volatile, built
// with -ffp-contract=off), __float2int_rz to C truncation.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static  // one copy for the block that runs
#define __constant__
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct alignas(8) int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_bars;
inline int emu_lane_slot[1024];
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_bars[threadIdx.x / 32]->arrive_and_wait(); }
inline int emu_shfl(int v, int src_lane) {
  const unsigned base = threadIdx.x & ~31u;
  emu_lane_slot[threadIdx.x] = v;
  __syncwarp();
  const int r = emu_lane_slot[base + src_lane];
  __syncwarp();
  return r;
}
inline int __shfl_xor_sync(unsigned, int v, int mask, int = 32) {
  return emu_shfl(v, (threadIdx.x & 31) ^ mask);
}
inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  return emu_shfl(v, (threadIdx.x & 31 & ~(width - 1)) + src % width);
}
// a lane's words for warp-collective calls of more than one value (the
// tensor-core products of tc.cuh's twin)
inline uint32_t emu_frag_slot[1024][6];
inline long long emu_lane_slot64[1024];
inline long long __shfl_down_sync(unsigned, long long v, int delta) {
  const unsigned lane = threadIdx.x & 31;
  emu_lane_slot64[threadIdx.x] = v;
  __syncwarp();
  const long long r = lane + delta < 32 ? emu_lane_slot64[threadIdx.x + delta] : v;
  __syncwarp();
  return r;
}
inline int __reduce_min_sync(unsigned, int v) {
  // every lane of the warp takes part (full mask)
  const unsigned base = threadIdx.x & ~31u;
  const unsigned n = std::min(32u, blockDim.x * blockDim.y * blockDim.z - base);
  emu_lane_slot[threadIdx.x] = v;
  __syncwarp();
  int m = v;
  for (unsigned l = 0; l < n; ++l) m = std::min(m, emu_lane_slot[base + l]);
  __syncwarp();
  return m;
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaMemcpyDeviceToDevice = 3,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
struct cudaFuncAttributes { int numRegs = 0; size_t localSizeBytes = 0, sharedSizeBytes = 0; };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emu"; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { memset(p, v, n); return 0; }
inline int cudaMemcpyAsync(void* d, const void* s, size_t n, int, cudaStream_t) { memcpy(d, s, n); return 0; }
inline int cudaFuncSetAttribute(const void*, int, int) { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }  // one SM
inline int cudaFuncGetAttributes(cudaFuncAttributes* a, const void*) { *a = {}; return 0; }
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
using std::max; using std::min; using std::abs;
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz((unsigned)v); }
inline int __float2int_rz(float f) { return (int)f; }
// byte n of the result is byte (s >> 4n) & 7 of y:x (selector nibbles below 8)
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n) r |= (unsigned)(v >> 8 * ((s >> 4 * n) & 7) & 0xFF) << 8 * n;
  return r;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __int2float_rn(int i) { return (float)i; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
#define emu_asm(...) ((void)0)
alignas(16) inline int emu_sm_buf[1 << 16];
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t, A... args) {
  blockDim = block; gridDim = grid;
  unsigned n = block.x * block.y * block.z;
  emu_warp_bars.clear();
  for (unsigned w = 0; w < n; w += 32)
    emu_warp_bars.push_back(std::make_unique<std::barrier<>>(std::min(32u, n - w)));
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(n);
        emu_bar = &bar;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < n; ++t)
          ts.emplace_back([&, t] {
            blockIdx = {bx, by, bz};
            threadIdx = {t % block.x, (t / block.x) % block.y, t / (block.x * block.y)};
            kernel(args...);
          });
        for (auto& th : ts) th.join();
      }
}
