// CPU emulation of the CUDA subset the port's kernels use, for checking
// kernel logic without a GPU (tests/_emu/build.py).
//
// Every block runs in turn; each of its threads is a std::thread with its own
// threadIdx / blockIdx, and __syncthreads() is a std::barrier over them.
// Blocks never overlap in time, so shared memory can be single copies: a
// static __shared__ array becomes a function-level static, and the dynamic
// one (`extern __shared__ int sm[]`, which build.py removes) one global
// buffer.
// Stream and memory calls act at once on host memory.  Device intrinsics map
// to their host meanings: __fmul_rn to one float product (volatile, built
// with -ffp-contract=off), __float2int_rz to C truncation.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static  // one copy for the block that runs
#define __constant__
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_bar = nullptr;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaMemcpyDeviceToDevice = 3,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emu"; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { memset(p, v, n); return 0; }
inline int cudaMemcpyAsync(void* d, const void* s, size_t n, int, cudaStream_t) { memcpy(d, s, n); return 0; }
inline int cudaFuncSetAttribute(const void*, int, int) { return 0; }
using std::max; using std::min; using std::abs;
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz((unsigned)v); }
inline int __float2int_rz(float f) { return (int)f; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __int2float_rn(int i) { return (float)i; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
inline int emu_sm_buf[1 << 16];
#define sm emu_sm_buf
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t, A... args) {
  blockDim = block; gridDim = grid;
  unsigned n = block.x * block.y * block.z;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(n);
      emu_bar = &bar;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < n; ++t)
        ts.emplace_back([&, t] {
          blockIdx = {bx, by, 0};
          threadIdx = {t % block.x, (t / block.x) % block.y, t / (block.x * block.y)};
          kernel(args...);
        });
      for (auto& th : ts) th.join();
    }
}
