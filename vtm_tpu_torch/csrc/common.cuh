// Shared helpers of the in-loop filter kernels (deblock.cu, sao.cu, alf.cu).
//
// Every kernel works on int32 samples and must give the same integers as the
// jax reference in vtm_tpu/ops.  Two jax semantics matter here:
//   * gathers clamp out-of-range indices, so every gather index is clamped;
//   * int32 products wrap, so a product that can overflow is taken as
//     uint32_t and cast back (signed overflow is undefined in C++).
// `>>` on a signed int is an arithmetic shift in nvcc, as in jax.
//
// Entry points have a plain C interface (loaded with ctypes).  Each returns
// the cudaError_t of its launch (cudaGetLastError() right after it), 0 on
// success; it runs on the caller's stream and does not synchronise.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define VTM_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  // jnp.clip(v, lo, hi) == minimum(maximum(v, lo), hi), also when lo > hi
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int clampi(int v, int n) {
  // jax gather index clamp into [0, n-1]
  return min(max(v, 0), n - 1);
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ int mul_wrap(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

static inline dim3 grid2d(int nx, int ny, dim3 block) {
  return dim3((unsigned)((nx + block.x - 1) / block.x),
              (unsigned)((ny + block.y - 1) / block.y));
}

static inline int launch_status() { return (int)cudaGetLastError(); }
