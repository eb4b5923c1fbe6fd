// Two-pass interpolation FIR of one output sample, shared by mc.cu
// (vtm_mc_tiles) and refine.cu (vtm_fir_blocks).
//
// Both jax kernels (vtm_tpu/ops/mc_kernel.py:mc_tiles and
// vtm_tpu/ops/refine_kernel.py:fir_blocks) run the same two passes over a
// window whose rows and columns are clamped into the source:
//   tmp[r]  = (sum_k cH[k] * src[r][ox + k] + off1) >> s1   (isFirst, notLast)
//   acc     =  sum_k cV[k] * tmp[oy + k]                    (notFirst)
// with off1 = -(IF_OFFS << s1).  This returns `acc`; the callers take the
// intermediate (acc >> 6) or one of the final-stage forms from it.  Sums are
// taken in uint32_t so that they wrap as jax's int32 sums do.

#pragma once

#include "common.cuh"

constexpr int IF_INTERNAL_PREC = 14;
constexpr int IF_OFFS = 1 << (IF_INTERNAL_PREC - 1);

template <int TAPS>
__device__ __forceinline__ int fir_acc(const int* __restrict__ src, int H, int W,
                                       int ox, int oy, const int* __restrict__ cH,
                                       const int* __restrict__ cV, int s1) {
  const uint32_t off1 = (uint32_t)(-(IF_OFFS << s1));
  int col[TAPS];
  int ch[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    col[k] = clampi(ox + k, W);
    ch[k] = cH[k];
  }
  uint32_t acc = 0;
#pragma unroll
  for (int kv = 0; kv < TAPS; ++kv) {
    const int* row = src + (long long)clampi(oy + kv, H) * W;
    uint32_t t = 0;
#pragma unroll
    for (int kh = 0; kh < TAPS; ++kh) t += (uint32_t)ch[kh] * (uint32_t)row[col[kh]];
    acc += (uint32_t)cV[kv] * (uint32_t)((int)(t + off1) >> s1);
  }
  return (int)acc;
}
