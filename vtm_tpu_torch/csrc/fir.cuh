// Constants of the two-pass interpolation FIR, shared by mc.cu
// (vtm_mc_tiles) and refine.cu (vtm_fir_blocks).
//
// Both jax kernels (vtm_tpu/ops/mc_kernel.py:mc_tiles and
// vtm_tpu/ops/refine_kernel.py:fir_blocks) run the same two passes over a
// window whose rows and columns are clamped into the source:
//   tmp[r]  = (sum_k cH[k] * src[r][ox + k] + off1) >> s1   (isFirst, notLast)
//   acc     =  sum_k cV[k] * tmp[oy + k]                    (notFirst)
// with off1 = -(IF_OFFS << s1); the callers take the intermediate
// (acc >> 6) or one of the final-stage forms from `acc`.  Sums are taken in
// uint32_t so that they wrap as jax's int32 sums do.

#pragma once

#include "common.cuh"

constexpr int IF_INTERNAL_PREC = 14;
constexpr int IF_OFFS = 1 << (IF_INTERNAL_PREC - 1);
