// Hadamard SATD of one tile, shared by rdcost.cu and rmd.cu.
//
// Counterpart of vtm_tpu/ops/rdcost.py:satd_batch_jax (RdCost::xGetHADs).  A
// tile's value is sum |H_th D H_tw^T| - dc + (dc >> 2) with Sylvester
// Hadamard matrices (dc = |coefficient [0][0]|), then normalised:
//   8x16 / 16x8: int(float(s) * float(2 / sqrt(128)))   (truncation)
//   4x8 / 8x4:   int(float(s) * float(2 / sqrt(32)))
//   8x8: (s + 2) >> 2    4x4: (s + 1) >> 1    2x2: s    SAD: |d|
// jax does the two float cases in float32 with round-to-nearest products, so
// this file uses __int2float_rn, __fmul_rn (no FMA contraction) and
// __float2int_rz, and the library is built without --use_fast_math.  The
// constants are the float32 values of jax's weak-typed Python floats.
//
// Two forms, exact in int32 for any difference a 10-bit picture gives:
//   satd_tile       one thread takes a whole tile (butterflies on a register
//                   array; rdcost.cu, any tile kind chosen at run time);
//   warp_satd_tile  TR lanes of a warp take a TR x TC tile, one row each: the
//                   row transform in registers, the column transform across
//                   the lanes with __shfl_xor_sync (rmd.cu, tile shape fixed
//                   at compile time).

#pragma once

#include "common.cuh"

// Tile kinds in xGetHADs's order of preference; the same numbers as
// vtm_tpu_torch/ops/rdcost.py:KINDS.
enum SatdKind {
  SATD_8x16 = 0,  // rows x cols
  SATD_16x8 = 1,
  SATD_4x8 = 2,
  SATD_8x4 = 3,
  SATD_8x8 = 4,
  SATD_4x4 = 5,
  SATD_2x2 = 6,
  SATD_SAD = 7,
};

#define SATD_NORM_16x8 0.176776692f  // float32(2 / sqrt(128))
#define SATD_NORM_8x4 0.353553385f   // float32(2 / sqrt(32))

__host__ __device__ constexpr int satd_kind(int h, int w) {
  if (w > h && h % 8 == 0 && w % 16 == 0) return SATD_8x16;
  if (w < h && w % 8 == 0 && h % 16 == 0) return SATD_16x8;
  if (w > h && h % 4 == 0 && w % 8 == 0) return SATD_4x8;
  if (w < h && w % 4 == 0 && h % 8 == 0) return SATD_8x4;
  if (h % 8 == 0 && w % 8 == 0) return SATD_8x8;
  if (h % 4 == 0 && w % 4 == 0) return SATD_4x4;
  if (h % 2 == 0 && w % 2 == 0) return SATD_2x2;
  return SATD_SAD;
}

__host__ __device__ constexpr int satd_tile_rows(int kind) {
  const int r[8] = {8, 16, 4, 8, 8, 4, 2, 1};
  return r[kind];
}

__host__ __device__ constexpr int satd_tile_cols(int kind) {
  const int c[8] = {16, 8, 8, 4, 8, 4, 2, 1};
  return c[kind];
}

// In-place Walsh-Hadamard transform of N values S apart (natural order).
template <int N, int S>
__device__ __forceinline__ void fwht(int* v) {
#pragma unroll
  for (int s = 1; s < N; s <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if ((i & s) == 0) {
        const int a = v[i * S], b = v[(i + s) * S];
        v[i * S] = a + b;
        v[(i + s) * S] = a - b;
      }
    }
  }
}

// sum |coeff| - dc + (dc >> 2) of the TH x TW tile diff(y, x).
template <int TH, int TW, class F>
__device__ __forceinline__ int had_tile(F diff) {
  int d[TH * TW];
#pragma unroll
  for (int y = 0; y < TH; ++y)
#pragma unroll
    for (int x = 0; x < TW; ++x) d[y * TW + x] = diff(y, x);
#pragma unroll
  for (int y = 0; y < TH; ++y) fwht<TW, 1>(d + y * TW);
#pragma unroll
  for (int x = 0; x < TW; ++x) fwht<TH, TW>(d + x);
  int s = 0;
#pragma unroll
  for (int i = 0; i < TH * TW; ++i) s += abs(d[i]);
  const int dc = abs(d[0]);
  return s - dc + (dc >> 2);
}

__device__ __forceinline__ int satd_norm_f32(int s, float norm) {
  return __float2int_rz(__fmul_rn(__int2float_rn(s), norm));
}

// The normalisation of a tile of N samples (the pairs 8x16 / 16x8 and
// 4x8 / 8x4 share theirs).
template <int N>
__device__ __forceinline__ int satd_normalise(int s) {
  if constexpr (N == 128) return satd_norm_f32(s, SATD_NORM_16x8);
  else if constexpr (N == 32) return satd_norm_f32(s, SATD_NORM_8x4);
  else if constexpr (N == 64) return (s + 2) >> 2;
  else if constexpr (N == 16) return (s + 1) >> 1;
  else return s;  // 2x2
}

constexpr unsigned FULL_WARP = 0xffffffffu;

// Normalised SATD of a TR x TC tile whose row i is d[] of lane i of an
// aligned group of TR lanes (lane % TR is the row); every lane of the group
// returns the tile's value.  All 32 lanes of the warp call it together, so
// one call takes 32 / TR tiles.  Blocks are one-dimensional.
template <int TR, int TC>
__device__ __forceinline__ int warp_satd_tile(int (&d)[TC]) {
  static_assert(TR >= 2 && TR <= 32 && 32 % TR == 0, "rows of a tile: 2..32 lanes");
  const int row = threadIdx.x & (TR - 1);
  fwht<TC, 1>(d);
#pragma unroll
  for (int s = 1; s < TR; s <<= 1) {
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const int o = __shfl_xor_sync(FULL_WARP, d[i], s);
      d[i] = (row & s) ? o - d[i] : d[i] + o;
    }
  }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < TC; ++i) sum += abs(d[i]);
#pragma unroll
  for (int s = 1; s < TR; s <<= 1) sum += __shfl_xor_sync(FULL_WARP, sum, s);
  const int dc = abs(__shfl_sync(FULL_WARP, d[0], 0, TR));
  return satd_normalise<TR * TC>(sum - dc + (dc >> 2));
}

// Normalised SATD of the tile of `kind` whose top-left sample is (y0, x0);
// diff(y, x) gives the difference at block coordinates.
template <class F>
__device__ __forceinline__ int satd_tile(int kind, int y0, int x0, F diff) {
  auto at = [&](int y, int x) { return diff(y0 + y, x0 + x); };
  switch (kind) {
    case SATD_8x16: return satd_normalise<128>(had_tile<8, 16>(at));
    case SATD_16x8: return satd_normalise<128>(had_tile<16, 8>(at));
    case SATD_4x8: return satd_normalise<32>(had_tile<4, 8>(at));
    case SATD_8x4: return satd_normalise<32>(had_tile<8, 4>(at));
    case SATD_8x8: return satd_normalise<64>(had_tile<8, 8>(at));
    case SATD_4x4: return satd_normalise<16>(had_tile<4, 4>(at));
    case SATD_2x2: return had_tile<2, 2>(at);
    default: return abs(at(0, 0));
  }
}
