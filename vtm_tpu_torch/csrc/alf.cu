// Adaptive loop filter: luma classification, the clipped diamond filter
// (luma 12 taps, chroma 6 taps) and the cross-component filter.
//
// Replaces, in vtm_tpu/ops/alf_kernel.py (driven by alf_all):
//   alf_classify_kernel  <- classify_picture  (one thread per 4x4 block)
//   alf_filter_kernel    <- alf_filter        (a tile a block, see below)
//   ccalf_kernel         <- ccalf_filter      (one thread per chroma sample)
// The virtual-boundary rules arrive as per-row tables built on the host
// (vb_row_offsets, classify_row_indices, classify_block_rows,
// ccalf_row_offsets), exactly as the jax kernels take them.  Every row and
// column gather index is clamped as jax clamps it.
//
// Bound on the H100: memory.  The filter moves about 4 bytes in and 4 out
// per sample from device memory, plus 2 x ntaps x 4 bytes of coefficient
// and clip map per 4x4 block (6 bytes per luma sample, 3 per chroma
// sample); classification reads the luma plane once per 4x4 block and
// writes 8 bytes per block.  The int32 arithmetic (at most 12 multiply-adds
// a sample) is far below the card's integer rate.
//
// The filter's design moves each of those bytes once: one instantiation per
// component (alf_filter_kernel<LUMA>: the taps from a constexpr table, the
// loop unrolled, so the row offsets live in registers); a block loads its
// tile of the padded plane with its halo (3 rows luma, 2 chroma, and 4
// columns) into shared memory once, and its rows' offsets and VB flags; a
// thread filters a run of 4 samples of one 4x4 block's row, so it loads
// that block's coefficients and clips once (16- or 8-byte loads, issued
// ahead of the tile's so that the two round trips overlap), reads the
// tile's rows as 16-byte vectors, and writes the 4 outputs as one int4.
// Staging the tile's coefficients in shared memory instead took the luma
// kernel from 64 registers to 40 but ran slower.

#include "common.cuh"

__constant__ int kActTh[16] = {0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4};
__constant__ int kTransposeTable[8] = {0, 1, 0, 2, 2, 3, 1, 3};
constexpr int kPad = 4;

__global__ void alf_classify_kernel(
    const int* __restrict__ pad, int Hp, int Wp, const int* __restrict__ y_i,
    const int* __restrict__ yd_i, const int* __restrict__ yu_i,
    const int* __restrict__ yu2_i, int nr, const uint8_t* __restrict__ drop_first,
    const uint8_t* __restrict__ drop_last, const int* __restrict__ mult, int H4,
    int W4, int shift, int* __restrict__ cls, int* __restrict__ tr) {
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  const int by = blockIdx.y * blockDim.y + threadIdx.y;
  if (bx >= W4 || by >= H4) return;
  const bool dl = drop_last[by], df = drop_first[by];
  const int a_lo = (!dl && df) ? 1 : 0, a_hi = dl ? 2 : 3;
  int sv = 0, sh = 0, sd0 = 0, sd1 = 0;
  for (int a = a_lo; a <= a_hi; ++a) {
    const int gy = clampi(2 * by + a, nr);
    const int* Ry = pad + (long long)clampi(y_i[gy], Hp) * Wp;
    const int* Rd = pad + (long long)clampi(yd_i[gy], Hp) * Wp;
    const int* Ru = pad + (long long)clampi(yu_i[gy], Hp) * Wp;
    const int* Ru2 = pad + (long long)clampi(yu2_i[gy], Hp) * Wp;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = 2 * (2 * bx + k) + 2;  // padded column of the even sample
      const int cm = clampi(x - 1, Wp), c0 = clampi(x, Wp);
      const int c1 = clampi(x + 1, Wp), c2 = clampi(x + 2, Wp);
      const int y0v = Ry[c0] * 2, yup1 = Ru[c1] * 2;
      sv += abs(y0v - Rd[c0] - Ru[c0]) + abs(yup1 - Ry[c1] - Ru2[c1]);
      sh += abs(y0v - Ry[c1] - Ry[cm]) + abs(yup1 - Ru[c2] - Ru[c0]);
      sd0 += abs(y0v - Rd[cm] - Ru[c1]) + abs(yup1 - Ry[c0] - Ru2[c2]);
      sd1 += abs(y0v - Ru[cm] - Rd[c1]) + abs(yup1 - Ru2[c0] - Ry[c2]);
    }
  }
  const int activity = clip3(0, 15, mul_wrap(sv + sh, mult[by]) >> shift);
  int class_idx = kActTh[activity];
  const bool hv_gt = sv > sh;
  const int hv1 = hv_gt ? sv : sh, hv0 = hv_gt ? sh : sv;
  const int dir_hv = hv_gt ? 1 : 3;
  const bool d_gt = sd0 > sd1;
  const int d1 = d_gt ? sd0 : sd1, d0 = d_gt ? sd1 : sd0;
  const int dir_d = d_gt ? 0 : 2;
  // int32 products that wrap, as in the reference
  const bool dmain = mul_wrap(d1, hv0) > mul_wrap(hv1, d0);
  const int hvd1 = dmain ? d1 : hv1, hvd0 = dmain ? d0 : hv0;
  const int main_dir = dmain ? dir_d : dir_hv;
  const int sec_dir = dmain ? dir_hv : dir_d;
  const int strength = hvd1 * 2 > 9 * hvd0 ? 2 : (hvd1 > 2 * hvd0 ? 1 : 0);
  if (strength > 0) class_idx += (((main_dir & 1) << 1) + strength) * 5;
  const long long o = (long long)by * W4 + bx;
  cls[o] = class_idx;
  tr[o] = kTransposeTable[clampi(main_dir * 2 + (sec_dir >> 1), 8)];
}

// The diamond's taps as (row-offset pair, dx): pair 0 is the current row
// twice; pair p > 0 reads rows o[p] and o[p + 1] of the VB-adjusted row
// offsets (o[0] = 0, o[1..6] = o_rows), sample a at +dx, sample b at -dx.
// Called with constant arguments only (unrolled loops), so it folds away.
__host__ __device__ constexpr int alf_tap(bool luma, int k, int field) {
  constexpr int kLuma[12][2] = {{5, 0}, {3, 1}, {3, 0},  {3, -1},
                                {1, 2}, {1, 1}, {1, 0},  {1, -1},
                                {1, -2}, {0, 3}, {0, 2}, {0, 1}};
  constexpr int kChroma[6][2] = {{3, 0}, {1, 1}, {1, 0},
                                 {1, -1}, {0, 2}, {0, 1}};
  return luma ? kLuma[k][field] : kChroma[k][field];
}

// A block's tile of the filter: TY rows x 64 columns of output, one thread a
// run of 4 samples of a row (one 4x4 block's row, so one set of
// coefficients), the padded plane's tile plus HR halo rows and 4 halo
// columns each side in shared memory.
template <bool LUMA>
struct AlfTile {
  static constexpr int NTAPS = LUMA ? 12 : 6;
  static constexpr int HR = LUMA ? 3 : 2;   // the largest row offset of a tap
  static constexpr int TX = 16;             // threads across, 4 samples each
  static constexpr int TY = LUMA ? 16 : 8;  // rows, one a thread
  static constexpr int TW = 4 * TX;
  static constexpr int SW = TW + 2 * kPad;  // kPad >= 3 columns: int4 aligned
  static constexpr int SH = TY + 2 * HR;
  static constexpr int NT = TX * TY;
};

// Columns 4tx .. 4tx + 11 of tile row `lrow + off` (sample i of the run at
// 4 + i); a row offset past the halo (only a malformed o_rows has one) is
// read from the plane itself, clamped as the jax gather clamps it.
template <bool LUMA>
__device__ __forceinline__ void alf_row(int (&a)[12], const int* tile, int lrow,
                                        int off, int tx, const int* __restrict__ src,
                                        int yp, int Hp, int Wp, int x) {
  using T = AlfTile<LUMA>;
  if (off >= -T::HR && off <= T::HR) {
    const int* p = tile + (lrow + off) * T::SW + 4 * tx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int4 v = *reinterpret_cast<const int4*>(p + 4 * c);
      a[4 * c] = v.x, a[4 * c + 1] = v.y, a[4 * c + 2] = v.z, a[4 * c + 3] = v.w;
    }
  } else {
    const int* row = src + (long long)clampi(yp + off, Hp) * Wp;
#pragma unroll
    for (int k = 0; k < 12; ++k) a[k] = row[clampi(x + k, Wp)];
  }
}

// The taps of pair P on the run's 4 samples.
template <bool LUMA, int P>
__device__ __forceinline__ void alf_pair(const int (&a)[12], const int (&b)[12],
                                         const int (&cur)[4],
                                         const int (&co)[AlfTile<LUMA>::NTAPS],
                                         const int (&cl)[AlfTile<LUMA>::NTAPS],
                                         uint32_t (&acc)[4]) {
#pragma unroll
  for (int k = 0; k < AlfTile<LUMA>::NTAPS; ++k) {
    if (alf_tap(LUMA, k, 0) != P) continue;
    const int dx = alf_tap(LUMA, k, 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = clip3(-cl[k], cl[k], a[4 + i + dx] - cur[i]) +
                    clip3(-cl[k], cl[k], b[4 + i - dx] - cur[i]);
      acc[i] += (uint32_t)mul_wrap(co[k], d);
    }
  }
}

// N coefficients of one 4x4 block: 16-byte (luma, 48 B) or 8-byte (chroma,
// 24 B) loads where the map is aligned so.
template <int N>
__device__ __forceinline__ void alf_block_taps(int (&v)[N], const int* __restrict__ p,
                                               bool vec) {
  if (vec && N == 12) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const int4 w = *reinterpret_cast<const int4*>(p + 4 * c);
      v[4 * c] = w.x, v[4 * c + 1] = w.y, v[4 * c + 2] = w.z, v[4 * c + 3] = w.w;
    }
  } else if (vec && N == 6) {
#pragma unroll
    for (int c = 0; c < N / 2; ++c) {
      const int2 w = *reinterpret_cast<const int2*>(p + 2 * c);
      v[2 * c] = w.x, v[2 * c + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

template <bool LUMA>
__global__ void __launch_bounds__(AlfTile<LUMA>::NT)
    alf_filter_kernel(const int* __restrict__ src, int Hp, int Wp,
                      const int* __restrict__ coef, const int* __restrict__ clipm,
                      const int* __restrict__ o_rows,
                      const uint8_t* __restrict__ near_vb, int H, int W, int maxv,
                      int vec_coef, int vec_out, int* __restrict__ out) {
  using T = AlfTile<LUMA>;
  __shared__ __align__(16) int tile[T::SH * T::SW];
  __shared__ int s_o[T::TY * 6];
  __shared__ uint8_t s_near[T::TY];
  const int x0 = blockIdx.x * T::TW, y0 = blockIdx.y * T::TY;
  const int tid = threadIdx.y * T::TX + threadIdx.x;
  const int tx = threadIdx.x, ly = threadIdx.y;
  const int y = y0 + ly, x = x0 + 4 * tx;
  // the run's block coefficients first, so that their round trip overlaps
  // the tile's (a thread past the plane reads its last block's, unused)
  const long long blk =
      ((long long)(min(y, H - 1) >> 2) * (W >> 2) + (min(x, W - 4) >> 2)) * T::NTAPS;
  int co[T::NTAPS], cl[T::NTAPS];
  alf_block_taps(co, coef + blk, vec_coef != 0);
  alf_block_taps(cl, clipm + blk, vec_coef != 0);

  // the tile: row r <-> padded row y0 + kPad - HR + r, column c <-> padded
  // column x0 + c, clamped as the jax gathers clamp; loads in batches of 8
  constexpr int N = T::SH * T::SW, CH = 8;
  for (int base = 0; base < N; base += CH * T::NT) {
    int v[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int e = base + k * T::NT + tid;
      if (e < N) {
        const int r = e / T::SW, c = e % T::SW;
        v[k] = src[(long long)clampi(y0 + kPad - T::HR + r, Hp) * Wp + clampi(x0 + c, Wp)];
      }
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int e = base + k * T::NT + tid;
      if (e < N) tile[e] = v[k];
    }
  }
  for (int e = tid; e < T::TY * 6; e += T::NT)
    s_o[e] = y0 + e / 6 < H ? o_rows[(long long)y0 * 6 + e] : 0;
  for (int e = tid; e < T::TY; e += T::NT) s_near[e] = y0 + e < H ? near_vb[y0 + e] : 0;
  __syncthreads();

  if (y >= H || x >= W) return;
  int o[7];
  o[0] = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) o[i + 1] = s_o[ly * 6 + i];

  const int lrow = ly + T::HR, yp = y + kPad;
  int s0[12], a[12], b[12];
  alf_row<LUMA>(s0, tile, lrow, 0, tx, src, yp, Hp, Wp, x);
  const int cur[4] = {s0[4], s0[5], s0[6], s0[7]};
  uint32_t acc[4] = {0, 0, 0, 0};
  alf_pair<LUMA, 0>(s0, s0, cur, co, cl, acc);
  alf_row<LUMA>(a, tile, lrow, o[1], tx, src, yp, Hp, Wp, x);
  alf_row<LUMA>(b, tile, lrow, o[2], tx, src, yp, Hp, Wp, x);
  alf_pair<LUMA, 1>(a, b, cur, co, cl, acc);
  alf_row<LUMA>(a, tile, lrow, o[3], tx, src, yp, Hp, Wp, x);
  alf_row<LUMA>(b, tile, lrow, o[4], tx, src, yp, Hp, Wp, x);
  alf_pair<LUMA, 3>(a, b, cur, co, cl, acc);
  if (LUMA) {
    alf_row<LUMA>(a, tile, lrow, o[5], tx, src, yp, Hp, Wp, x);
    alf_row<LUMA>(b, tile, lrow, o[6], tx, src, yp, Hp, Wp, x);
    alf_pair<LUMA, 5>(a, b, cur, co, cl, acc);
  }

  const int shift = 7;  // NUM_BITS - 1
  const bool nv = s_near[ly] != 0;
  int r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = (int)acc[i];
    const int d = nv ? (v + (1 << (shift + 2))) >> (shift + 3)
                     : (v + (1 << (shift - 1))) >> shift;
    r[i] = clip3(0, maxv, cur[i] + d);
  }
  int* op = out + (long long)y * W + x;
  if (vec_out) {
    int4 w;
    w.x = r[0], w.y = r[1], w.z = r[2], w.w = r[3];
    *reinterpret_cast<int4*>(op) = w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) op[i] = r[i];
  }
}

__global__ void ccalf_kernel(const int* __restrict__ luma, int Hp, int Wp,
                             const int* __restrict__ dst,
                             const int* __restrict__ coef,
                             const int* __restrict__ o_rows,
                             const uint8_t* __restrict__ skip, int Hc, int Wc,
                             int sx, int sy, int maxv, int* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Wc || y >= Hc) return;
  const long long oc = (long long)y * Wc + x;
  const int d = dst[oc];
  if (skip[y]) {
    out[oc] = d;
    return;
  }
  const int yl = (y << sy) + kPad, xl = (x << sx) + kPad;
  auto at = [&](int r, int dx) {
    return luma[(long long)clampi(r, Hp) * Wp + clampi(xl + dx, Wp)];
  };
  const int r1 = yl + o_rows[y * 3], r2 = yl + o_rows[y * 3 + 1];
  const int r3 = yl + o_rows[y * 3 + 2];
  const int curr = at(yl, 0);
  const int* c = coef + ((long long)(y >> 2) * (Wc >> 2) + (x >> 2)) * 7;
  uint32_t s = (uint32_t)mul_wrap(c[0], at(r2, 0) - curr);
  s += (uint32_t)mul_wrap(c[1], at(yl, -1) - curr);
  s += (uint32_t)mul_wrap(c[2], at(yl, 1) - curr);
  s += (uint32_t)mul_wrap(c[3], at(r1, -1) - curr);
  s += (uint32_t)mul_wrap(c[4], at(r1, 0) - curr);
  s += (uint32_t)mul_wrap(c[5], at(r1, 1) - curr);
  s += (uint32_t)mul_wrap(c[6], at(r3, 0) - curr);
  int v = ((int)s + 64) >> 7;  // SCALE_BITS_CC
  // ClipPel(sum + half) - half (AdaptiveLoopFilter.cpp:1399)
  const int half = (maxv + 1) >> 1;
  v = clip3(0, maxv, v + half) - half;
  out[oc] = clip3(0, maxv, v + d);
}

VTM_API int vtm_alf_classify(const int* pad, int Hp, int Wp, const int* y_i,
                             const int* yd_i, const int* yu_i,
                             const int* yu2_i, int nr,
                             const uint8_t* drop_first,
                             const uint8_t* drop_last, const int* mult, int H4,
                             int W4, int bit_depth, int* cls, int* tr,
                             void* stream) {
  if (H4 == 0 || W4 == 0) return 0;
  const dim3 block(32, 4);
  alf_classify_kernel<<<grid2d(W4, H4, block), block, 0,
                        (cudaStream_t)stream>>>(
      pad, Hp, Wp, y_i, yd_i, yu_i, yu2_i, nr, drop_first, drop_last, mult, H4,
      W4, bit_depth + 4, cls, tr);
  return launch_status();
}

VTM_API int vtm_alf_filter(const int* src_pad, int Hp, int Wp, const int* coef,
                           const int* clip, int luma, const int* o_rows,
                           const uint8_t* near_vb, int H, int W, int bit_depth,
                           int* out, void* stream) {
  if (H == 0 || W == 0) return 0;
  if (W % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int maxv = (1 << bit_depth) - 1;
  const int vec_out = ((uintptr_t)out & 15) == 0;
  const uintptr_t maps = (uintptr_t)coef | (uintptr_t)clip;
  if (luma) {
    using T = AlfTile<true>;
    alf_filter_kernel<true><<<grid2d(W / 4, H, dim3(T::TX, T::TY)), dim3(T::TX, T::TY), 0,
                              st>>>(src_pad, Hp, Wp, coef, clip, o_rows, near_vb, H, W,
                                    maxv, (maps & 15) == 0, vec_out, out);
  } else {
    using T = AlfTile<false>;
    alf_filter_kernel<false><<<grid2d(W / 4, H, dim3(T::TX, T::TY)), dim3(T::TX, T::TY), 0,
                               st>>>(src_pad, Hp, Wp, coef, clip, o_rows, near_vb, H, W,
                                     maxv, (maps & 7) == 0, vec_out, out);
  }
  return launch_status();
}

VTM_API int vtm_ccalf_filter(const int* luma_pad, int Hp, int Wp,
                             const int* dst, const int* coef,
                             const int* o_rows, const uint8_t* skip, int Hc,
                             int Wc, int sx, int sy, int bit_depth, int* out,
                             void* stream) {
  if (Hc == 0 || Wc == 0) return 0;
  const dim3 block(32, 8);
  ccalf_kernel<<<grid2d(Wc, Hc, block), block, 0, (cudaStream_t)stream>>>(
      luma_pad, Hp, Wp, dst, coef, o_rows, skip, Hc, Wc, sx, sy,
      (1 << bit_depth) - 1, out);
  return launch_status();
}
