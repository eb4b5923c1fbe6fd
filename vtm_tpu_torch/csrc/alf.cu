// Adaptive loop filter: luma classification, the clipped diamond filter
// (luma 12 taps, chroma 6 taps) and the cross-component filter.
//
// Replaces, in vtm_tpu/ops/alf_kernel.py (driven by alf_all):
//   alf_classify_kernel  <- classify_picture  (one thread per 4x4 block)
//   alf_filter_kernel    <- alf_filter        (one thread per sample)
//   ccalf_kernel         <- ccalf_filter      (one thread per chroma sample)
// The virtual-boundary rules arrive as per-row tables built on the host
// (vb_row_offsets, classify_row_indices, classify_block_rows,
// ccalf_row_offsets), exactly as the jax kernels take them.  Every row and
// column gather index is clamped as jax clamps it.
//
// Bound on the H100: memory.  The filter reads each padded sample from L1/L2
// for up to 25 taps but moves about 4 bytes in and 4 out per sample from
// device memory, plus 2 x ntaps x 4 bytes of coefficient/clip map per 4x4
// block (about 6 bytes per luma sample); classification reads the luma plane
// once per 4x4 block and writes 8 bytes per block.  The int32 arithmetic
// (at most 12 multiply-adds a sample) is far below the card's integer rate.

#include "common.cuh"

__constant__ int kActTh[16] = {0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4};
__constant__ int kTransposeTable[8] = {0, 1, 0, 2, 2, 3, 1, 3};
// (row-offset pair, dx): pair 0 is (0, 0); pair p > 0 is (o[p-1], o[p]).
__constant__ int kLumaTaps[12][2] = {{5, 0}, {3, 1}, {3, 0},  {3, -1},
                                     {1, 2}, {1, 1}, {1, 0},  {1, -1},
                                     {1, -2}, {0, 3}, {0, 2}, {0, 1}};
__constant__ int kChromaTaps[6][2] = {{3, 0}, {1, 1}, {1, 0},
                                      {1, -1}, {0, 2}, {0, 1}};

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

__global__ void alf_filter_kernel(const int* __restrict__ src, int Hp, int Wp,
                                  const int* __restrict__ coef,
                                  const int* __restrict__ clipm, int ntaps,
                                  int luma, const int* __restrict__ o_rows,
                                  const uint8_t* __restrict__ near_vb, int H,
                                  int W, int maxv, int* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  int o[7];
  o[0] = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) o[i + 1] = o_rows[y * 6 + i];
  auto at = [&](int r, int c) {
    return src[(long long)clampi(r, Hp) * Wp + clampi(c, Wp)];
  };
  const int yp = y + kPad, xp = x + kPad;
  const int curr = at(yp, xp);
  const long long cb = ((long long)(y >> 2) * (W >> 2) + (x >> 2)) * ntaps;
  uint32_t acc = 0;
  for (int k = 0; k < ntaps; ++k) {
    const int op = luma ? kLumaTaps[k][0] : kChromaTaps[k][0];
    const int dx = luma ? kLumaTaps[k][1] : kChromaTaps[k][1];
    const int oa = op ? o[op] : 0, ob = op ? o[op + 1] : 0;
    const int cl = clipm[cb + k];
    const int d = clip3(-cl, cl, at(yp + oa, xp + dx) - curr) +
                  clip3(-cl, cl, at(yp + ob, xp - dx) - curr);
    acc += (uint32_t)mul_wrap(coef[cb + k], d);
  }
  const int shift = 7;  // NUM_BITS - 1
  int v = (int)acc;
  v = near_vb[y] ? (v + (1 << (shift + 2))) >> (shift + 3)
                 : (v + (1 << (shift - 1))) >> shift;
  out[(long long)y * W + x] = clip3(0, maxv, curr + v);
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
  const dim3 block(32, 8);
  alf_filter_kernel<<<grid2d(W, H, block), block, 0, (cudaStream_t)stream>>>(
      src_pad, Hp, Wp, coef, clip, luma ? 12 : 6, luma, o_rows, near_vb, H, W,
      (1 << bit_depth) - 1, out);
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
