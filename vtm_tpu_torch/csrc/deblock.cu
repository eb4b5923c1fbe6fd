// Deblocking of one edge direction: the luma and chroma vertical-edge filters.
//
// Replaces vtm_tpu/ops/deblock_kernel.py:deblock_dir, i.e. luma_ver_delta
// (luma) and chroma_ver_core (chroma).  Horizontal edges run through the same
// kernels on the transposed plane: the wrapper passes swapped strides for the
// plane and the maps, so nothing is transposed in memory.
//
// One thread per (row, edge segment): it repeats the segment's decision on
// lines 0 and 3 (chroma: 0 and dec_line) of its row group, then writes the
// filtered P and Q samples of its own row.  The result is written out of
// place: `out` starts as a copy of `in` (cudaMemcpyAsync) and every read
// comes from `in`, so edge order cannot matter.  The jax version sums
// per-window deltas instead; the two agree because the max-filter-length
// rules keep the samples one edge writes disjoint from another's.
//
// Bound on the H100: memory.  A sample is read by at most four threads
// (three decision/window loads for the segment's rows), mostly from L1/L2;
// device traffic is about one read and one write of each int32 sample plus
// the maps, so about 8 bytes per sample, and no arithmetic limit is near.

#include "common.cuh"

__constant__ int kDB7[7] = {59, 50, 41, 32, 23, 14, 5};
__constant__ int kDB5[7] = {58, 45, 32, 19, 6, 0, 0};
__constant__ int kDB3[7] = {53, 32, 11, 0, 0, 0, 0};
__constant__ int kTC7[7] = {6, 5, 4, 3, 2, 1, 1};
__constant__ int kTC3[7] = {6, 4, 2, 0, 0, 0, 0};

// Luma window: L(a, i) is the sample at offset i in [-8, 7] from the edge.
#define L(a, i) (a)[(i) + 8]
// Chroma window: C(a, i), i in [-4, 3].
#define C(a, i) (a)[(i) + 4]

__device__ __forceinline__ bool luma_strong_plain(const int* s, int d, int beta,
                                                  int tc) {
  const int m4 = L(s, 0), m3 = L(s, -1), m7 = L(s, 3), m0 = L(s, -4);
  return (abs(m0 - m3) + abs(m7 - m4)) < (beta >> 3) && d < (beta >> 2) &&
         abs(m3 - m4) < ((tc * 5 + 1) >> 1);
}

__device__ __forceinline__ bool luma_strong_large(const int* s, int d, int beta,
                                                  int tc, int max_p, int max_q,
                                                  bool side_p, bool side_q) {
  const int m4 = L(s, 0), m3 = L(s, -1), m7 = L(s, 3), m0 = L(s, -4);
  const int sp3_base = abs(m0 - m3), sq3_base = abs(m7 - m4);
  int sp3 = max_p == 7
                ? sp3_base + abs(L(s, -5) - L(s, -6) - L(s, -7) + L(s, -8))
                : sp3_base;
  const int mp4 = max_p == 7 ? L(s, -8) : L(s, -6);
  sp3 = side_p ? (sp3 + abs(m0 - mp4) + 1) >> 1 : sp3_base;
  int sq3 = max_q == 7
                ? sq3_base + abs(L(s, 4) - L(s, 5) - L(s, 6) + L(s, 7))
                : sq3_base;
  const int m11 = max_q == 7 ? L(s, 7) : L(s, 5);
  sq3 = side_q ? (sq3 + abs(m11 - m7) + 1) >> 1 : sq3_base;
  return (sp3 + sq3) < (beta * 3 >> 5) && d < (beta >> 4) &&
         abs(m3 - m4) < ((tc * 5 + 1) >> 1);
}

__device__ __forceinline__ int luma_dp(const int* a, int off) {
  return abs(L(a, -3 + off) - 2 * L(a, -2 + off) + L(a, -1 + off));
}

__device__ __forceinline__ int luma_dq(const int* a, int off) {
  return abs(L(a, 0 + off) - 2 * L(a, 1 + off) + L(a, 2 + off));
}

__device__ __forceinline__ int luma_long_val(int pos, int n, int src, int mid,
                                             int ref, int tc) {
  const int co = n == 7 ? kDB7[pos] : (n == 5 ? kDB5[pos] : kDB3[pos]);
  const int tck = n == 3 ? kTC3[pos] : kTC7[pos];
  const int cval = (tc * tck) >> 1;
  const int v = (mid * co + ref * (64 - co) + 32) >> 6;
  return clip3(src - cval, src + cval, v);
}

// Plane element (r, c) of the oriented frame is at r * prs + c * pcs; map
// element (r4, c4) at r4 * mrs + c4 * mcs.  row_fast puts threadIdx.x on rows
// (horizontal edges, where rows of the oriented frame are contiguous).
__global__ void luma_ver_kernel(
    const int* __restrict__ in, int* __restrict__ out, int H, int W,
    long long prs, long long pcs, const uint8_t* __restrict__ act,
    const int* __restrict__ tcm, const int* __restrict__ betam,
    const int* __restrict__ mpm, const int* __restrict__ mqm,
    const uint8_t* __restrict__ nopm, const uint8_t* __restrict__ noqm,
    long long mrs, long long mcs, int maxv, int row_fast) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y * blockDim.y + threadIdx.y;
  const int seg = row_fast ? b : a;
  const int row = row_fast ? a : b;
  if (seg >= (W >> 2) || row >= ((H >> 2) << 2)) return;
  const long long mo = (long long)(row >> 2) * mrs + (long long)seg * mcs;
  if (!act[mo]) return;
  const int tc = tcm[mo], beta = betam[mo], max_p = mpm[mo], max_q = mqm[mo];
  const bool pm = !nopm[mo], qm = !noqm[mo];
  const int x0 = seg * 4, r0 = row & ~3;

  int l0[16], l3[16], s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long c = (long long)clampi(x0 + j - 8, W) * pcs;
    l0[j] = in[(long long)r0 * prs + c];
    l3[j] = in[(long long)(r0 + 3) * prs + c];
    s[j] = in[(long long)row * prs + c];
  }
  int* orow = out + (long long)row * prs;
  auto put = [&](int i, int v) {
    const int x = x0 + i;
    if (x >= 0 && x < W) orow[(long long)x * pcs] = v;
  };

  const bool side_p = max_p > 3, side_q = max_q > 3;
  const int dp0 = luma_dp(l0, 0), dq0 = luma_dq(l0, 0);
  const int dp3 = luma_dp(l3, 0), dq3 = luma_dq(l3, 0);
  const int dp0l = side_p ? (dp0 + luma_dp(l0, -3) + 1) >> 1 : dp0;
  const int dp3l = side_p ? (dp3 + luma_dp(l3, -3) + 1) >> 1 : dp3;
  const int dq0l = side_q ? (dq0 + luma_dq(l0, 3) + 1) >> 1 : dq0;
  const int dq3l = side_q ? (dq3 + luma_dq(l3, 3) + 1) >> 1 : dq3;
  const int dl = (dp0l + dq0l) + (dp3l + dq3l);
  const int side_thresh = (beta + (beta >> 1)) >> 3;
  const bool swl =
      luma_strong_large(l0, 2 * (dp0l + dq0l), beta, tc, max_p, max_q, side_p,
                        side_q) &&
      luma_strong_large(l3, 2 * (dp3l + dq3l), beta, tc, max_p, max_q, side_p,
                        side_q);
  const bool use_long = (side_p || side_q) && dl < beta && swl;

  if (use_long) {
    // xFilteringPandQ: both sides filtered once swl holds
    const int n_p = side_p ? max_p : 3, n_q = side_q ? max_q : 3;
    const int ref_p = n_p == 7   ? (L(s, -7) + L(s, -8) + 1) >> 1
                      : n_p == 3 ? (L(s, -3) + L(s, -4) + 1) >> 1
                                 : (L(s, -5) + L(s, -6) + 1) >> 1;
    const int ref_q = n_q == 7   ? (L(s, 6) + L(s, 7) + 1) >> 1
                      : n_q == 3 ? (L(s, 2) + L(s, 3) + 1) >> 1
                                 : (L(s, 4) + L(s, 5) + 1) >> 1;
    const int mx = max(n_p, n_q), mn = min(n_p, n_q);
    int mid;
    if (n_p == n_q) {
      if (n_p == 5)
        mid = (2 * (L(s, -1) + L(s, 0) + L(s, -2) + L(s, 1) + L(s, -3) +
                    L(s, 2)) +
               L(s, -4) + L(s, 3) + L(s, -5) + L(s, 4) + 8) >> 4;
      else
        mid = (2 * (L(s, -1) + L(s, 0)) + L(s, -2) + L(s, 1) + L(s, -3) +
               L(s, 2) + L(s, -4) + L(s, 3) + L(s, -5) + L(s, 4) + L(s, -6) +
               L(s, 5) + L(s, -7) + L(s, 6) + 8) >> 4;
    } else if (mx == 7 && mn == 5) {
      mid = (2 * (L(s, -1) + L(s, 0) + L(s, -2) + L(s, 1)) + L(s, -3) +
             L(s, 2) + L(s, -4) + L(s, 3) + L(s, -5) + L(s, 4) + L(s, -6) +
             L(s, 5) + 8) >> 4;
    } else if (mx == 7 && mn == 3) {
      if (n_q > n_p)  // asymmetric 3/7 (swapped-pointer form)
        mid = (2 * (L(s, 0) + L(s, -1)) + L(s, -1) +
               2 * (L(s, -2) + L(s, -3)) + L(s, 1) + L(s, -2) + L(s, 2) +
               L(s, 3) + L(s, 4) + L(s, 5) + L(s, 6) + 8) >> 4;
      else
        mid = (2 * (L(s, -1) + L(s, 0)) + L(s, 0) + 2 * (L(s, 1) + L(s, 2)) +
               L(s, -2) + L(s, 1) + L(s, -3) + L(s, -4) + L(s, -5) +
               L(s, -6) + L(s, -7) + 8) >> 4;
    } else {
      mid = (L(s, -1) + L(s, 0) + L(s, -2) + L(s, 1) + L(s, -3) + L(s, 2) +
             L(s, -4) + L(s, 3) + 4) >> 3;
    }
#pragma unroll
    for (int pos = 0; pos < 7; ++pos) {
      if (pm && pos < n_p)
        put(-1 - pos, luma_long_val(pos, n_p, L(s, -1 - pos), mid, ref_p, tc));
      if (qm && pos < n_q)
        put(pos, luma_long_val(pos, n_q, L(s, pos), mid, ref_q, tc));
    }
    return;
  }

  const int d = (dp0 + dq0) + (dp3 + dq3);
  if (!(d < beta)) return;
  const bool filt_p = max_p > 1 && max_q > 1 && (dp0 + dp3) < side_thresh;
  const bool filt_q = max_p > 1 && max_q > 1 && (dq0 + dq3) < side_thresh;
  const bool sw = max_p > 2 && max_q > 2 &&
                  luma_strong_plain(l0, 2 * (dp0 + dq0), beta, tc) &&
                  luma_strong_plain(l3, 2 * (dp3 + dq3), beta, tc);
  const int m0 = L(s, -4), m1 = L(s, -3), m2 = L(s, -2), m3 = L(s, -1);
  const int m4 = L(s, 0), m5 = L(s, 1), m6 = L(s, 2), m7 = L(s, 3);
  if (sw) {
    if (pm) {
      put(-1, clip3(m3 - 3 * tc, m3 + 3 * tc,
                    (m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3));
      put(-2, clip3(m2 - 2 * tc, m2 + 2 * tc, (m1 + m2 + m3 + m4 + 2) >> 2));
      put(-3, clip3(m1 - tc, m1 + tc,
                    (2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3));
    }
    if (qm) {
      put(0, clip3(m4 - 3 * tc, m4 + 3 * tc,
                   (m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3));
      put(1, clip3(m5 - 2 * tc, m5 + 2 * tc, (m3 + m4 + m5 + m6 + 2) >> 2));
      put(2, clip3(m6 - tc, m6 + tc,
                   (m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3));
    }
    return;
  }
  const int delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4;
  if (!(abs(delta) < tc * 10)) return;
  const int dclip = clip3(-tc, tc, delta);
  const int tc2 = tc >> 1;
  if (pm) {
    put(-1, clip3(0, maxv, m3 + dclip));
    if (filt_p) {
      const int d1 = clip3(-tc2, tc2, (((m1 + m3 + 1) >> 1) - m2 + dclip) >> 1);
      put(-2, clip3(0, maxv, m2 + d1));
    }
  }
  if (qm) {
    put(0, clip3(0, maxv, m4 - dclip));
    if (filt_q) {
      const int d2 = clip3(-tc2, tc2, (((m6 + m4 + 1) >> 1) - m5 - dclip) >> 1);
      put(1, clip3(0, maxv, m5 + d2));
    }
  }
}

__device__ __forceinline__ int chroma_dp(const int* a, bool hcb) {
  return hcb ? abs(C(a, -2) - 2 * C(a, -2) + C(a, -1))
             : abs(C(a, -3) - 2 * C(a, -2) + C(a, -1));
}

__device__ __forceinline__ int chroma_dq(const int* a) {
  return abs(C(a, 0) - 2 * C(a, 1) + C(a, 2));
}

__device__ __forceinline__ bool chroma_strong(const int* a, int d, int beta,
                                              int tc, bool hcb) {
  const int m4 = C(a, 0), m3 = C(a, -1), m7 = C(a, 3);
  const int sp3 = hcb ? abs(C(a, -2) - m3) : abs(C(a, -4) - m3);
  const int sq3 = abs(m7 - m4);
  return (sp3 + sq3) < (beta >> 3) && d < (beta >> 2) &&
         abs(m3 - m4) < ((tc * 5 + 1) >> 1);
}

// Segment (r, c) of the chroma grid covers rows r*loop_len .. +loop_len-1 and
// the edge at column 4c; its maps are at r * mrs + c * mcs (the wrapper folds
// the chroma subsampling of the luma-grid maps into mcs).
__global__ void chroma_ver_kernel(
    const int* __restrict__ in, int* __restrict__ out, int W, long long prs,
    long long pcs, const uint8_t* __restrict__ act,
    const int* __restrict__ tcm, const int* __restrict__ betam,
    const uint8_t* __restrict__ largem, const uint8_t* __restrict__ nopm,
    const uint8_t* __restrict__ noqm, const uint8_t* __restrict__ hctbm,
    long long mrs, long long mcs, int Hs, int Ws, int loop_len, int dec_line,
    int maxv, int row_fast) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y * blockDim.y + threadIdx.y;
  const int seg = row_fast ? b : a;
  const int row = row_fast ? a : b;
  if (seg >= Ws || row >= Hs * loop_len) return;
  const int rs = row / loop_len;
  const long long mo = (long long)rs * mrs + (long long)seg * mcs;
  if (!act[mo]) return;
  const int tc = tcm[mo], beta = betam[mo];
  const bool large = largem[mo], hcb = hctbm[mo];
  const bool pm = !nopm[mo], qm = !noqm[mo];
  const int x0 = seg * 4, r0 = rs * loop_len;

  int l0[8], ld[8], s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const long long c = (long long)clampi(x0 + j - 4, W) * pcs;
    l0[j] = in[(long long)r0 * prs + c];
    ld[j] = in[(long long)(r0 + dec_line) * prs + c];
    s[j] = in[(long long)row * prs + c];
  }
  int* orow = out + (long long)row * prs;
  auto put = [&](int i, int v) {
    const int x = x0 + i;
    if (x >= 0 && x < W) orow[(long long)x * pcs] = v;
  };

  const int d0 = chroma_dp(l0, hcb) + chroma_dq(l0);
  const int d3 = chroma_dp(ld, hcb) + chroma_dq(ld);
  const int d = d0 + d3;
  const bool sw = large && d < beta && chroma_strong(l0, 2 * d0, beta, tc, hcb) &&
                  chroma_strong(ld, 2 * d3, beta, tc, hcb);
  const int m0 = C(s, -4), m1 = C(s, -3), m2 = C(s, -2), m3 = C(s, -1);
  const int m4 = C(s, 0), m5 = C(s, 1), m6 = C(s, 2), m7 = C(s, 3);
  if (sw) {
    if (pm) {
      put(-1, hcb ? clip3(m3 - tc, m3 + tc,
                          (3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3)
                  : clip3(m3 - tc, m3 + tc,
                          (m0 + m1 + m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3));
      if (!hcb) {
        put(-2, clip3(m2 - tc, m2 + tc,
                      (2 * m0 + m1 + 2 * m2 + m3 + m4 + m5 + 4) >> 3));
        put(-3, clip3(m1 - tc, m1 + tc,
                      (3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3));
      }
    }
    if (qm) {
      put(0, hcb ? clip3(m4 - tc, m4 + tc,
                         (2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3)
                 : clip3(m4 - tc, m4 + tc,
                         (m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3));
      put(1, clip3(m5 - tc, m5 + tc,
                   (m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3));
      put(2, clip3(m6 - tc, m6 + tc,
                   (m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3));
    }
    return;
  }
  const int dclip = clip3(-tc, tc, (((m4 - m3) * 4) + m2 - m5 + 4) >> 3);
  if (pm) put(-1, clip3(0, maxv, m3 + dclip));
  if (qm) put(0, clip3(0, maxv, m4 - dclip));
}

static inline dim3 edge_grid(int nseg, int nrow, int row_fast, dim3 block) {
  return row_fast ? grid2d(nrow, nseg, block) : grid2d(nseg, nrow, block);
}

VTM_API int vtm_deblock_luma_ver(
    const int* in, int* out, int H, int W, long long prs, long long pcs,
    const uint8_t* act, const int* tc, const int* beta, const int* max_p,
    const int* max_q, const uint8_t* no_p, const uint8_t* no_q, long long mrs,
    long long mcs, int bit_depth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpyAsync(out, in, (size_t)H * W * sizeof(int),
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  const int nseg = W >> 2, nrow = (H >> 2) << 2;
  if (nseg == 0 || nrow == 0) return 0;
  const int row_fast = pcs != 1;
  const dim3 block(32, 8);
  luma_ver_kernel<<<edge_grid(nseg, nrow, row_fast, block), block, 0, st>>>(
      in, out, H, W, prs, pcs, act, tc, beta, max_p, max_q, no_p, no_q, mrs,
      mcs, (1 << bit_depth) - 1, row_fast);
  return launch_status();
}

VTM_API int vtm_deblock_chroma_ver(
    const int* in, int* out, int H, int W, long long prs, long long pcs,
    const uint8_t* act, const int* tc, const int* beta, const uint8_t* large,
    const uint8_t* no_p, const uint8_t* no_q, const uint8_t* hor_ctb,
    long long mrs, long long mcs, int Hs, int Ws, int loop_len, int dec_line,
    int bit_depth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpyAsync(out, in, (size_t)H * W * sizeof(int),
                                  cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  const int nrow = Hs * loop_len;
  if (Ws == 0 || nrow == 0) return 0;
  const int row_fast = pcs != 1;
  const dim3 block(32, 8);
  chroma_ver_kernel<<<edge_grid(Ws, nrow, row_fast, block), block, 0, st>>>(
      in, out, W, prs, pcs, act, tc, beta, large, no_p, no_q, hor_ctb, mrs,
      mcs, Hs, Ws, loop_len, dec_line, (1 << bit_depth) - 1, row_fast);
  return launch_status();
}
