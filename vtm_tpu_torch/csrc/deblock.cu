// Deblocking of one edge direction: the luma and chroma edge filters.
//
// Replaces vtm_tpu/ops/deblock_kernel.py:deblock_dir, i.e. luma_ver_delta
// (luma) and chroma_ver_core (chroma) over vertical (VER) or horizontal (HOR)
// edges, and luma_ver_delta itself for width shards.  The semantics are the
// jax kernel's: every decision and every filter reads the input plane.  The
// jax version sums per-window deltas; writing each filtered sample once gives
// the same integers, because the max-filter-length rules keep the samples one
// edge writes disjoint from another's.
//
// vtm_deblock_luma_ver and vtm_deblock_chroma_ver own the output by sample: a
// block owns a tile of TA samples across the edges by TL lines along them and
// writes each of its samples exactly once, filtered or copied through, so no
// copy of the plane precedes the kernel and no atomics are needed.  A block
//   1. loads its tile and a halo across the edges into shared memory with
//      coalesced 16-byte loads in the plane's own layout (a HOR tile is
//      TA + 2 HALO rows of TL columns and is filtered across its rows in
//      shared memory), and its own samples into a second, output tile; an
//      edge at x reads x-8..x+7 and writes x-7..x+6 (chroma x-4..x+3,
//      x-3..x+2), so the edges x0-4 .. x0+TA+4 (chroma x0 .. x0+TA) can
//      write into the tile [x0, x0+TA) and the halo is 12 samples a side
//      (chroma 4).  Each thread loads the maps of its segment with the tile;
//   2. takes each segment's decision once (one thread a segment: 4 luma
//      lines, loop_len chroma lines) from its two decision lines, into a
//      packed word in shared memory, and lists the segments that filter by
//      kind; the edges of the halo repeat what the neighbouring tile
//      decides for them;
//   3. filters the lines of the listed segments alone, from shared memory
//      into the output tile, inside the tile only;
//   4. stores the output tile with coalesced 16-byte writes.
// Cb and Cr take one launch (blockIdx.z is the component): they share the
// geometry and the four shared maps, each has its own act / tc / beta.
//
// The delta form (vtm_deblock_luma_ver_delta, the counterpart of
// luma_ver_delta, deblock_kernel.py:68) runs on a plane already extended by
// 8 columns each side (a shard with its neighbours' halo under width
// sharding) and returns the sample deltas over the extended width: one
// thread a (row, segment) repeats the segment's decision and adds each
// filtered sample's (new - old) into a zeroed buffer with an integer atomic,
// so the deltas that fall into the halo are what the neighbouring shard
// receives back.  It shares the decision and filter functions.
//
// Bound on the H100: memory.  A 1080p luma direction must move the plane in
// and out and the seven maps once, 19.05 MB (5.7 us at 3.35 TB/s); both
// chroma planes 11.15 MB.  No arithmetic limit is near.

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

// A packed decision: bits 0-1 the filter, bit 2 the P side on, bit 3 the Q
// side on; luma: bits 4-5 the weak filter's second P / Q sample, bits 8-11
// n_p and 12-15 n_q of the long filter; chroma: bit 4 hor_ctb.
enum { kNone = 0, kWeak = 1, kStrong = 2, kLong = 3 };

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

// The decision of a luma segment from its lines 0 and 3.
__device__ __forceinline__ int luma_decide(const int* l0, const int* l3, int tc,
                                           int beta, int max_p, int max_q,
                                           bool pm, bool qm) {
  const int sides = (pm ? 4 : 0) | (qm ? 8 : 0);
  const bool side_p = max_p > 3, side_q = max_q > 3;
  const int dp0 = luma_dp(l0, 0), dq0 = luma_dq(l0, 0);
  const int dp3 = luma_dp(l3, 0), dq3 = luma_dq(l3, 0);
  const int dp0l = side_p ? (dp0 + luma_dp(l0, -3) + 1) >> 1 : dp0;
  const int dp3l = side_p ? (dp3 + luma_dp(l3, -3) + 1) >> 1 : dp3;
  const int dq0l = side_q ? (dq0 + luma_dq(l0, 3) + 1) >> 1 : dq0;
  const int dq3l = side_q ? (dq3 + luma_dq(l3, 3) + 1) >> 1 : dq3;
  const int dl = (dp0l + dq0l) + (dp3l + dq3l);
  const bool swl =
      luma_strong_large(l0, 2 * (dp0l + dq0l), beta, tc, max_p, max_q, side_p,
                        side_q) &&
      luma_strong_large(l3, 2 * (dp3l + dq3l), beta, tc, max_p, max_q, side_p,
                        side_q);
  if ((side_p || side_q) && dl < beta && swl) {
    // xFilteringPandQ: both sides filtered once swl holds
    const int n_p = side_p ? max_p : 3, n_q = side_q ? max_q : 3;
    return kLong | sides | n_p << 8 | n_q << 12;
  }
  const int d = (dp0 + dq0) + (dp3 + dq3);
  if (!(d < beta)) return kNone;
  if (max_p > 2 && max_q > 2 &&
      luma_strong_plain(l0, 2 * (dp0 + dq0), beta, tc) &&
      luma_strong_plain(l3, 2 * (dp3 + dq3), beta, tc))
    return kStrong | sides;
  const int side_thresh = (beta + (beta >> 1)) >> 3;
  const bool two = max_p > 1 && max_q > 1;
  return kWeak | sides | (two && (dp0 + dp3) < side_thresh ? 16 : 0) |
         (two && (dq0 + dq3) < side_thresh ? 32 : 0);
}

// One line `s` of a segment with decision `dec`: put(i, v) for each
// filtered sample at offset i from the edge.
template <class Put>
__device__ __forceinline__ void luma_filter(const int* s, int dec, int tc,
                                            int maxv, Put put) {
  const bool pm = dec & 4, qm = dec & 8;
  if ((dec & 3) == kLong) {
    const int n_p = (dec >> 8) & 15, n_q = (dec >> 12) & 15;
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
  const int m0 = L(s, -4), m1 = L(s, -3), m2 = L(s, -2), m3 = L(s, -1);
  const int m4 = L(s, 0), m5 = L(s, 1), m6 = L(s, 2), m7 = L(s, 3);
  if ((dec & 3) == kStrong) {
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
    if (dec & 16) {
      const int d1 = clip3(-tc2, tc2, (((m1 + m3 + 1) >> 1) - m2 + dclip) >> 1);
      put(-2, clip3(0, maxv, m2 + d1));
    }
  }
  if (qm) {
    put(0, clip3(0, maxv, m4 - dclip));
    if (dec & 32) {
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

// The decision of an active chroma segment from its lines 0 and dec_line.
__device__ __forceinline__ int chroma_decide(const int* l0, const int* ld,
                                             int tc, int beta, bool large,
                                             bool hcb, bool pm, bool qm) {
  const int d0 = chroma_dp(l0, hcb) + chroma_dq(l0);
  const int d3 = chroma_dp(ld, hcb) + chroma_dq(ld);
  const bool sw = large && d0 + d3 < beta &&
                  chroma_strong(l0, 2 * d0, beta, tc, hcb) &&
                  chroma_strong(ld, 2 * d3, beta, tc, hcb);
  return (sw ? kStrong : kWeak) | (pm ? 4 : 0) | (qm ? 8 : 0) | (hcb ? 16 : 0);
}

template <class Put>
__device__ __forceinline__ void chroma_filter(const int* s, int dec, int tc,
                                              int maxv, Put put) {
  const bool pm = dec & 4, qm = dec & 8, hcb = dec & 16;
  const int m0 = C(s, -4), m1 = C(s, -3), m2 = C(s, -2), m3 = C(s, -1);
  const int m4 = C(s, 0), m5 = C(s, 1), m6 = C(s, 2), m7 = C(s, 3);
  if ((dec & 3) == kStrong) {
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

constexpr int kThreads = 256;
// tile shapes, samples across the edges x lines along them, [VER, HOR]
// (the fastest of those tried on the H100: PERF.md)
constexpr int kLumaTA[2] = {128, 64}, kLumaTL[2] = {16, 32};
constexpr int kChromaTA[2] = {64, 64}, kChromaTL[2] = {32, 32};

// A block's tile: TA samples across the edges by TL lines along them, plus
// HALO samples across on each side, in the picture plane's own layout (rows
// of the picture are rows of the tile): a VER tile is TL rows of TA + 2 HALO
// columns, a HOR tile TA + 2 HALO rows of TL columns, lines being columns.
// The output tile holds the TA x TL samples the block owns.  Pitches are
// multiples of 4, so that a row moves as 16-byte vectors (and a VER window
// is read as such); the input pitches are padded so that neighbouring
// segments' lines fall in distinct banks.
template <bool HOR, int HALO_, int TA_, int TL_>
struct Tile {
  static constexpr int TA = TA_, TL = TL_, HALO = HALO_;
  static constexpr int ROWS = HOR ? TA + 2 * HALO : TL;
  static constexpr int COLS = HOR ? TL : TA + 2 * HALO;
  static constexpr int PITCH = COLS + 4;
  static constexpr int OROWS = HOR ? TA : TL, OCOLS = HOR ? TL : TA;
  static constexpr int OPITCH = HOR ? TL : TA + 4;
  static constexpr int IN = ROWS * PITCH;
  static constexpr int OUT = OROWS * OPITCH;
  static_assert(HALO % 4 == 0 && TA % 4 == 0 && TL % 4 == 0, "16-byte rows");
  // line l in [0, TL), across a in [-HALO, TA + HALO) (output: [0, TA))
  __device__ static int in(int l, int a) {
    return HOR ? (a + HALO) * PITCH + l : l * PITCH + a + HALO;
  }
  __device__ static int out(int l, int a) {
    return HOR ? a * OPITCH + l : l * OPITCH + a;
  }
  // w[0..N) = the samples of line l from across a (a multiple of 4): 16-byte
  // vectors along a VER tile's row
  template <int N>
  __device__ static void window(const int* s_in, int l, int a, int* w) {
    if (HOR) {
#pragma unroll
      for (int j = 0; j < N; ++j) w[j] = s_in[in(l, a + j)];
    } else {
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        const int4 v = *reinterpret_cast<const int4*>(s_in + in(l, a + j));
        w[j] = v.x;
        w[j + 1] = v.y;
        w[j + 2] = v.z;
        w[j + 3] = v.w;
      }
    }
  }
  // segment i of a tile with ng segments along and ne edges across: edges
  // fastest for VER (consecutive threads on consecutive columns of a row),
  // segments along fastest for HOR
  __device__ static void segment(int i, int ng, int ne, int* g, int* e) {
    *g = HOR ? i % ng : i / ne;
    *e = HOR ? i / ng : i % ne;
  }
};

// The tile at (across a0, line l0) of the picture-layout plane [Hp, Wp] and
// its halo into s_in, its own samples into s_out too, 4 samples of a row at
// a time (one 16-byte load where `vec`: Wp a multiple of 4 and the plane
// 16-byte aligned).  Rows and columns are clamped into the plane: across
// the edges that is the jax gather's clamp, along them (lines past the
// plane) the samples are never used.  A thread's loads are all issued
// before its first shared store.
template <class T, bool HOR>
__device__ __forceinline__ void load_tile(const int* __restrict__ in, int Hp,
                                          int Wp, int a0, int l0, bool vec,
                                          int* s_in, int* s_out) {
  constexpr int G = T::COLS / 4, N = T::ROWS * G, K = (N + kThreads - 1) / kThreads;
  const int row0 = HOR ? a0 - T::HALO : l0, col0 = HOR ? l0 : a0 - T::HALO;
  int4 v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (N % kThreads != 0 && i >= N) continue;
    const int r = i / G, col = col0 + 4 * (i % G);
    const int* row = in + (long long)clampi(row0 + r, Hp) * Wp;
    if (vec && col >= 0 && col + 3 < Wp) {
      v[k] = *reinterpret_cast<const int4*>(row + col);
    } else {
      v[k].x = row[clampi(col, Wp)];
      v[k].y = row[clampi(col + 1, Wp)];
      v[k].z = row[clampi(col + 2, Wp)];
      v[k].w = row[clampi(col + 3, Wp)];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (N % kThreads != 0 && i >= N) continue;
    const int r = i / G, c = 4 * (i % G);
    *reinterpret_cast<int4*>(s_in + r * T::PITCH + c) = v[k];
    const int orow = HOR ? r - T::HALO : r, ocol = HOR ? c : c - T::HALO;
    if (HOR ? orow >= 0 && orow < T::TA : ocol >= 0 && ocol < T::TA)
      *reinterpret_cast<int4*>(s_out + orow * T::OPITCH + ocol) = v[k];
  }
}

template <class T, bool HOR>
__device__ __forceinline__ void store_tile(int* __restrict__ out, int Hp, int Wp,
                                           int a0, int l0, bool vec,
                                           const int* s_out) {
  constexpr int G = T::OCOLS / 4, N = T::OROWS * G, K = (N + kThreads - 1) / kThreads;
  const int row0 = HOR ? a0 : l0, col0 = HOR ? l0 : a0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (N % kThreads != 0 && i >= N) continue;
    const int r = i / G, c = 4 * (i % G), row = row0 + r, col = col0 + c;
    if (row >= Hp) continue;
    const int4 v = *reinterpret_cast<const int4*>(s_out + r * T::OPITCH + c);
    int* o = out + (long long)row * Wp + col;
    if (vec && col + 3 < Wp) {
      *reinterpret_cast<int4*>(o) = v;
    } else {
      if (col < Wp) o[0] = v.x;
      if (col + 1 < Wp) o[1] = v.y;
      if (col + 2 < Wp) o[2] = v.z;
      if (col + 3 < Wp) o[3] = v.w;
    }
  }
}

// The segments a tile filters, listed by filter kind (long, strong, weak)
// so that the lines of a warp mostly take one path; the filter phase walks
// the lines of these alone.
template <int ND>
struct Work {
  int cnt[3];
  int idx[3][ND];
  __device__ void reset() {
    if (threadIdx.x < 3) cnt[threadIdx.x] = 0;
  }
  __device__ void add(int dec, int i) {
    const int k = kLong - (dec & 3);
    idx[k][atomicAdd(&cnt[k], 1)] = i;
  }
  __device__ int size() const { return cnt[0] + cnt[1] + cnt[2]; }
  __device__ int at(int j) const {
    if (j < cnt[0]) return idx[0][j];
    j -= cnt[0];
    return j < cnt[1] ? idx[1][j] : idx[2][j - cnt[1]];
  }
};

// Luma edges of the plane [Hp, Wp].  Map element (segment along, edge) of
// the oriented frame is at g * mrs + e * mcs.
template <bool HOR>
__global__ void __launch_bounds__(kThreads) luma_tile_kernel(
    const int* __restrict__ in, int* __restrict__ out, int Hp, int Wp,
    const uint8_t* __restrict__ act, const int* __restrict__ tcm,
    const int* __restrict__ betam, const int* __restrict__ mpm,
    const int* __restrict__ mqm, const uint8_t* __restrict__ nopm,
    const uint8_t* __restrict__ noqm, long long mrs, long long mcs, int maxv) {
  using T = Tile<HOR, 12, kLumaTA[HOR], kLumaTL[HOR]>;
  constexpr int NG = T::TL / 4, NE = T::TA / 4 + 3;  // edges x0-4 .. x0+TA+4
  constexpr int ND = NG * NE, D = (ND + kThreads - 1) / kThreads;
  __shared__ __align__(16) int s_in[T::IN];
  __shared__ __align__(16) int s_out[T::OUT];
  __shared__ int s_dec[ND], s_tc[ND];
  __shared__ Work<ND> s_work;
  s_work.reset();
  const int nseg = (HOR ? Hp : Wp) >> 2, nline = ((HOR ? Wp : Hp) >> 2) << 2;
  const int a0 = (HOR ? blockIdx.y : blockIdx.x) * T::TA;
  const int l0 = (HOR ? blockIdx.x : blockIdx.y) * T::TL;
  // the maps of this thread's segments (g, e), loaded with the tile
  bool on[D];
  int tc[D], beta[D], mp[D], mq[D], side[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int i = threadIdx.x + d * kThreads;
    int g, e;
    T::segment(i, NG, NE, &g, &e);
    const int x = a0 + 4 * (e - 1), line = l0 + 4 * g;
    on[d] = false;
    if (i < ND && x >= 0 && (x >> 2) < nseg && line < nline) {
      const long long mo = (long long)(line >> 2) * mrs + (long long)(x >> 2) * mcs;
      on[d] = act[mo];
      tc[d] = tcm[mo];
      beta[d] = betam[mo];
      mp[d] = mpm[mo];
      mq[d] = mqm[mo];
      side[d] = (nopm[mo] ? 0 : 1) | (noqm[mo] ? 0 : 2);
    }
  }
  const bool vec = (Wp & 3) == 0 && ((size_t)in & 15) == 0 && ((size_t)out & 15) == 0;
  load_tile<T, HOR>(in, Hp, Wp, a0, l0, vec, s_in, s_out);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int i = threadIdx.x + d * kThreads;
    if (i >= ND) continue;
    int g, e;
    T::segment(i, NG, NE, &g, &e);
    int dec = kNone;
    if (on[d]) {
      int w0[16], w3[16];
      T::template window<16>(s_in, 4 * g, 4 * e - 12, w0);
      T::template window<16>(s_in, 4 * g + 3, 4 * e - 12, w3);
      dec = luma_decide(w0, w3, tc[d], beta[d], mp[d], mq[d], side[d] & 1,
                        side[d] & 2);
    }
    if (dec != kNone) {
      s_dec[i] = dec;
      s_tc[i] = tc[d];
      s_work.add(dec, i);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 4 * s_work.size(); k += kThreads) {
    const int di = s_work.at(k >> 2), dec = s_dec[di];
    int g, e;
    T::segment(di, NG, NE, &g, &e);
    const int l = 4 * g + (k & 3), xe = 4 * (e - 1);
    int s[16];  // the outer 8 samples for a long filter only
    T::template window<8>(s_in, l, xe - 4, s + 4);
    if ((dec & 3) == kLong) {
      T::template window<4>(s_in, l, xe - 8, s);
      T::template window<4>(s_in, l, xe + 4, s + 12);
    }
    luma_filter(s, dec, s_tc[di], maxv, [&](int k, int v) {
      const int a = xe + k;
      if (a >= 0 && a < T::TA) s_out[T::out(l, a)] = v;
    });
  }
  __syncthreads();
  store_tile<T, HOR>(out, Hp, Wp, a0, l0, vec, s_out);
}

// One chroma component of a launch.
struct ChromaPlane {
  const int* in;
  int* out;
  const uint8_t* act;
  const int* tc;
  const int* beta;
};

// Chroma edges of the planes [Hp, Wp] (c0, and c1 when gridDim.z is 2).
// Segment (g, e) of the oriented frame covers lines g*loop_len ..
// +loop_len-1 and the edge at 4e; its maps are at g * mrs + e * mcs (the
// wrapper folds the chroma subsampling of the luma-grid maps into mcs).
template <bool HOR>
__global__ void __launch_bounds__(kThreads) chroma_tile_kernel(
    ChromaPlane c0, ChromaPlane c1, int Hp, int Wp,
    const uint8_t* __restrict__ largem, const uint8_t* __restrict__ nopm,
    const uint8_t* __restrict__ noqm, const uint8_t* __restrict__ hctbm,
    long long mrs, long long mcs, int Hs, int Ws, int loop_len, int dec_line,
    int maxv) {
  using T = Tile<HOR, 4, kChromaTA[HOR], kChromaTL[HOR]>;
  constexpr int NE = T::TA / 4 + 1;  // edges x0 .. x0+TA
  // segments of 2 lines at least (loop_len 2 or 4)
  constexpr int NDMAX = T::TL / 2 * NE, D = (NDMAX + kThreads - 1) / kThreads;
  __shared__ __align__(16) int s_in[T::IN];
  __shared__ __align__(16) int s_out[T::OUT];
  __shared__ int s_dec[NDMAX], s_tc[NDMAX];
  __shared__ Work<NDMAX> s_work;
  s_work.reset();
  const ChromaPlane c = blockIdx.z ? c1 : c0;
  const int ng = T::TL / loop_len, nd = ng * NE;
  const int a0 = (HOR ? blockIdx.y : blockIdx.x) * T::TA;
  const int l0 = (HOR ? blockIdx.x : blockIdx.y) * T::TL;
  // the maps of this thread's segments (g, e), loaded with the tile
  bool on[D];
  int tc[D], beta[D], flags[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int i = threadIdx.x + d * kThreads;
    int g, e;
    T::segment(i, ng, NE, &g, &e);
    const int seg = l0 / loop_len + g, col = (a0 >> 2) + e;
    on[d] = false;
    if (i < nd && seg < Hs && col < Ws) {
      const long long mo = (long long)seg * mrs + (long long)col * mcs;
      on[d] = c.act[mo];
      tc[d] = c.tc[mo];
      beta[d] = c.beta[mo];
      flags[d] = (largem[mo] ? 1 : 0) | (hctbm[mo] ? 2 : 0) | (nopm[mo] ? 0 : 4) |
                 (noqm[mo] ? 0 : 8);
    }
  }
  const bool vec = (Wp & 3) == 0 && ((size_t)c.in & 15) == 0 && ((size_t)c.out & 15) == 0;
  load_tile<T, HOR>(c.in, Hp, Wp, a0, l0, vec, s_in, s_out);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int i = threadIdx.x + d * kThreads;
    if (i >= nd) continue;
    int g, e;
    T::segment(i, ng, NE, &g, &e);
    int dec = kNone;
    if (on[d]) {
      int w0[8], wd[8];
      T::template window<8>(s_in, g * loop_len, 4 * e - 4, w0);
      T::template window<8>(s_in, g * loop_len + dec_line, 4 * e - 4, wd);
      const int f = flags[d];
      dec = chroma_decide(w0, wd, tc[d], beta[d], f & 1, f & 2, f & 4, f & 8);
    }
    if (dec != kNone) {
      s_dec[i] = dec;
      s_tc[i] = tc[d];
      s_work.add(dec, i);
    }
  }
  __syncthreads();
  const int sh = loop_len == 4 ? 2 : 1;  // log2(loop_len)
  for (int k = threadIdx.x; k < s_work.size() << sh; k += kThreads) {
    const int di = s_work.at(k >> sh), dec = s_dec[di];
    int g, e;
    T::segment(di, ng, NE, &g, &e);
    const int l = (g << sh) + (k & (loop_len - 1));
    int s[8];
    T::template window<8>(s_in, l, 4 * e - 4, s);
    chroma_filter(s, dec, s_tc[di], maxv, [&](int k, int v) {
      const int a = 4 * e + k;
      if (a >= 0 && a < T::TA) s_out[T::out(l, a)] = v;
    });
  }
  __syncthreads();
  store_tile<T, HOR>(c.out, Hp, Wp, a0, l0, vec, s_out);
}

// Deltas of the vertical luma edges of `pad` [H, Wp] (one thread a row and
// segment; maps [H / 4, (Wp - 16) / 4]).
__global__ void luma_ver_delta_kernel(
    const int* __restrict__ pad, int* __restrict__ delta, int H, int Wp,
    const uint8_t* __restrict__ act, const int* __restrict__ tcm,
    const int* __restrict__ betam, const int* __restrict__ mpm,
    const int* __restrict__ mqm, const uint8_t* __restrict__ nopm,
    const uint8_t* __restrict__ noqm, int maxv) {
  const int seg = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const int nseg = (Wp - 16) >> 2;
  if (seg >= nseg || row >= ((H >> 2) << 2)) return;
  const long long mo = (long long)(row >> 2) * nseg + seg;
  if (!act[mo]) return;
  // the window x0-8 .. x0+7 lies in the extended plane
  const int* r0 = pad + (long long)(row & ~3) * Wp + seg * 4;
  const int* rs = pad + (long long)row * Wp + seg * 4;
  int l0[16], l3[16], s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    l0[j] = r0[j];
    l3[j] = r0[3 * Wp + j];
    s[j] = rs[j];
  }
  const int tc = tcm[mo];
  const int dec = luma_decide(l0, l3, tc, betam[mo], mpm[mo], mqm[mo],
                              !nopm[mo], !noqm[mo]);
  if (dec == kNone) return;
  int* orow = delta + (long long)row * Wp + seg * 4 + 8;
  luma_filter(s, dec, tc, maxv,
              [&](int i, int v) { atomicAdd(orow + i, v - L(s, i)); });
}

static inline dim3 tile_grid(bool hor, int Hp, int Wp, int ta, int tl, int nz) {
  const int across = hor ? Hp : Wp, along = hor ? Wp : Hp;
  const unsigned na = (unsigned)((across + ta - 1) / ta);
  const unsigned nl = (unsigned)((along + tl - 1) / tl);
  return hor ? dim3(nl, na, nz) : dim3(na, nl, nz);
}

// (H, W, prs, pcs): the oriented plane, the plane itself for VER (prs == W,
// pcs == 1) or its transpose for HOR (prs == 1, pcs == H); the plane must be
// contiguous.  Sets (Hp, Wp), the picture-layout shape, and hor.
static inline bool plane_layout(int H, int W, long long prs, long long pcs,
                                int* Hp, int* Wp, bool* hor) {
  *hor = pcs != 1;
  *Hp = *hor ? W : H;
  *Wp = *hor ? H : W;
  return *hor ? prs == 1 && pcs == H : prs == W;
}

VTM_API int vtm_deblock_luma_ver(
    const int* in, int* out, int H, int W, long long prs, long long pcs,
    const uint8_t* act, const int* tc, const int* beta, const int* max_p,
    const int* max_q, const uint8_t* no_p, const uint8_t* no_q, long long mrs,
    long long mcs, int bit_depth, void* stream) {
  int Hp, Wp;
  bool hor;
  if (!plane_layout(H, W, prs, pcs, &Hp, &Wp, &hor)) return (int)cudaErrorInvalidValue;
  if (Hp == 0 || Wp == 0) return 0;
  const dim3 grid = tile_grid(hor, Hp, Wp, kLumaTA[hor], kLumaTL[hor], 1);
  cudaStream_t st = (cudaStream_t)stream;
  const int maxv = (1 << bit_depth) - 1;
  if (hor)
    luma_tile_kernel<true><<<grid, kThreads, 0, st>>>(
        in, out, Hp, Wp, act, tc, beta, max_p, max_q, no_p, no_q, mrs, mcs, maxv);
  else
    luma_tile_kernel<false><<<grid, kThreads, 0, st>>>(
        in, out, Hp, Wp, act, tc, beta, max_p, max_q, no_p, no_q, mrs, mcs, maxv);
  return launch_status();
}

// Deltas of the vertical luma edges of a contiguous plane `pad` extended by
// 8 columns each side (Wp = W + 16 columns; maps [H / 4, W / 4]).
VTM_API int vtm_deblock_luma_ver_delta(
    const int* pad, int* delta, int H, int Wp, const uint8_t* act,
    const int* tc, const int* beta, const int* max_p, const int* max_q,
    const uint8_t* no_p, const uint8_t* no_q, int bit_depth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(delta, 0, (size_t)H * Wp * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const int nseg = (Wp - 16) >> 2, nrow = (H >> 2) << 2;
  if (nseg <= 0 || nrow == 0) return 0;
  const dim3 block(32, 8);
  luma_ver_delta_kernel<<<grid2d(nseg, nrow, block), block, 0, st>>>(
      pad, delta, H, Wp, act, tc, beta, max_p, max_q, no_p, no_q,
      (1 << bit_depth) - 1);
  return launch_status();
}

// Cb (in0 -> out0) and, unless in1 is null, Cr (in1 -> out1) in one launch:
// planes of one shape and layout, (H, W, prs, pcs) as for luma; each with
// its act / tc / beta maps, the four shared maps common to both.
VTM_API int vtm_deblock_chroma_ver(
    const int* in0, int* out0, const int* in1, int* out1, int H, int W,
    long long prs, long long pcs, const uint8_t* act0, const int* tc0,
    const int* beta0, const uint8_t* act1, const int* tc1, const int* beta1,
    const uint8_t* large, const uint8_t* no_p, const uint8_t* no_q,
    const uint8_t* hor_ctb, long long mrs, long long mcs, int Hs, int Ws,
    int loop_len, int dec_line, int bit_depth, void* stream) {
  int Hp, Wp;
  bool hor;
  if (!plane_layout(H, W, prs, pcs, &Hp, &Wp, &hor) ||
      (loop_len != 2 && loop_len != 4) || dec_line < 0 || dec_line >= loop_len)
    return (int)cudaErrorInvalidValue;
  if (Hp == 0 || Wp == 0) return 0;
  const ChromaPlane c0{in0, out0, act0, tc0, beta0};
  const ChromaPlane c1 = in1 ? ChromaPlane{in1, out1, act1, tc1, beta1} : c0;
  const dim3 grid = tile_grid(hor, Hp, Wp, kChromaTA[hor], kChromaTL[hor], in1 ? 2 : 1);
  cudaStream_t st = (cudaStream_t)stream;
  const int maxv = (1 << bit_depth) - 1;
  if (hor)
    chroma_tile_kernel<true><<<grid, kThreads, 0, st>>>(
        c0, c1, Hp, Wp, large, no_p, no_q, hor_ctb, mrs, mcs, Hs, Ws, loop_len,
        dec_line, maxv);
  else
    chroma_tile_kernel<false><<<grid, kThreads, 0, st>>>(
        c0, c1, Hp, Wp, large, no_p, no_q, hor_ctb, mrs, mcs, Hs, Ws, loop_len,
        dec_line, maxv);
  return launch_status();
}

// The launch shape of the four tile kernels (luma VER, luma HOR, chroma VER,
// chroma HOR) on the current card, five ints each: threads, static shared
// bytes and registers (cudaFuncGetAttributes), resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), local (spill) bytes a
// thread.  Not a kernel: nothing is launched.
template <class F>
static int tile_config(F* fn, int* o) {
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, (const void*)fn);
  if (e) return e;
  int blocks = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (e) return e;
  o[0] = kThreads;
  o[1] = (int)a.sharedSizeBytes;
  o[2] = a.numRegs;
  o[3] = blocks;
  o[4] = (int)a.localSizeBytes;
  return 0;
}

VTM_API int vtm_deblock_config(int* o) {
  int e = tile_config(luma_tile_kernel<false>, o);
  if (!e) e = tile_config(luma_tile_kernel<true>, o + 5);
  if (!e) e = tile_config(chroma_tile_kernel<false>, o + 10);
  if (!e) e = tile_config(chroma_tile_kernel<true>, o + 15);
  return e;
}
