// DMVR bilateral search, private-buffer FIR and BDOF blend.
//
// Replaces, in vtm_tpu/ops/refine_kernel.py:
//   * dmvr_search (with _bilinear_batch and _div_for_maxq7) -> vtm_dmvr_search:
//     one instantiation per sub-PU size (dx, dy in {8, 16}), so every loop
//     has a constant trip count.  A team of 96 threads (64 when dx = 8, two
//     teams a block) takes one sub-PU.  All global loads are issued in one
//     wave at the start: both lists' prefetch windows (one contiguous span
//     a list for the block's sub-PUs, whole 16-byte quads), the four phases
//     and the 32-int bilinear table; no load depends on another load's
//     value.  Both 2-tap search grids ((dy+4) x (dx+4)) are built in one
//     pass from shared memory, a thread half a column (each window row's
//     horizontal pass once; every phase case computed, one selected).
//     Then the team's first warp alone: lane (dmy, q) loads whole g0 and
//     g1 rows with 16-byte loads and takes the five SADs of dmx = -2..2 of
//     its even rows in registers; the four lanes of a dmy combine by
//     shuffles; lane k < 25 takes offset k's cost (the centre biased by
//     3/4) and its sub-pel deltas (branch-free); two warp reductions give
//     the first minimum (the least cost, then the least lane that has it),
//     the centre wins any tie with it, and one lane applies early
//     termination and the winner's deltas.  No barrier after the grids.
//     (One lane an (offset, even row) pair, 32 shared loads each, and the
//     costs through shared memory to a last phase, ran slower at the
//     decoder's calls: at three blocks an SM the issue work and the
//     dependent steps a sub-PU set the time.)
//   * fir_blocks and dmvr_final_pack -> vtm_fir_blocks: the two-pass FIR
//     of the jax form over each job's own buffer (rows and columns of the
//     window clamped into it), first pass (sum + off1) >> s1, sums wrapping
//     in uint32_t, 14-bit result acc >> 6.  One launch takes up to six
//     groups of jobs by value (a __grid_constant__ struct; taps 8 or 4 a
//     group, one instantiation each), so dmvr_final_pack's two luma and
//     four chroma groups are one launch.  A thread block takes a run of
//     consecutive jobs of one group, whose buffers lie back to back: it
//     loads that span into shared memory once (16-byte loads between the
//     ragged ends), the jobs' fields and coefficients once a job; a thread
//     takes one column of one job, its first pass down the window's rows
//     from shared memory (the clamped columns computed once) into a ring of
//     `taps` registers, the second pass from the ring, each output stored
//     where it belongs: a warp's store covers whole rows of its jobs (64
//     bytes a luma row, 32 a chroma row), full 32-byte sectors.  (Staging
//     the outputs in shared memory for 16-byte stores ran slower: more
//     shared memory a block, fewer blocks, a store phase after the
//     passes.)  No division in the per-sample path; 32-bit offsets.
//   * bdof_blend_batch -> vtm_bdof_blend: one instantiation per sub-block
//     size (w, h in {8, 16}); a 64-thread block takes 64 / (h w / 4)
//     sub-blocks (one at 16x16, four at 8x8), a thread a run of four
//     samples (a row of one 4x4).  Both extended predictions arrive in one
//     wave of whole 16-byte quads.  A thread takes its run's gradients and
//     five window operands (|gx|, |gy|, sgn(gx) di, sgn(gy) di,
//     sgn(gy) gx) in registers, and the run's 6-wide row sums with their
//     two ends from the neighbouring runs' lanes by shuffles (at the
//     sub-block's edges the ring's clamp: its own first or last sample);
//     it keeps the gradient differences and prediction sums for the blend.
//     After one barrier each thread takes the 6-tall column sums of its
//     4x4 and the flow (vx, vy) (the four runs of a 4x4 each take it, so
//     no barrier stands between the flow and the blend), then blends its
//     run.  (One thread a sample, with the row sums by shuffles or through
//     shared memory and one thread a 4x4 for the flow, ran slower at the
//     decoder's calls: at three blocks an SM the issue work a sub-block
//     sets the time.)
//
// int32 semantics: jax wraps and shifts negatives arithmetically; every
// left shift of a possibly negative value and every sum that could
// overflow is done in uint32_t and cast back.  Exactness of the split sums:
// every SAD and every window sum that the jax form wraps is taken in
// uint32_t, where addition is addition mod 2^32 and so associative and
// commutative; a sum split over lanes and combined in any order (the
// search: two rows a lane, then a shuffle tree; the blend: a run's four
// samples plus its two ends from the neighbouring lanes, then the column
// sums) equals the jax form's sum; a term taken twice (a clamped end) is
// added twice.  The shifts of negative values (div_for_maxq7, axis_delta,
// the flow's `>> floor_log2`) keep the forms of the jax kernel.
//
// Bound on the H100: bytes.  At the decoder's calls of tens to hundreds of
// sub-PUs (at most three blocks an SM) the launch floor, one load round
// trip and the chain of dependent steps after it, slowed by each SM's
// issue work for its blocks, set the time; the designs above keep both
// short.  The search reads a (dy+7) x (dx+7) window per list and writes 12
// bytes per sub-PU; the FIR reads each buffer sample once and writes each
// output once; the blend reads two (h+2) x (w+2) blocks and writes h x w
// samples.

#include "fir.cuh"

constexpr int DMVR_OFFSETS = 25;
constexpr int DMVR_CENTRE = 12;
constexpr unsigned FULL_MASK = 0xffffffffu;

// A span of `count` ints staged into shared memory as whole 16-byte quads
// by a block of NT threads, in two steps so that several spans' loads are
// in flight together: load() issues every global load into registers,
// store() writes dst[lead + i] = src[i] (lead: src's word offset in its
// quad; dst 16-byte aligned, 4 MAXQ words).  The first and the last quad
// may hold up to three words outside the span, each in the same 16 bytes
// as a word of it (so in the same page); they are never used.
template <int MAXQ, int NT>
struct QuadStage {
  static constexpr int K = (MAXQ + NT - 1) / NT;
  int4 q[K];
  int lead, nq;

  __device__ __forceinline__ void load(const int* __restrict__ src, int count) {
    lead = (int)(((uintptr_t)src >> 2) & 3);
    nq = count > 0 ? (lead + count + 3) >> 2 : 0;
    const int4* s4 = reinterpret_cast<const int4*>(src - lead);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((int)threadIdx.x + k * NT < nq) q[k] = s4[threadIdx.x + k * NT];
  }

  __device__ __forceinline__ void store(int* __restrict__ dst) const {
    int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((int)threadIdx.x + k * NT < nq) d4[threadIdx.x + k * NT] = q[k];
  }
};

// quads that hold a span of `words` ints at any word offset
constexpr int span_quads(int words) { return (words + 3 + 3) / 4; }

__device__ __forceinline__ int div_for_maxq7(int num, int den) {
  // xDivForMaxq7 exactly as the jax form computes it for any den
  const bool sign = num < 0;
  int n = sign ? (int)(0u - (uint32_t)num) : num;
  int d = (int)((uint32_t)den << 3);
  bool ge = n >= d;
  if (ge) n = (int)((uint32_t)n - (uint32_t)d);
  int q = (int)ge << 1;
  d >>= 1;
  ge = n >= d;
  if (ge) n = (int)((uint32_t)n - (uint32_t)d);
  q = (q + (int)ge) << 1;
  q += (int)(n >= (d >> 1));
  return sign ? -q : q;
}

__device__ __forceinline__ int axis_delta(int sa, int sb, int sc) {
  // the jax form's three cases, each computed and one selected (no branch)
  const int num = (int)((uint32_t)(sa - sb) << 4);
  const int den = sa + sb - (int)((uint32_t)sc << 1);
  const int q = div_for_maxq7(num, den);
  const int d = (sa != sc && sb != sc) ? q : (sa == sc ? -8 : 8);
  return den == 0 ? 0 : d;
}

template <int DX, int DY>
struct DmvrShape {
  static constexpr int PW = DX + 7, PH = DY + 7, WIN = PW * PH;  // a prefetch window
  static constexpr int GW = DX + 4, GH = DY + 4;                 // a search grid
  static constexpr int GS = (GW + 3) & ~3;  // a grid row's stride: rows 16-byte aligned
  static constexpr int ROWS = DY / 2;                            // the SAD's even rows
  // grid threads: (list, column, half of the rows)
  static constexpr int GRUN = GH / 2, GRID_THREADS = 4 * GW;
  static constexpr int TEAM = (GRID_THREADS + 31) / 32 * 32;    // threads a sub-PU
  static constexpr int PER = DX == 8 ? 2 : 1;                    // sub-PUs a block
  static constexpr int THREADS = PER * TEAM;                     // 96 or 128
  static constexpr int MAXQ = span_quads(PER * WIN);             // a list's staged quads
};

__device__ __forceinline__ int tap2(int ca, int cb, int va, int vb, uint32_t o) {
  return (int)((uint32_t)ca * (uint32_t)va + (uint32_t)cb * (uint32_t)vb + o);
}

// A team of S::TEAM threads a sub-PU, S::PER sub-PUs a block.
template <int DX, int DY>
__global__ void __launch_bounds__(DmvrShape<DX, DY>::THREADS)
    dmvr_search_kernel(const int* __restrict__ pre0, const int* __restrict__ pre1,
                       const int* __restrict__ f0x, const int* __restrict__ f0y,
                       const int* __restrict__ f1x, const int* __restrict__ f1y,
                       const int* __restrict__ bil, int n, int bd, int* __restrict__ out) {
  using S = DmvrShape<DX, DY>;
  __shared__ __align__(16) int s_win[2][4 * S::MAXQ];
  __shared__ __align__(16) int s_grid[S::PER][2][S::GH * S::GS];
  __shared__ int s_bil[32];
  const int t = threadIdx.x;
  const int team = t / S::TEAM, tl = t - team * S::TEAM;
  const int sp0 = blockIdx.x * S::PER;
  const int nsp = min(S::PER, n - sp0);
  const int sp = sp0 + team;
  const bool active = team < nsp;

  // 1. every global load in one wave: both lists' windows of the block's
  // sub-PUs, the phases, the bilinear table
  QuadStage<S::MAXQ, S::THREADS> w0, w1;
  w0.load(pre0 + (size_t)sp0 * S::WIN, nsp * S::WIN);
  w1.load(pre1 + (size_t)sp0 * S::WIN, nsp * S::WIN);
  int fx0 = 0, fy0 = 0, fx1 = 0, fy1 = 0, bv = 0;
  if (active) {
    fx0 = f0x[sp];
    fy0 = f0y[sp];
    fx1 = f1x[sp];
    fy1 = f1y[sp];
  }
  if (t < 32) bv = bil[t];
  w0.store(s_win[0]);
  w1.store(s_win[1]);
  if (t < 32) s_bil[t] = bv;
  __syncthreads();

  // 2. both 2-tap grids: thread (list l, column j, half of the rows from
  // i0) takes the horizontal pass of window rows 1 + i0 .. 1 + i0 + GRUN
  // once each and the vertical pass between neighbours; every phase case
  // of the jax form is computed and one selected (no branch per sample)
  if (active && tl < S::GRID_THREADS) {
    const bool l = tl >= 2 * S::GW;
    const int g = l ? tl - 2 * S::GW : tl;
    const int i0 = g >= S::GW ? S::GRUN : 0, j = g >= S::GW ? g - S::GW : g;
    const int fx = l ? fx1 : fx0, fy = l ? fy1 : fy0;
    const int cx0 = s_bil[clampi(fx, 16) * 2], cx1 = s_bil[clampi(fx, 16) * 2 + 1];
    const int cy0 = s_bil[clampi(fy, 16) * 2], cy1 = s_bil[clampi(fy, 16) * 2 + 1];
    const int s = 4 - (10 - bd);
    const uint32_t off = 1u << (s - 1);
    const int* w = s_win[l] + (l ? w1.lead : w0.lead) + team * S::WIN + (1 + i0) * S::PW + 1 + j;
    int* o = s_grid[team][l] + i0 * S::GS + j;
    int ra[S::GRUN + 1], rb[S::GRUN + 1];
#pragma unroll
    for (int u = 0; u <= S::GRUN; ++u) {
      ra[u] = w[u * S::PW];
      rb[u] = w[u * S::PW + 1];
    }
    int hp = tap2(cx0, cx1, ra[0], rb[0], off) >> s;
#pragma unroll
    for (int u = 0; u < S::GRUN; ++u) {
      const int h = tap2(cx0, cx1, ra[u + 1], rb[u + 1], off) >> s;
      const int hv = tap2(cy0, cy1, hp, h, 8) >> 4;                // both phases
      const int vy = tap2(cy0, cy1, ra[u], ra[u + 1], off) >> s;  // vertical only
      const int z = (int)((uint32_t)ra[u] << (10 - bd));         // integer position
      o[u * S::GS] = fx == 0 ? (fy == 0 ? z : vy) : (fy == 0 ? hp : hv);
      hp = h;
    }
  }
  __syncthreads();

  // 3. the team's first warp alone: lane (dmy, q), 20 lanes, takes the
  // even rows r = q + 4 p of dmy, whole rows: g0 row 2 + dmy + 2 r and g1
  // row 2 - dmy + 2 r in registers (16-byte loads) and the five SADs of
  // dmx = -2..2; the four lanes of a dmy combine by shuffles
  if (!active || tl >= 32) return;
  constexpr int RQ = S::ROWS / 4, NQ = (DX + 4) / 4;
  const int dmy = tl / 4 - 2, q = tl % 4;
  uint32_t sad[5] = {0, 0, 0, 0, 0};
  if (tl < 20) {
#pragma unroll
    for (int p = 0; p < RQ; ++p) {
      const int r = q + 4 * p;
      const int4* pa = reinterpret_cast<const int4*>(s_grid[team][0] + (2 + dmy + 2 * r) * S::GS);
      const int4* pb = reinterpret_cast<const int4*>(s_grid[team][1] + (2 - dmy + 2 * r) * S::GS);
      int a[4 * NQ], b[4 * NQ];
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        const int4 va = pa[k], vb = pb[k];
        a[4 * k] = va.x, a[4 * k + 1] = va.y, a[4 * k + 2] = va.z, a[4 * k + 3] = va.w;
        b[4 * k] = vb.x, b[4 * k + 1] = vb.y, b[4 * k + 2] = vb.z, b[4 * k + 3] = vb.w;
      }
#pragma unroll
      for (int k = 0; k < 5; ++k)
#pragma unroll
        for (int c = 0; c < DX; ++c)
          sad[k] += (uint32_t)abs((int)((uint32_t)a[k + c] - (uint32_t)b[4 - k + c]));
    }
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1)
#pragma unroll
    for (int k = 0; k < 5; ++k) sad[k] += (uint32_t)__shfl_xor_sync(FULL_MASK, (int)sad[k], m);

  // 4. lane k < 25: offset k's cost (from lane 4 (k / 5), its SAD k % 5;
  // the centre biased by 3/4) and its sub-pel deltas as if it won; the
  // first minimum by two warp reductions (the least cost, then the least
  // lane that has it); the centre wins any tie with it; the winner's
  // deltas by one shuffle each; one lane writes
  int c = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int v = __shfl_sync(FULL_MASK, (int)sad[k], 4 * (tl / 5));
    if (tl % 5 == k) c = v;
  }
  const int c00 = __shfl_sync(FULL_MASK, c, DMVR_CENTRE);
  const int minc0 = c00 - (c00 >> 2);
  auto cost_at = [&](int k) {
    k = clampi(k, DMVR_OFFSETS);
    const int v = __shfl_sync(FULL_MASK, c, k);
    return k == DMVR_CENTRE ? minc0 : v;
  };
  const int cost = tl < DMVR_OFFSETS ? (tl == DMVR_CENTRE ? minc0 : c) : INT_MAX;
  const int ddx = axis_delta(cost_at(tl - 1), cost_at(tl + 1), cost);
  const int ddy = axis_delta(cost_at(tl - 5), cost_at(tl + 5), cost);
  int min_cost = __reduce_min_sync(FULL_MASK, cost);
  int best = __reduce_min_sync(FULL_MASK, cost == min_cost ? tl : INT_MAX);
  if (minc0 == min_cost) best = DMVR_CENTRE;
  const int bdx = __shfl_sync(FULL_MASK, ddx, best);
  const int bdy = __shfl_sync(FULL_MASK, ddy, best);
  if (tl == 0) {
    const bool early = minc0 < DX * DY;
    int bx = best % 5 - 2, by = best / 5 - 2;
    if (early) {
      bx = by = 0;
      min_cost = minc0;
    }
    int total_x = bx * 16, total_y = by * 16;
    if (!early && abs(bx) != 2 && abs(by) != 2) {
      total_x += bdx;
      total_y += bdy;
    }
    out[sp] = total_x;
    out[n + sp] = total_y;
    out[2 * n + sp] = min_cost;
  }
}

// ---------------------------------------------------------------------------
// vtm_fir_blocks: groups of jobs, each job a block of h x w samples filtered
// from its own H x W buffer (the jobs of a group lie back to back).

constexpr int FIR_MAX_GROUPS = 6;  // dmvr_final_pack: 2 luma + 4 chroma
constexpr int FIR_THREADS = 256;
constexpr int FIR_MAX_SMEM = 227 * 1024;  // dynamic shared bytes a block can have

struct FirGroup {
  const int* bufs;  // [n, H, W]
  const int* x0;    // [n]: the block's origin in its buffer
  const int* y0;
  const int* cfh;   // [n, taps]
  const int* cfv;
  int n, H, W, w, h, taps;
  int out_off;      // the group's first output sample
  int jobs;         // jobs a thread block
  int block0;       // the group's first thread block
};

struct FirJobs {
  FirGroup g[FIR_MAX_GROUPS];
  int ngroups;
};

__host__ __device__ inline int fir_round4(int v) { return (v + 3) & ~3; }

// Shared words of a block of J jobs: the jobs' fields and coefficients, and
// the span of their buffers (with room for a lead of up to 3 words, so that
// 16-byte aligned quads of device memory land on 16-byte aligned quads of
// shared memory).
__host__ __device__ inline int fir_field_words(int J, int taps) {
  return fir_round4(2 * J * (1 + taps));
}
__host__ __device__ inline int fir_span_words(int J, int HW) { return fir_round4(J * HW + 3); }

// dst[lead + i] = src[i] for i < count (lead: src's word offset in its 16
// bytes; dst 16-byte aligned): 16-byte loads and stores for the aligned
// quads, single samples at the ragged ends.
__device__ __forceinline__ int fir_stage(const int* __restrict__ src, int count,
                                         int* __restrict__ dst) {
  const int t = threadIdx.x;
  const int lead = (int)(((uintptr_t)src >> 2) & 3);
  const int head = min(count, (4 - lead) & 3);
  const int nq = (count - head) >> 2;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + lead + head);
  for (int q = t; q < nq; q += FIR_THREADS) d4[q] = s4[q];
  const int rest = head + 4 * nq;
  if (t < head) dst[lead + t] = src[t];
  if (t < count - rest) dst[lead + rest + t] = src[rest + t];
  return lead;
}

// Thread block `b` of group G: jobs b J ... b J + J - 1.
template <int TAPS>
__device__ __forceinline__ void fir_group(const FirGroup& G, int b, int bd,
                                          int* __restrict__ out, int* smem) {
  const int J = G.jobs, H = G.H, W = G.W, w = G.w, h = G.h;
  const int HW = H * W, hw = h * w;
  const int j0 = b * J;
  const int nj = min(J, G.n - j0);
  int* s_x0 = smem;
  int* s_y0 = s_x0 + J;
  int* s_ch = s_y0 + J;
  int* s_cv = s_ch + J * TAPS;
  int* s_span = smem + fir_field_words(J, TAPS);
  const int t = threadIdx.x;

  // 1. the jobs' fields and coefficients, and their buffers' span, each
  // read once
  for (int i = t; i < nj; i += FIR_THREADS) {
    s_x0[i] = G.x0[j0 + i];
    s_y0[i] = G.y0[j0 + i];
  }
  for (int i = t; i < nj * TAPS; i += FIR_THREADS) {
    s_ch[i] = G.cfh[j0 * TAPS + i];
    s_cv[i] = G.cfv[j0 * TAPS + i];
  }
  const int lead = fir_stage(G.bufs + j0 * HW, nj * HW, s_span);
  __syncthreads();

  // 2. thread (job jj, column c): the first pass down the window's rows at
  // column c (columns clamped once), each row's sum into a ring of TAPS
  // registers, and from the ring the second pass of every output row of
  // the column; slot k of the ring holds the rows r = k mod TAPS, so that
  // the ring is indexed by constants
  const int jj = t / w, c = t - jj * w;
  if (jj < nj) {
    const int half = TAPS / 2 - 1;
    const int* span = s_span + lead + jj * HW;
    const int ox = s_x0[jj] - half + c, oy = s_y0[jj] - half;
    int cx[TAPS], ch[TAPS], cv[TAPS];
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      cx[k] = clampi(ox + k, W);
      ch[k] = s_ch[jj * TAPS + k];
      cv[k] = s_cv[jj * TAPS + k];
    }
    const int hr = max(2, IF_INTERNAL_PREC - bd);
    const int s1 = 6 - hr;
    const uint32_t off1 = (uint32_t)(-(IF_OFFS << s1));
    int* o = out + G.out_off + (j0 + jj) * hw + c;
    const int rows = h + TAPS - 1;
    int ring[TAPS];
    for (int r0 = 0; r0 < rows; r0 += TAPS) {
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const int r = r0 + k;
        if (r < rows) {
          const int* row = span + clampi(oy + r, H) * W;
          uint32_t acc = 0;
#pragma unroll
          for (int m = 0; m < TAPS; ++m) acc += (uint32_t)ch[m] * (uint32_t)row[cx[m]];
          ring[k] = (int)(acc + off1) >> s1;
          if (r >= TAPS - 1) {
            uint32_t v = 0;
#pragma unroll
            for (int m = 0; m < TAPS; ++m)
              v += (uint32_t)cv[m] * (uint32_t)ring[(k + 1 + m) % TAPS];
            o[(r - (TAPS - 1)) * w] = (int)v >> 6;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(FIR_THREADS)
    fir_blocks_kernel(const __grid_constant__ FirJobs jobs, int bd, int* __restrict__ out) {
  extern __shared__ int sm[];
  int gi = 0;
  while (gi + 1 < jobs.ngroups && (int)blockIdx.x >= jobs.g[gi + 1].block0) ++gi;
  const FirGroup& G = jobs.g[gi];
  if (G.taps == 8) {
    fir_group<8>(G, (int)blockIdx.x - G.block0, bd, out, sm);
  } else {
    fir_group<4>(G, (int)blockIdx.x - G.block0, bd, out, sm);
  }
}

__device__ __forceinline__ int floor_log2_sat19(int x) {
  // the jax form counts x >= 2^i for i in 1..19, so it saturates at 19
  // (x >= 1 here: floor(log2 x), at most 19)
  return min(31 - __clz(x), 19);
}

constexpr int BDOF_THREADS = 64;  // threads a block of the blend

template <int W, int H>
struct BdofShape {
  static constexpr int EW = W + 2, EXT = (H + 2) * EW;     // an extended block
  static constexpr int HW = H * W;
  static constexpr int NBX = W / 4;                        // 4x4 columns a sub-block
  static constexpr int RUNS = H * NBX;                      // threads a sub-block
  static constexpr int PER = BDOF_THREADS / RUNS;          // sub-blocks a block
  static constexpr int MAXQ = span_quads(PER * EXT);       // a list's staged quads
};

// A thread a run of four samples (a row of one 4x4), S::PER sub-blocks a
// block.
template <int W, int H>
__global__ void __launch_bounds__(BDOF_THREADS)
    bdof_blend_kernel(const int* __restrict__ p0e, const int* __restrict__ p1e, int n,
                      int bd, int* __restrict__ out) {
  using S = BdofShape<W, H>;
  __shared__ __align__(16) int s_ext[2][4 * S::MAXQ];
  // the five window operands' 6-wide row sums: [operand][sub-block row][4x4 column]
  __shared__ int s_row[5][S::PER * H][S::NBX];
  const int t = threadIdx.x;
  const int sbl = t / S::RUNS, ri = t - sbl * S::RUNS;
  const int i = ri / S::NBX, bx = ri - i * S::NBX;  // row i, samples 4 bx .. 4 bx + 3
  const int sb0 = blockIdx.x * S::PER;
  const int nsb = min(S::PER, n - sb0);
  const bool active = sbl < nsb;

  // 1. both extended predictions in one wave
  QuadStage<S::MAXQ, BDOF_THREADS> a, b;
  a.load(p0e + (size_t)sb0 * S::EXT, nsb * S::EXT);
  b.load(p1e + (size_t)sb0 * S::EXT, nsb * S::EXT);
  a.store(s_ext[0]);
  b.store(s_ext[1]);
  __syncthreads();

  // 2. the run's four samples: their gradients and window operands in
  // registers (every thread, so that all lanes take part in the shuffles;
  // a thread past the last sub-block reads words that were not loaded and
  // stores nothing),
  // the gradient differences and prediction sums kept for the blend; the
  // row's 6-wide sums of the five operands to shared memory, their ends
  // (inner columns 4 bx - 1 and 4 bx + 4) the neighbouring runs' last and
  // first samples by shuffles, or at the sub-block's edges (the ring's
  // clamp) this run's first and last
  int gdx[4], gdy[4], psum[4];
  uint32_t own[5] = {0, 0, 0, 0, 0}, first[5], last[5];
  {
    // extended row i + 1 at columns 4 bx .. 4 bx + 5, rows i and i + 2 at
    // columns 4 bx + 1 .. 4 bx + 4
    int mid[2][6], up[2][4], dn[2][4];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const int* e = s_ext[l] + (l ? b.lead : a.lead) + sbl * S::EXT + i * S::EW + 4 * bx;
#pragma unroll
      for (int m = 0; m < 6; ++m) mid[l][m] = e[S::EW + m];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        up[l][m] = e[1 + m];
        dn[l][m] = e[2 * S::EW + 1 + m];
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int gx0 = (mid[0][m + 2] >> 6) - (mid[0][m] >> 6);
      const int gy0 = (dn[0][m] >> 6) - (up[0][m] >> 6);
      const int gx1 = (mid[1][m + 2] >> 6) - (mid[1][m] >> 6);
      const int gy1 = (dn[1][m] >> 6) - (up[1][m] >> 6);
      const int tgx = (gx0 + gx1) >> 1, tgy = (gy0 + gy1) >> 1;
      const int tdi = (mid[1][m + 1] >> 4) - (mid[0][m + 1] >> 4);
      const int op[5] = {abs(tgx), abs(tgy), sgn(tgx) * tdi, sgn(tgy) * tdi, sgn(tgy) * tgx};
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        own[k] += (uint32_t)op[k];
        if (m == 0) first[k] = (uint32_t)op[k];
        if (m == 3) last[k] = (uint32_t)op[k];
      }
      gdx[m] = gx0 - gx1;
      gdy[m] = gy0 - gy1;
      psum[m] = (int)((uint32_t)mid[0][m + 1] + (uint32_t)mid[1][m + 1]);
    }
  }
  const int lane = t & 31;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint32_t lft = (uint32_t)__shfl_sync(FULL_MASK, (int)last[k], max(lane - 1, 0));
    const uint32_t rgt = (uint32_t)__shfl_sync(FULL_MASK, (int)first[k], min(lane + 1, 31));
    const uint32_t rs = own[k] + (bx > 0 ? lft : first[k]) + (bx < S::NBX - 1 ? rgt : last[k]);
    if (active) s_row[k][sbl * H + i][bx] = (int)rs;
  }
  __syncthreads();

  // 3. the flow (vx, vy) of the run's 4x4, taken by each of its four runs
  // (so no barrier before the blend): 6-tall column sums of the row sums
  // (rows -1 and H are rows 0 and H - 1), then the jax form's flow
  if (!active) return;
  uint32_t sum[5] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int u = 0; u < 6; ++u) {
    const int ii = sbl * H + clampi(4 * (i >> 2) + u - 1, H);
#pragma unroll
    for (int k = 0; k < 5; ++k) sum[k] += (uint32_t)s_row[k][ii][bx];
  }
  const int limit = 15;
  const int sum_abs_gx = (int)sum[0], sum_abs_gy = (int)sum[1];
  const uint32_t dix = sum[2], diy = sum[3];
  const int sum_sign = (int)sum[4];
  int tmpx = 0;
  if (sum_abs_gx != 0)
    tmpx = clip3(-limit, limit, (int)(dix << 2) >> floor_log2_sat19(max(sum_abs_gx, 1)));
  const int mains = sum_sign >> 12, secs = sum_sign & 4095;
  const uint32_t td = (((uint32_t)tmpx * (uint32_t)mains) << 12) +
                      (uint32_t)tmpx * (uint32_t)secs;
  const int tmp_data = (int)td >> 1;
  int tmpy = 0;
  if (sum_abs_gy != 0)
    tmpy = clip3(-limit, limit,
                 (int)((diy << 2) - (uint32_t)tmp_data) >> floor_log2_sat19(max(sum_abs_gy, 1)));
  const uint32_t vx = (uint32_t)tmpx, vy = (uint32_t)tmpy;

  // 4. the blend of the run's four samples
  const int shift_num = IF_INTERNAL_PREC + 1 - bd;
  const uint32_t offset = (1u << (shift_num - 1)) + 2u * IF_OFFS;
  const int maxv = (1 << bd) - 1;
  int* o = out + (size_t)(sb0 + sbl) * S::HW + i * W + 4 * bx;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint32_t bb = vx * (uint32_t)gdx[v] + vy * (uint32_t)gdy[v];
    o[v] = clip3(0, maxv, (int)((uint32_t)psum[v] + bb + offset) >> shift_num);
  }
}

template <int DX, int DY>
static int dmvr_search_launch(const int* pre0, const int* pre1, const int* f0x,
                              const int* f0y, const int* f1x, const int* f1y,
                              const int* bil, int n, int bd, int* out, cudaStream_t stream) {
  using S = DmvrShape<DX, DY>;
  dmvr_search_kernel<DX, DY><<<(n + S::PER - 1) / S::PER, S::THREADS, 0, stream>>>(
      pre0, pre1, f0x, f0y, f1x, f1y, bil, n, bd, out);
  return launch_status();
}

template <int W, int H>
static int bdof_blend_launch(const int* p0e, const int* p1e, int n, int bd, int* out,
                             cudaStream_t stream) {
  constexpr int per = BdofShape<W, H>::PER;
  bdof_blend_kernel<W, H><<<(n + per - 1) / per, BDOF_THREADS, 0, stream>>>(
      p0e, p1e, n, bd, out);
  return launch_status();
}

// A sub-PU of dx x dy (8 or 16 each): one instantiation per size; another
// size is refused.
VTM_API int vtm_dmvr_search(const int* pre0, const int* pre1, const int* f0x,
                            const int* f0y, const int* f1x, const int* f1y,
                            const int* bilinear, int n, int dx, int dy, int bd,
                            int* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dx == 8 && dy == 8)
    return dmvr_search_launch<8, 8>(pre0, pre1, f0x, f0y, f1x, f1y, bilinear, n, bd, out, st);
  if (dx == 16 && dy == 8)
    return dmvr_search_launch<16, 8>(pre0, pre1, f0x, f0y, f1x, f1y, bilinear, n, bd, out, st);
  if (dx == 8 && dy == 16)
    return dmvr_search_launch<8, 16>(pre0, pre1, f0x, f0y, f1x, f1y, bilinear, n, bd, out, st);
  if (dx == 16 && dy == 16)
    return dmvr_search_launch<16, 16>(pre0, pre1, f0x, f0y, f1x, f1y, bilinear, n, bd, out,
                                      st);
  return (int)cudaErrorInvalidValue;
}

// ngroups (1..FIR_MAX_GROUPS) job groups: ptrs holds 5 device pointers a
// group (bufs, x0, y0, cfh, cfv), dims 7 ints a group (n, H, W, w, h, taps,
// out_off); the group's outputs go to out + out_off, [n, h, w].  Another
// taps than 8 or 4, a buffer span or output past 2^31 - 1 samples (the
// kernel's offsets are 32-bit) or more groups are refused.
VTM_API int vtm_fir_blocks(int ngroups, const int* const* ptrs, const int* dims,
                           int bd, int* out, void* stream) {
  if (ngroups < 1 || ngroups > FIR_MAX_GROUPS) return (int)cudaErrorInvalidValue;
  FirJobs jobs = {};
  jobs.ngroups = ngroups;
  int blocks = 0, smem_words = 0;
  for (int i = 0; i < ngroups; ++i) {
    FirGroup& g = jobs.g[i];
    const int* d = dims + 7 * i;
    g.bufs = ptrs[5 * i];
    g.x0 = ptrs[5 * i + 1];
    g.y0 = ptrs[5 * i + 2];
    g.cfh = ptrs[5 * i + 3];
    g.cfv = ptrs[5 * i + 4];
    g.n = d[0], g.H = d[1], g.W = d[2], g.w = d[3], g.h = d[4], g.taps = d[5];
    g.out_off = d[6];
    if ((g.taps != 8 && g.taps != 4) || g.n < 0 || g.H < 1 || g.W < 1 || g.w < 1 ||
        g.h < 1 || g.w > FIR_THREADS || g.out_off < 0 ||
        (long long)g.n * g.H * g.W > 0x7fffffff || (long long)g.n * g.taps > 0x7fffffff ||
        g.out_off + (long long)g.n * g.h * g.w > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    // jobs a block: a thread a column, as many as the shared memory holds
    int J = FIR_THREADS / g.w, words = 0;
    for (; J > 0; --J) {
      words = fir_field_words(J, g.taps) + fir_span_words(J, g.H * g.W);
      if ((long long)words * 4 <= FIR_MAX_SMEM) break;
    }
    if (J == 0) return (int)cudaErrorInvalidValue;
    g.jobs = J;
    g.block0 = blocks;
    blocks += (g.n + J - 1) / J;
    smem_words = max(smem_words, words);
  }
  if (blocks == 0) return 0;
  const size_t smem = (size_t)smem_words * 4;
  if (smem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(
        (const void*)fir_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e) return e;
  }
  fir_blocks_kernel<<<blocks, FIR_THREADS, smem, (cudaStream_t)stream>>>(jobs, bd, out);
  return launch_status();
}

// A sub-block of w x h (8 or 16 each): one instantiation per size; another
// size is refused.
VTM_API int vtm_bdof_blend(const int* p0e, const int* p1e, int n, int w, int h,
                           int bd, int* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (w == 8 && h == 8) return bdof_blend_launch<8, 8>(p0e, p1e, n, bd, out, st);
  if (w == 16 && h == 8) return bdof_blend_launch<16, 8>(p0e, p1e, n, bd, out, st);
  if (w == 8 && h == 16) return bdof_blend_launch<8, 16>(p0e, p1e, n, bd, out, st);
  if (w == 16 && h == 16) return bdof_blend_launch<16, 16>(p0e, p1e, n, bd, out, st);
  return (int)cudaErrorInvalidValue;
}
