// DMVR bilateral search, private-buffer FIR and BDOF blend.
//
// Replaces, in vtm_tpu/ops/refine_kernel.py:
//   * dmvr_search (with _bilinear_batch and _div_for_maxq7) -> vtm_dmvr_search:
//     one thread block per sub-PU.  Both 2-tap bilinear search grids
//     ((dx+4) x (dy+4), at most 20x20) are built in shared memory, one
//     thread per offset computes the 25 even-row SADs, and one thread
//     applies the early-termination bias, the tie rule (the centre wins any
//     tie with the minimum; else the first minimum in raster order) and
//     the sub-pel error surface.
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
//   * bdof_blend_batch -> vtm_bdof_blend: one thread block per sub-block
//     (h, w in {8, 16}).  Gradients and the per-sample products are made
//     once per inner sample in shared memory; the replicated ring of the
//     jax form is a clamp of the inner index; one thread per 4x4 takes the
//     6x6 window sums and the flow (vx, vy); then every sample blends.
//
// int32 semantics: jax wraps and shifts negatives arithmetically; every
// left shift of a possibly negative value and every sum that could
// overflow is done in uint32_t and cast back.
//
// Bound on the H100: bytes.  All three are small per sub-PU (a 23x23
// window in, 12 bytes out for the search; 16x16 samples for the others);
// at the decoder's batch sizes of tens to thousands of sub-PUs launch and
// job upload set their time, at a 1080p picture's thousands the bytes:
// the FIR reads each buffer sample once and writes each output once.

#include "fir.cuh"

constexpr int DMVR_MAX_GRID = 20 * 20;  // (16 + 4) x (16 + 4)
constexpr int DMVR_OFFSETS = 25;
constexpr int DMVR_CENTRE = 12;

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
  const int num = (int)((uint32_t)(sa - sb) << 4);
  const int den = sa + sb - (int)((uint32_t)sc << 1);
  if (den == 0) return 0;
  if (sa != sc && sb != sc) return div_for_maxq7(num, den);
  return sa == sc ? -8 : 8;
}

__global__ void dmvr_search_kernel(const int* __restrict__ pre0,
                                   const int* __restrict__ pre1,
                                   const int* __restrict__ f0x,
                                   const int* __restrict__ f0y,
                                   const int* __restrict__ f1x,
                                   const int* __restrict__ f1y,
                                   const int* __restrict__ bil, int n, int dx,
                                   int dy, int bd, int* __restrict__ out) {
  __shared__ int grid[2][DMVR_MAX_GRID];
  __shared__ int cost[DMVR_OFFSETS];
  const int sp = blockIdx.x;
  const int gw = dx + 4, gh = dy + 4, pw = dx + 7, ph = dy + 7;
  const int s = 4 - (10 - bd);
  const int off = 1 << (s - 1);
  for (int l = 0; l < 2; ++l) {
    const int* pre = (l ? pre1 : pre0) + (long long)sp * ph * pw;
    const int fx = (l ? f1x : f0x)[sp], fy = (l ? f1y : f0y)[sp];
    const int cx0 = bil[clampi(fx, 16) * 2], cx1 = bil[clampi(fx, 16) * 2 + 1];
    const int cy0 = bil[clampi(fy, 16) * 2], cy1 = bil[clampi(fy, 16) * 2 + 1];
    for (int e = threadIdx.x; e < gh * gw; e += blockDim.x) {
      const int i = e / gw, j = e % gw;
      const int* r0 = pre + (1 + i) * pw + 1 + j;  // src[i][j], grid origin (1, 1)
      const int* r1 = r0 + pw;
      int v;
      if (fx == 0 && fy == 0) {
        v = r0[0] << (10 - bd);
      } else if (fy == 0) {
        v = (cx0 * r0[0] + cx1 * r0[1] + off) >> s;
      } else if (fx == 0) {
        v = (cy0 * r0[0] + cy1 * r1[0] + off) >> s;
      } else {
        const int t0 = (cx0 * r0[0] + cx1 * r0[1] + off) >> s;
        const int t1 = (cx0 * r1[0] + cx1 * r1[1] + off) >> s;
        v = (cy0 * t0 + cy1 * t1 + 8) >> 4;
      }
      grid[l][e] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < DMVR_OFFSETS) {
    const int dmx = threadIdx.x % 5 - 2, dmy = threadIdx.x / 5 - 2;
    const int* a = grid[0] + (2 + dmy) * gw + 2 + dmx;
    const int* b = grid[1] + (2 - dmy) * gw + 2 - dmx;
    uint32_t sad = 0;
    for (int r = 0; r < dy; r += 2)
      for (int c = 0; c < dx; ++c) sad += (uint32_t)abs(a[r * gw + c] - b[r * gw + c]);
    cost[threadIdx.x] = (int)sad;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int c00 = cost[DMVR_CENTRE];
  const int minc0 = c00 - (c00 >> 2);
  cost[DMVR_CENTRE] = minc0;
  const bool early = minc0 < dx * dy;
  int min_cost = cost[0], best = 0;
  for (int k = 1; k < DMVR_OFFSETS; ++k) {
    if (cost[k] < min_cost) {
      min_cost = cost[k];
      best = k;
    }
  }
  if (minc0 == min_cost) best = DMVR_CENTRE;
  int bx = best % 5 - 2, by = best / 5 - 2;
  if (early) {
    bx = by = 0;
    min_cost = minc0;
  }
  int total_x = bx * 16, total_y = by * 16;
  if (!early && abs(bx) != 2 && abs(by) != 2) {
    auto nb = [&](int ddy, int ddx) {
      return cost[clampi((by + 2 + ddy) * 5 + (bx + 2 + ddx), DMVR_OFFSETS)];
    };
    total_x += axis_delta(nb(0, -1), nb(0, 1), min_cost);
    total_y += axis_delta(nb(-1, 0), nb(1, 0), min_cost);
  }
  out[sp] = total_x;
  out[n + sp] = total_y;
  out[2 * n + sp] = min_cost;
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

constexpr int BDOF_MAX = 16;
constexpr int BDOF_EXT = (BDOF_MAX + 2) * (BDOF_MAX + 2);
constexpr int BDOF_INNER = BDOF_MAX * BDOF_MAX;
constexpr int BDOF_SUBBLOCKS = (BDOF_MAX / 4) * (BDOF_MAX / 4);

__device__ __forceinline__ int floor_log2_sat19(int x) {
  // the jax form counts x >= 2^i for i in 1..19, so it saturates at 19
  int lg = 0;
#pragma unroll
  for (int i = 1; i < 20; ++i) lg += (int)(x >= (1 << i));
  return lg;
}

__global__ void bdof_blend_kernel(const int* __restrict__ p0e,
                                  const int* __restrict__ p1e, int w, int h,
                                  int bd, int* __restrict__ out) {
  // per inner sample (i, j): the five window operands, the two gradient
  // differences and the sum of both predictions
  __shared__ int s_agx[BDOF_INNER], s_agy[BDOF_INNER], s_dix[BDOF_INNER],
      s_diy[BDOF_INNER], s_sgn[BDOF_INNER], s_gdx[BDOF_INNER],
      s_gdy[BDOF_INNER], s_psum[BDOF_INNER];
  __shared__ int s_vx[BDOF_SUBBLOCKS], s_vy[BDOF_SUBBLOCKS];
  const int sb = blockIdx.x;
  const int we = w + 2;
  const int* a = p0e + (long long)sb * (h + 2) * we;
  const int* b = p1e + (long long)sb * (h + 2) * we;
  for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
    const int i = e / w, j = e % w;
    const int c = (1 + i) * we + 1 + j;  // centre in the extended block
    const int gx0 = (a[c + 1] >> 6) - (a[c - 1] >> 6);
    const int gy0 = (a[c + we] >> 6) - (a[c - we] >> 6);
    const int gx1 = (b[c + 1] >> 6) - (b[c - 1] >> 6);
    const int gy1 = (b[c + we] >> 6) - (b[c - we] >> 6);
    const int tgx = (gx0 + gx1) >> 1, tgy = (gy0 + gy1) >> 1;
    const int tdi = (b[c] >> 4) - (a[c] >> 4);
    s_agx[e] = abs(tgx);
    s_agy[e] = abs(tgy);
    s_dix[e] = sgn(tgx) * tdi;
    s_diy[e] = sgn(tgy) * tdi;
    s_sgn[e] = sgn(tgy) * tgx;
    s_gdx[e] = gx0 - gx1;
    s_gdy[e] = gy0 - gy1;
    s_psum[e] = (int)((uint32_t)a[c] + (uint32_t)b[c]);
  }
  __syncthreads();
  const int nbx = w / 4, nby = h / 4;
  if (threadIdx.x < nbx * nby) {
    const int bx = threadIdx.x % nbx, by = threadIdx.x / nbx;
    uint32_t agx = 0, agy = 0, dix = 0, diy = 0, sgs = 0;
    // 6x6 window at stride 4 over the ring-extended grid: extended index
    // (4 by + u, 4 bx + v) is inner (clamp(4 by + u - 1), clamp(4 bx + v - 1))
    for (int u = 0; u < 6; ++u) {
      const int ii = clampi(4 * by + u - 1, h);
      for (int v = 0; v < 6; ++v) {
        const int e = ii * w + clampi(4 * bx + v - 1, w);
        agx += (uint32_t)s_agx[e];
        agy += (uint32_t)s_agy[e];
        dix += (uint32_t)s_dix[e];
        diy += (uint32_t)s_diy[e];
        sgs += (uint32_t)s_sgn[e];
      }
    }
    const int limit = 15;
    const int sum_abs_gx = (int)agx, sum_abs_gy = (int)agy;
    const int sum_sign = (int)sgs;
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
                   (int)((diy << 2) - (uint32_t)tmp_data) >>
                       floor_log2_sat19(max(sum_abs_gy, 1)));
    s_vx[threadIdx.x] = tmpx;
    s_vy[threadIdx.x] = tmpy;
  }
  __syncthreads();
  const int shift_num = IF_INTERNAL_PREC + 1 - bd;
  const uint32_t offset = (1u << (shift_num - 1)) + 2u * IF_OFFS;
  const int maxv = (1 << bd) - 1;
  int* o = out + (long long)sb * h * w;
  for (int e = threadIdx.x; e < h * w; e += blockDim.x) {
    const int i = e / w, j = e % w;
    const int k = (i / 4) * nbx + j / 4;
    const uint32_t bb = (uint32_t)s_vx[k] * (uint32_t)s_gdx[e] +
                        (uint32_t)s_vy[k] * (uint32_t)s_gdy[e];
    o[e] = clip3(0, maxv, (int)((uint32_t)s_psum[e] + bb + offset) >> shift_num);
  }
}

VTM_API int vtm_dmvr_search(const int* pre0, const int* pre1, const int* f0x,
                            const int* f0y, const int* f1x, const int* f1y,
                            const int* bilinear, int n, int dx, int dy, int bd,
                            int* out, void* stream) {
  if (n == 0) return 0;
  if ((dx != 8 && dx != 16) || (dy != 8 && dy != 16))
    return (int)cudaErrorInvalidValue;
  dmvr_search_kernel<<<n, 128, 0, (cudaStream_t)stream>>>(
      pre0, pre1, f0x, f0y, f1x, f1y, bilinear, n, dx, dy, bd, out);
  return launch_status();
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

VTM_API int vtm_bdof_blend(const int* p0e, const int* p1e, int n, int w, int h,
                           int bd, int* out, void* stream) {
  if (n == 0) return 0;
  if ((w != 8 && w != 16) || (h != 8 && h != 16))
    return (int)cudaErrorInvalidValue;
  bdof_blend_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(p0e, p1e, w, h, bd,
                                                         out);
  return launch_status();
}
