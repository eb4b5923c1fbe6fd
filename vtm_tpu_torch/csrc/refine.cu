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
//   * fir_blocks (composed into dmvr_final_pack by the wrapper) ->
//     vtm_fir_blocks: one thread per output sample, fir.cuh's two passes
//     with reads clamped to the block's own buffer, 14-bit result.
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
// Bound on the H100: all three are small per sub-PU (a 23x23 window in,
// 12 bytes out for the search; 16x16 samples for the others) and run at
// the decoder's batch sizes of tens to thousands of sub-PUs, so launch and
// job upload, not the card, set their time.

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

template <int TAPS>
__global__ void fir_blocks_kernel(const int* __restrict__ bufs, int n, int H,
                                  int W, const int* __restrict__ x0,
                                  const int* __restrict__ y0,
                                  const int* __restrict__ cfh,
                                  const int* __restrict__ cfv, int w, int h,
                                  int bd, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = h * w;
  if (i >= (long long)n * hw) return;
  const int j = (int)(i / hw);
  const int s = (int)(i % hw);
  const int ty = s / w, tx = s % w;
  const int half = TAPS / 2 - 1;
  const int hr = max(2, IF_INTERNAL_PREC - bd);
  const int acc = fir_acc<TAPS>(bufs + (long long)j * H * W, H, W,
                                x0[j] - half + tx, y0[j] - half + ty,
                                cfh + (long long)j * TAPS,
                                cfv + (long long)j * TAPS, 6 - hr);
  out[i] = acc >> 6;
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

VTM_API int vtm_fir_blocks(const int* bufs, int n, int H, int W, const int* x0,
                           const int* y0, const int* cfh, const int* cfv, int w,
                           int h, int taps, int bd, int* out, void* stream) {
  if (n == 0) return 0;
  const long long total = (long long)n * h * w;
  const int block = 256;
  const dim3 grid((unsigned)((total + block - 1) / block));
  cudaStream_t st = (cudaStream_t)stream;
  if (taps == 8) {
    fir_blocks_kernel<8><<<grid, block, 0, st>>>(bufs, n, H, W, x0, y0, cfh,
                                                 cfv, w, h, bd, out);
  } else if (taps == 4) {
    fir_blocks_kernel<4><<<grid, block, 0, st>>>(bufs, n, H, W, x0, y0, cfh,
                                                 cfv, w, h, bd, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
