// Batched intra RMD (rough mode decision) costs of one block-size class.
//
// Replaces vtm_tpu/encoder/rmd_tpu.py:_make_class_fn -> fn, which built every
// prediction of every mode as a (positions, modes, h, w) tensor (fp32 matrix
// products on the TPU's matrix unit) and took its SATD with
// rdcost.satd_batch_jax.  Three kernels compute the same table here:
//
//   rmd_angular_kernel  one block per position.  The block builds the
//     reference buffer C = [Tu | Lu | Tf | Lf | 0] (edge-padded source row
//     and column, and their [1 2 1] filtered copies), the source block and
//     the predictions of planar, DC and exact HOR / VER with their PDPC in
//     shared memory; each thread then takes one (mode column, SATD tile)
//     pair (angular modes predicted in registers from the class tables:
//     4-tap filter, (acc + 32) >> 6, clip, PDPC with no clip after it),
//     takes the tile's SATD against the source (satd.cuh) and adds it to
//     the column's sum.  The hor group predicts the transposed block against
//     the transposed source, as the reference does.
//   rmd_mip_kernel  one block per position: boundary downsampling, the
//     reduced prediction of every (MIP mode, transpose) pair, then its
//     horizontal and vertical upsampling, all in shared memory (216 KB for
//     64x64, within the card's 227 KB), then per (pair, tile) the SATD.
//   rmd_reduce_kernel  one thread per position: min and first argmin over
//     the 67 native columns, planar (column 0), and min and first argmin
//     over the MIP columns (2^30 and 0 without MIP).
//
// No prediction leaves the block: at 1080p the reference's tensors would
// hold about 24 GB.  Integer sums commute, so the shared-memory atomics give
// the jax integers in any order; ties go to the first column in the native
// order [0, 1, 18, 50, ver modes, hor modes], which the host maps back.
//
// Bound on the H100: integer issue and shared-memory reads (about 5 table
// or C reads and 20 integer operations per predicted sample, 67 to 99
// columns per position); the only device-memory traffic is the source
// window, the class tables (L1/L2-resident) and one int32 per column.

#include "satd.cuh"

constexpr int N_ANG = 67;
constexpr int MIP_SHIFT = 6;    // MIP_SHIFT_MATRIX
constexpr int MIP_OFFSET = 32;  // MIP_OFFSET_MATRIX
constexpr int TAB_GROUP = 8;    // per group: M, dh, dw, col0, off cidx/f/wl/scidx

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

__host__ __device__ __forceinline__ int n_tiles(int h, int w) {
  const int k = satd_kind(h, w);
  return (h / satd_tile_rows(k)) * (w / satd_tile_cols(k));
}

static inline int block_threads(int items) {
  return items >= 256 ? 256 : ((items + 31) / 32) * 32;
}

__device__ __forceinline__ int pix(const int* srcpad, int Hp, int Wp, int y,
                                   int x) {
  // jax clamps gather indices
  return srcpad[(long long)clampi(y, Hp) * Wp + clampi(x, Wp)];
}

// The block's source samples src[h][w] at (y + 1, x + 1).
__device__ void load_source(const int* srcpad, int Hp, int Wp, int x, int y,
                            int w, int h, int* src) {
  for (int k = threadIdx.x; k < h * w; k += blockDim.x)
    src[k] = pix(srcpad, Hp, Wp, y + 1 + k / w, x + 1 + k % w);
}

// PDPC of planar and DC (rmd_tpu.py:_pdpc_planar_dc_jnp), no clip.
__device__ __forceinline__ int pdpc_planar_dc(int pred, const int* top,
                                              const int* left, int yy, int xx,
                                              int scale) {
  const int wt = 32 >> min(31, (yy << 1) >> scale);
  const int wl = 32 >> min(31, (xx << 1) >> scale);
  return pred + ((wl * (left[1 + yy] - pred) + wt * (top[1 + xx] - pred) + 32) >> 6);
}

__global__ void rmd_angular_kernel(const int* __restrict__ srcpad, int Hp,
                                   int Wp, const int* __restrict__ xs,
                                   const int* __restrict__ ys,
                                   const int* __restrict__ tab, int w, int h,
                                   int maxv, int* __restrict__ out, int ncols) {
  extern __shared__ int sm[];
  const int tu0 = 0, lu0 = 2 * w + 1, tf0 = lu0 + 2 * h + 1;
  const int lf0 = tf0 + 2 * w + 1, zslot = lf0 + 2 * h + 1;
  const int hw = h * w;
  int* C = sm;
  int* src = C + zslot + 1;
  int* spred = src + hw;  // predictions of modes 0, 1, 18, 50: (4, h, w)
  int* sums = spred + 4 * hw;
  int* dcv = sums + N_ANG;
  const int p = blockIdx.x;
  const int x = xs[p], y = ys[p];
  const int* tu = C + tu0;
  const int* lu = C + lu0;
  for (int k = threadIdx.x; k < 2 * w + 1; k += blockDim.x)
    C[tu0 + k] = pix(srcpad, Hp, Wp, y, x + k);
  for (int k = threadIdx.x; k < 2 * h + 1; k += blockDim.x)
    C[lu0 + k] = pix(srcpad, Hp, Wp, y + k, x);
  load_source(srcpad, Hp, Wp, x, y, w, h, src);
  for (int k = threadIdx.x; k < N_ANG; k += blockDim.x) sums[k] = 0;
  __syncthreads();
  // filtered copies (rmd_tpu.py:_filter_refs_jnp) and the DC value
  const int corner = (tu[0] + tu[1] + lu[0] + lu[1] + 2) >> 2;
  for (int k = threadIdx.x; k < 2 * w + 1; k += blockDim.x)
    C[tf0 + k] = k == 0 ? corner : k == 2 * w ? tu[k]
                                              : (tu[k - 1] + 2 * tu[k] + tu[k + 1] + 2) >> 2;
  for (int k = threadIdx.x; k < 2 * h + 1; k += blockDim.x)
    C[lf0 + k] = k == 0 ? corner : k == 2 * h ? lu[k]
                                              : (lu[k - 1] + 2 * lu[k] + lu[k + 1] + 2) >> 2;
  if (threadIdx.x == 0) {
    C[zslot] = 0;
    const int denom = w == h ? 2 * w : max(w, h);
    int s = 0;
    if (w >= h)
      for (int k = 1; k <= w; ++k) s += tu[k];
    if (w <= h)
      for (int k = 1; k <= h; ++k) s += lu[k];
    *dcv = (s + (denom >> 1)) >> ilog2(denom);
  }
  __syncthreads();

  // planar, DC, exact HOR and VER with their PDPC (rmd_tpu.py:_planar_dc_jnp)
  const int log2w = ilog2(w), log2h = ilog2(h);
  const int pd_scale = (log2w - 2 + log2h - 2 + 2) >> 2;
  const int hv_scale = (log2w + log2h - 2) >> 2;
  const bool planar_filtered = w * h > 32;
  const int* ut = planar_filtered ? C + tf0 : tu;
  const int* ul = planar_filtered ? C + lf0 : lu;
  for (int k = threadIdx.x; k < 4 * hw; k += blockDim.x) {
    const int col = k / hw, yy = (k % hw) / w, xx = k % w;
    int pr;
    if (col == 0) {
      const int le = ul[1 + yy], tp = ut[1 + xx];
      const int hor = (le << log2w) + (xx + 1) * (ut[w + 1] - le);
      const int ver = (tp << log2h) + (yy + 1) * (ul[h + 1] - tp);
      pr = ((hor << log2h) + (ver << log2w) + (1 << (log2w + log2h))) >>
           (1 + log2w + log2h);
      pr = pdpc_planar_dc(pr, ut, ul, yy, xx, pd_scale);
    } else if (col == 1) {
      pr = pdpc_planar_dc(*dcv, tu, lu, yy, xx, pd_scale);
    } else if (col == 2) {
      const int wl = yy < min(3 << hv_scale, h) ? 32 >> min(31, (2 * yy) >> hv_scale) : 0;
      pr = clip3(0, maxv, lu[1 + yy] + ((wl * (tu[1 + xx] - tu[0]) + 32) >> 6));
    } else {
      const int wl = xx < min(3 << hv_scale, w) ? 32 >> min(31, (2 * xx) >> hv_scale) : 0;
      pr = clip3(0, maxv, tu[1 + xx] + ((wl * (lu[1 + yy] - tu[0]) + 32) >> 6));
    }
    spred[k] = pr;
  }
  __syncthreads();

  const int kind = satd_kind(h, w);
  const int nt = n_tiles(h, w);
  const int hor_col0 = tab[TAB_GROUP + 3];
  const bool has_hor = tab[TAB_GROUP] > 0;
  for (int it = threadIdx.x; it < N_ANG * nt; it += blockDim.x) {
    const int col = it / nt, t = it % nt;
    int v;
    if (col < 4) {
      const int tw = satd_tile_cols(kind), th = satd_tile_rows(kind);
      const int ntx = w / tw;
      const int* pr = spred + col * hw;
      v = satd_tile(kind, (t / ntx) * th, (t % ntx) * tw, [&](int yy, int xx) {
        return pr[yy * w + xx] - src[yy * w + xx];
      });
    } else {
      const int g = has_hor && col >= hor_col0 ? 1 : 0;
      const int* hd = tab + g * TAB_GROUP;
      const int dh = hd[1], dw = hd[2], m = col - hd[3];
      const int* cidx = tab + hd[4];
      const int* f = tab + hd[5];
      const int* wl = tab + hd[6] + m * dw;
      const int* scidx = tab + hd[7];
      const int gk = satd_kind(dh, dw);
      const int tw = satd_tile_cols(gk), th = satd_tile_rows(gk);
      const int ntx = dw / tw;
      v = satd_tile(gk, (t / ntx) * th, (t % ntx) * tw, [&](int yy, int xx) {
        const int r = m * dh + yy;
        const int* ci = cidx + ((long long)r * dw + xx) * 4;
        const int* fr = f + r * 4;
        const int acc = fr[0] * C[ci[0]] + fr[1] * C[ci[1]] + fr[2] * C[ci[2]] +
                        fr[3] * C[ci[3]];
        int pr = clip3(0, maxv, (acc + 32) >> 6);
        const int side = C[scidx[(long long)r * dw + xx]];
        pr += (wl[xx] * (side - pr) + 32) >> 6;  // no clip after PDPC
        return pr - (g == 0 ? src[yy * w + xx] : src[xx * w + yy]);
      });
    }
    atomicAdd(&sums[col], v);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N_ANG; k += blockDim.x)
    out[(long long)p * ncols + k] = sums[k];
}

// Boundary downsampling of MIP (rmd_tpu.py:_mip_jnp dsmp).
__device__ __forceinline__ void mip_downsample(const int* full, int len, int n,
                                               int* dst) {
  if (n < len) {
    const int fct = len / n, lf = ilog2(fct);
    for (int i = 0; i < n; ++i) {
      int s = 0;
      for (int j = 0; j < fct; ++j) s += full[i * fct + j];
      dst[i] = (s + (1 << (lf - 1))) >> lf;
    }
  } else {
    for (int i = 0; i < n; ++i) dst[i] = full[i];
  }
}

__global__ void rmd_mip_kernel(const int* __restrict__ srcpad, int Hp, int Wp,
                               const int* __restrict__ xs,
                               const int* __restrict__ ys,
                               const int* __restrict__ wadj, int n_modes,
                               int w, int h, int bit_depth,
                               int* __restrict__ out, int ncols) {
  extern __shared__ int sm[];
  const int size_id = (w == 4 && h == 4) ? 0 : (w == 4 || h == 4 || (w == 8 && h == 8)) ? 1 : 2;
  const int bdry = size_id == 0 ? 2 : 4, red = size_id < 2 ? 4 : 8;
  const int input_size = 2 * bdry, rr = red * red;
  const int up_h = w / red, up_v = h / red;
  const int maxv = (1 << bit_depth) - 1;
  int* t1 = sm;             // top row, w
  int* l1 = t1 + w;         // left column, h
  int* src = l1 + h;        // h * w
  int* inp = src + h * w;   // 2 x 8 boundary inputs
  int* ioff = inp + 16;     // 2
  int* offs = ioff + 2;     // 2
  int* rp = offs + 2;       // reduced predictions, (2, n_modes, red, red)
  int* sums = rp + 2 * n_modes * rr;
  int* up = sums + 2 * n_modes;  // full predictions, (n_modes, 2, h, w)
  const int p = blockIdx.x;
  const int x = xs[p], y = ys[p];
  for (int k = threadIdx.x; k < w; k += blockDim.x) t1[k] = pix(srcpad, Hp, Wp, y, x + 1 + k);
  for (int k = threadIdx.x; k < h; k += blockDim.x) l1[k] = pix(srcpad, Hp, Wp, y + 1 + k, x);
  load_source(srcpad, Hp, Wp, x, y, w, h, src);
  for (int k = threadIdx.x; k < 2 * n_modes; k += blockDim.x) sums[k] = 0;
  __syncthreads();
  if (threadIdx.x < 2) {
    const int trp = threadIdx.x;
    int tr_red[4], lr_red[4], r[8];
    mip_downsample(t1, w, bdry, tr_red);
    mip_downsample(l1, h, bdry, lr_red);
    for (int i = 0; i < bdry; ++i) {
      r[i] = trp ? lr_red[i] : tr_red[i];
      r[bdry + i] = trp ? tr_red[i] : lr_red[i];
    }
    const int off0 = r[0];
    int s = 0;
    for (int i = 0; i < input_size; ++i) {
      const int v = i == 0 ? (size_id < 2 ? (1 << (bit_depth - 1)) - off0 : 0) : r[i] - off0;
      inp[trp * 8 + i] = v;
      s += v;
    }
    ioff[trp] = off0;
    offs[trp] = (1 << (MIP_SHIFT - 1)) - MIP_OFFSET * s;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < 2 * n_modes * rr; it += blockDim.x) {
    const int trp = it / (n_modes * rr), rem = it % (n_modes * rr);
    const int m = rem / rr, o = rem % rr;
    const int* wv = wadj + ((long long)m * rr + o) * input_size;
    int acc = 0;
    for (int i = 0; i < input_size; ++i) acc += inp[trp * 8 + i] * wv[i];
    const int v = clip3(0, maxv, ((acc + offs[trp]) >> MIP_SHIFT) + ioff[trp]);
    // the transposed pair is stored transposed (reduced rows x cols)
    rp[(trp * n_modes + m) * rr + (trp ? (o % red) * red + o / red : o)] = v;
  }
  __syncthreads();

  // upsampling (predictionUpsampling1D): horizontal on the reduced rows
  // with the left column as the boundary, then vertical with the top row
  const int hw = h * w;
  const int lfh = up_h > 1 ? ilog2(up_h) : 0, lfv = up_v > 1 ? ilog2(up_v) : 0;
  auto hval = [&](const int* R, int r, int xx) {
    if (up_h == 1) return R[r * red + xx];
    const int k = xx / up_h, pos = xx % up_h;
    const int before = k == 0 ? l1[(r + 1) * up_v - 1] : R[r * red + k - 1];
    return (before * (up_h - 1 - pos) + R[r * red + k] * (pos + 1) + (1 << (lfh - 1))) >> lfh;
  };
  for (int k = threadIdx.x; k < 2 * n_modes * hw; k += blockDim.x) {
    const int col = k / hw, yy = (k % hw) / w, xx = k % w;  // col = 2 mode + T
    const int* R = rp + ((col & 1) * n_modes + (col >> 1)) * rr;
    int pr;
    if (up_v == 1) {
      pr = hval(R, yy, xx);
    } else {
      const int kk = yy / up_v, pos = yy % up_v;
      const int before = kk == 0 ? t1[xx] : hval(R, kk - 1, xx);
      pr = (before * (up_v - 1 - pos) + hval(R, kk, xx) * (pos + 1) + (1 << (lfv - 1))) >> lfv;
    }
    up[k] = pr;
  }
  __syncthreads();

  const int kind = satd_kind(h, w);
  const int tw = satd_tile_cols(kind), th = satd_tile_rows(kind);
  const int ntx = w / tw, nt = n_tiles(h, w);
  for (int it = threadIdx.x; it < 2 * n_modes * nt; it += blockDim.x) {
    const int col = it / nt, t = it % nt;
    const int* pr = up + col * hw;
    const int v = satd_tile(kind, (t / ntx) * th, (t % ntx) * tw, [&](int yy, int xx) {
      return pr[yy * w + xx] - src[yy * w + xx];
    });
    atomicAdd(&sums[col], v);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * n_modes; k += blockDim.x)
    out[(long long)p * ncols + N_ANG + k] = sums[k];
}

__global__ void rmd_reduce_kernel(const int* __restrict__ out, int P,
                                  int ncols, int n_mip_cols,
                                  int* __restrict__ red) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int* row = out + (long long)p * ncols;
  int best = row[0], arg = 0;
  for (int c = 1; c < N_ANG; ++c)
    if (row[c] < best) best = row[c], arg = c;
  int* r = red + (long long)p * 5;
  r[0] = best;
  r[1] = arg;
  r[2] = row[0];
  if (n_mip_cols > 0) {
    int mb = row[N_ANG], ma = 0;
    for (int c = 1; c < n_mip_cols; ++c)
      if (row[N_ANG + c] < mb) mb = row[N_ANG + c], ma = c;
    r[3] = mb;
    r[4] = ma;
  } else {
    r[3] = 1 << 30;
    r[4] = 0;
  }
}

static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

VTM_API int vtm_rmd_angular(const int* srcpad, int Hp, int Wp, const int* xs,
                            const int* ys, int P, const int* tab, int w, int h,
                            int bit_depth, int* out, int ncols, void* stream) {
  if (P == 0) return 0;
  const size_t smem = (size_t)(4 * w + 4 * h + 5 + 5 * h * w + N_ANG + 1) * sizeof(int);
  int e = set_smem((const void*)rmd_angular_kernel, smem);
  if (e) return e;
  rmd_angular_kernel<<<P, block_threads(N_ANG * n_tiles(h, w)), smem,
                       (cudaStream_t)stream>>>(srcpad, Hp, Wp, xs, ys, tab, w,
                                               h, (1 << bit_depth) - 1, out,
                                               ncols);
  return launch_status();
}

VTM_API int vtm_rmd_mip(const int* srcpad, int Hp, int Wp, const int* xs,
                        const int* ys, int P, const int* wadj, int n_modes,
                        int w, int h, int bit_depth, int* out, int ncols,
                        void* stream) {
  if (P == 0) return 0;
  const int red = (w == 4 || h == 4 || (w == 8 && h == 8)) ? 4 : 8;
  const size_t smem = (size_t)(w + h + h * w + 20 + 2 * n_modes * red * red +
                               2 * n_modes + 2 * n_modes * h * w) * sizeof(int);
  int e = set_smem((const void*)rmd_mip_kernel, smem);
  if (e) return e;
  const int items = 2 * n_modes * max(red * red, h * w);
  rmd_mip_kernel<<<P, block_threads(items), smem, (cudaStream_t)stream>>>(
      srcpad, Hp, Wp, xs, ys, wadj, n_modes, w, h, bit_depth, out, ncols);
  return launch_status();
}

VTM_API int vtm_rmd_reduce(const int* out, int P, int ncols, int n_mip_cols,
                           int* red, void* stream) {
  if (P == 0) return 0;
  const int block = 128;
  rmd_reduce_kernel<<<(P + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      out, P, ncols, n_mip_cols, red);
  return launch_status();
}
