// Batched intra RMD (rough mode decision) costs of one block-size class.
//
// Replaces vtm_tpu/encoder/rmd_tpu.py:_make_class_fn -> fn, which built every
// prediction of every mode as a (positions, modes, h, w) tensor (fp32 matrix
// products on the TPU's matrix unit) and took its SATD with
// rdcost.satd_batch_jax.  Three kernels compute the same table here:
//
//   rmd_angular_kernel<W, H>  the 67 regular modes.  A block takes NP
//     neighbouring positions of the list (x fastest, so their source windows
//     share cache lines) and stages, in shared memory, the class's compact
//     mode tables (encoder/rmd.py:_compact_tables) and per position the
//     reference buffer C = [Tu | Lu | Tf | Lf | 0] (edge-padded source row
//     and column, their [1 2 1] filtered copies, a zero slot), the DC value
//     (a warp reduction) and the source block.  Then warps take columns: a
//     lane predicts one row of a SATD tile in registers and the warp takes
//     the tile's Hadamard SATD (satd.cuh:warp_satd_tile: rows in registers,
//     columns across lanes with shuffles); the tiles of a column are summed
//     by shuffles and one lane stores the column.  Planar, DC and the exact
//     HOR / VER (columns 0-3) and the ver group come in one sweep over the
//     block as it is; the hor group in a second sweep over the transposed
//     block against the transposed source, as the reference predicts it.
//     An angular sample is VTM's refMain form: ref_m[j] = C[sym_m[j]] (the
//     zero slot past the mode's line), four taps of the row at consecutive
//     j = rowbase + x + k, (acc + 32) >> 6, clip, then PDPC with no clip
//     after it.  No per-sample index table exists.
//   rmd_mip_kernel<W, H>  every (MIP mode, transpose) pair: the boundary
//     downsampling and the matrix step spread over the block's threads
//     (weights staged in shared memory), the reduced predictions kept
//     (at most 768 ints a position); a lane upsamples its tile row in
//     registers from them and the boundaries, and the warp takes the SATD.
//   rmd_reduce_kernel  a warp per position, lanes on consecutive columns:
//     min and first argmin over the 67 native columns, planar (column 0),
//     and min and first argmin over the MIP columns (2^30 and 0 without
//     MIP), each by a lane's own minimum and two warp reductions
//     (__reduce_min_sync on the value, then on the column among the lanes
//     that hold it).  Bound: bytes, the table read once.
//
// Each class is its own instantiation: the tile shape, the tile count, the
// loop bounds and the shared-memory layout are compile-time constants.
// Nothing is stored but one int32 per (position, column), and no atomics:
// the integers are the jax reference's; ties go to the first column in the
// native order [0, 1, 18, 50, ver modes, hor modes, (mip0, F), (mip0, T),
// ...], which the host maps back.
//
// Bound on the H100: int32 instruction throughput (about 30 instructions
// per predicted sample and mode: 4 multiply-adds, the tap window's shared
// loads, the butterflies and the shuffles); device memory moves only the
// source windows (L2-resident), the tables and one int32 per column.

#include <climits>

#include "satd.cuh"

constexpr int N_ANG = 67;
constexpr int N_SPECIAL = 4;    // planar, DC, HOR, VER
constexpr int N_DIR = N_ANG - N_SPECIAL;
constexpr int MIP_SHIFT = 6;    // MIP_SHIFT_MATRIX
constexpr int MIP_OFFSET = 32;  // MIP_OFFSET_MATRIX
constexpr int THREADS = 256;

// The compact class table (encoder/rmd.py:_compact_tables), int32:
//   [0] length of the table, [1] tap rows, [2] offset of the tap rows;
//   per group g (0 ver, 1 hor) at TAB_GROUP0 + 8 g: modes M, first native
//   column, offsets of sym (M, sym_stride(DH, DW)): the index into C of
//   ref_m[j]; rows (M, DH): rowbase | tap row << 16; pdpc (M, PDPC_COLS):
//   PDPC weight | side offset << 8; side (M, 2): side base, side clamp.
//   A tap row packs the four signed 8-bit taps, the first lowest.
// The hor group's DH x DW block is the transposed W x H block.
constexpr int TAB_HEAD = 20;
constexpr int TAB_GROUP0 = 4;
constexpr int PDPC_COLS = 16;
constexpr int MAX_TAPS = 64;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int ilog2c(int v) { return v <= 1 ? 0 : 1 + ilog2c(v >> 1); }
__host__ __device__ constexpr int sym_stride(int dh, int dw) { return cmax(dh + dw + 3, 2 * dw + 4); }
__host__ __device__ constexpr int tab_cap(int w, int h) {
  return TAB_HEAD + MAX_TAPS +
         N_DIR * (cmax(sym_stride(h, w), sym_stride(w, h)) + cmax(w, h) + PDPC_COLS + 2);
}

__device__ __forceinline__ int pix(const int* srcpad, int Hp, int Wp, int y,
                                   int x) {
  // jax clamps gather indices
  return srcpad[(long long)clampi(y, Hp) * Wp + clampi(x, Wp)];
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL_WARP, v, s);
  return v;
}

// The columns [0, n_items) of a sweep through the warps of the block.  A
// column is a DH x DW block of TR x TC tiles; row(item, y, x0, d) writes the
// differences of its row y, columns x0 .. x0 + TC - 1, into d, and
// store(item, v) writes its SATD.  32 / TR tiles go through a warp at once:
// several columns when a column has fewer tiles, else a column takes
// several passes.  `rot` turns the warps' order, so that a sweep starts on
// the warps the previous one left idle; returns the rotation for the next.
template <int TR, int TC, int DH, int DW, class Row, class Store>
__device__ __forceinline__ int warp_columns(int n_items, int rot, Row row,
                                            Store store) {
  constexpr int S = 32 / TR;
  constexpr int NTX = DW / TC, NT = (DH / TR) * NTX;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int w = ((threadIdx.x >> 5) + nw - rot) % nw;
  const int slot = lane / TR, yr = lane % TR;
  if constexpr (NT <= S) {
    constexpr int PER = S / NT;  // columns a pass
    const int t = slot % NT, y = (t / NTX) * TR + yr, x0 = (t % NTX) * TC;
#pragma unroll 1
    for (int i0 = w * PER; i0 < n_items; i0 += nw * PER) {
      const int item = i0 + slot / NT;
      int d[TC];
      if (item < n_items) {
        row(item, y, x0, d);
      } else {
#pragma unroll
        for (int i = 0; i < TC; ++i) d[i] = 0;
      }
      int v = warp_satd_tile<TR, TC>(d);
#pragma unroll
      for (int s = TR; s < TR * NT; s <<= 1) v += __shfl_xor_sync(FULL_WARP, v, s);
      if (item < n_items && lane % (TR * NT) == 0) store(item, v);
    }
    return ((n_items + PER - 1) / PER + rot) % nw;
  } else {
#pragma unroll 1
    for (int item = w; item < n_items; item += nw) {
      int acc = 0;
#pragma unroll 1
      for (int t0 = 0; t0 < NT; t0 += S) {
        const int t = t0 + slot;
        int d[TC];
        row(item, (t / NTX) * TR + yr, (t % NTX) * TC, d);
        acc += warp_satd_tile<TR, TC>(d);
      }
#pragma unroll
      for (int s = TR; s < 32; s <<= 1) acc += __shfl_xor_sync(FULL_WARP, acc, s);
      if (lane == 0) store(item, acc);
    }
    return (n_items + rot) % nw;
  }
}

// ---------------------------------------------------------------------------
// angular

__host__ __device__ constexpr int positions_per_block(int w, int h) { return cmax(1, 512 / (w * h)); }

template <int W, int H>
struct Ang {
  static constexpr int NP = positions_per_block(W, H);
  static constexpr int TU = 0, LU = 2 * W + 1, TF = LU + 2 * H + 1;
  static constexpr int LF = TF + 2 * W + 1, ZS = LF + 2 * H + 1;
  static constexpr int DCV = ZS + 1, SRC = DCV + 1;
  static constexpr int PS = SRC + W * H;  // ints a position
  static constexpr int TABS = tab_cap(W, H);
  static constexpr size_t SMEM = (size_t)(TABS + NP * PS) * sizeof(int);
  static constexpr int KIND = satd_kind(H, W);
  static constexpr int TH = satd_tile_rows(KIND), TW = satd_tile_cols(KIND);
};

// PDPC of planar and DC (rmd_tpu.py:_pdpc_planar_dc_jnp), no clip.
__device__ __forceinline__ int pdpc_planar_dc(int pred, const int* top,
                                              const int* left, int yy, int xx,
                                              int scale) {
  const int wt = 32 >> min(31, (yy << 1) >> scale);
  const int wl = 32 >> min(31, (xx << 1) >> scale);
  return pred + ((wl * (left[1 + yy] - pred) + wt * (top[1 + xx] - pred) + 32) >> 6);
}

// Row y, columns x0.., of planar (0), DC (1), HOR (2) or VER (3) with their
// PDPC (rmd_tpu.py:_planar_dc_jnp), minus the source.
template <int W, int H, int TC>
__device__ __forceinline__ void special_row(int col, const int* C, int y,
                                            int x0, int maxv, int (&d)[TC]) {
  using K = Ang<W, H>;
  constexpr int L2W = ilog2c(W), L2H = ilog2c(H);
  constexpr int PD = (L2W - 2 + L2H - 2 + 2) >> 2, HV = (L2W + L2H - 2) >> 2;
  constexpr bool FILT = W * H > 32;
  const int* tu = C + K::TU;
  const int* lu = C + K::LU;
  const int* ut = FILT ? C + K::TF : tu;
  const int* ul = FILT ? C + K::LF : lu;
  const int* src = C + K::SRC + y * W;
  if (col == 0) {
    const int le = ul[1 + y], tr = ut[W + 1], bl = ul[H + 1];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const int x = x0 + i, tp = ut[1 + x];
      const int hor = (le << L2W) + (x + 1) * (tr - le);
      const int ver = (tp << L2H) + (y + 1) * (bl - tp);
      const int pr = ((hor << L2H) + (ver << L2W) + (1 << (L2W + L2H))) >> (1 + L2W + L2H);
      d[i] = pdpc_planar_dc(pr, ut, ul, y, x, PD) - src[x];
    }
  } else if (col == 1) {
    const int dcv = C[K::DCV];
#pragma unroll
    for (int i = 0; i < TC; ++i)
      d[i] = pdpc_planar_dc(dcv, tu, lu, y, x0 + i, PD) - src[x0 + i];
  } else if (col == 2) {
    const int wl = y < cmin(3 << HV, H) ? 32 >> min(31, (2 * y) >> HV) : 0;
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const int x = x0 + i;
      d[i] = clip3(0, maxv, lu[1 + y] + ((wl * (tu[1 + x] - tu[0]) + 32) >> 6)) - src[x];
    }
  } else {
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const int x = x0 + i;
      const int wl = x < cmin(3 << HV, W) ? 32 >> min(31, (2 * x) >> HV) : 0;
      d[i] = clip3(0, maxv, tu[1 + x] + ((wl * (lu[1 + y] - tu[0]) + 32) >> 6)) - src[x];
    }
  }
}

// Row r, columns c0.., of angular mode m of group g (a DH x DW block; T: the
// transposed W-wide source), minus the source.
template <int TC, int DH, int DW, bool T, int W>
__device__ __forceinline__ void angular_row(const int* stab, const int* g,
                                            int m, const int* C,
                                            const int* src, int r, int c0,
                                            int maxv, int (&d)[TC]) {
  const int info = stab[g[3] + m * DH + r];
  const int taps = stab[stab[2] + (info >> 16)];
  const int f0 = (signed char)taps, f1 = (signed char)(taps >> 8);
  const int f2 = (signed char)(taps >> 16), f3 = taps >> 24;
  const int* sym = stab + g[2] + m * sym_stride(DH, DW) + (info & 0xffff) + c0;
  const int* pdpc = stab + g[4] + m * PDPC_COLS;
  int a0 = C[sym[0]], a1 = C[sym[1]], a2 = C[sym[2]];
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    const int a3 = C[sym[i + 3]];
    int pr = clip3(0, maxv, (f0 * a0 + f1 * a1 + f2 * a2 + f3 * a3 + 32) >> 6);
    const int c = c0 + i;
    if (c < PDPC_COLS) {
      const int wc = pdpc[c];
      if (wc & 0xff) {
        const int* side = stab + g[5] + 2 * m;
        const int sv = C[side[0] + min(r + (wc >> 8), side[1])];
        pr += ((wc & 0xff) * (sv - pr) + 32) >> 6;  // no clip after PDPC
      }
    }
    d[i] = pr - (T ? src[c * W + r] : src[r * W + c]);
    a0 = a1;
    a1 = a2;
    a2 = a3;
  }
}

template <int W, int H>
__global__ void __launch_bounds__(THREADS, 2)
rmd_angular_kernel(const int* __restrict__ srcpad, int Hp, int Wp,
                   const int* __restrict__ xs, const int* __restrict__ ys,
                   int P, const int* __restrict__ tab, int maxv,
                   int* __restrict__ out, int ncols) {
  using K = Ang<W, H>;
  extern __shared__ int sm[];
  int* stab = sm;
  int* pos = sm + K::TABS;
  const int p0 = blockIdx.x * K::NP, np = min(K::NP, P - p0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int tab_len = tab[0];
  for (int k = tid; k < tab_len; k += nth) stab[k] = tab[k];
  // raw references (Tu, Lu) and the source block of each position
  constexpr int RAW = K::TF + W * H;
  for (int k = tid; k < np * RAW; k += nth) {
    const int p = k / RAW, e = k - p * RAW;
    const int x = xs[p0 + p], y = ys[p0 + p];
    int* C = pos + p * K::PS;
    if (e < K::LU) {
      C[e] = pix(srcpad, Hp, Wp, y, x + e);
    } else if (e < K::TF) {
      C[e] = pix(srcpad, Hp, Wp, y + e - K::LU, x);
    } else {
      const int j = e - K::TF;
      C[K::SRC + j] = pix(srcpad, Hp, Wp, y + 1 + j / W, x + 1 + j % W);
    }
  }
  __syncthreads();
  // filtered copies (rmd_tpu.py:_filter_refs_jnp)
  constexpr int FIL = K::ZS - K::TF;
  for (int k = tid; k < np * FIL; k += nth) {
    const int p = k / FIL, e = k - p * FIL;
    int* C = pos + p * K::PS;
    const int* tu = C + K::TU;
    const int* lu = C + K::LU;
    const int corner = (tu[0] + tu[1] + lu[0] + lu[1] + 2) >> 2;
    if (e < 2 * W + 1)
      C[K::TF + e] = e == 0 ? corner : e == 2 * W ? tu[e]
                                                  : (tu[e - 1] + 2 * tu[e] + tu[e + 1] + 2) >> 2;
    else {
      const int j = e - (2 * W + 1);
      C[K::LF + j] = j == 0 ? corner : j == 2 * H ? lu[j]
                                                  : (lu[j - 1] + 2 * lu[j] + lu[j + 1] + 2) >> 2;
    }
  }
  // the zero slot and the DC value, a warp a position
  const int lane = tid & 31, nw = nth >> 5;
  constexpr int DENOM = W == H ? 2 * W : cmax(W, H);
  for (int p = tid >> 5; p < np; p += nw) {
    int* C = pos + p * K::PS;
    int s = 0;
    if constexpr (W >= H)
      for (int k = lane; k < W; k += 32) s += C[K::TU + 1 + k];
    if constexpr (W <= H)
      for (int k = lane; k < H; k += 32) s += C[K::LU + 1 + k];
    s = warp_sum(s);
    if (lane == 0) {
      C[K::ZS] = 0;
      C[K::DCV] = (s + (DENOM >> 1)) >> ilog2c(DENOM);
    }
  }
  __syncthreads();

  const int* gv = stab + TAB_GROUP0;      // ver group: the block as it is
  const int* gh = stab + TAB_GROUP0 + 8;  // hor group: the transposed block
  const int na = N_SPECIAL + gv[0], mh = gh[0], hor0 = gh[1];
  int* o = out + (long long)p0 * ncols;
  const int rot = warp_columns<K::TH, K::TW, H, W>(
      np * na, 0,
      [&](int item, int y, int x0, int (&d)[K::TW]) {
        const int p = item / na, col = item - p * na;
        const int* C = pos + p * K::PS;
        if (col < N_SPECIAL)
          special_row<W, H, K::TW>(col, C, y, x0, maxv, d);
        else
          angular_row<K::TW, H, W, false, W>(stab, gv, col - N_SPECIAL, C,
                                             C + K::SRC, y, x0, maxv, d);
      },
      [&](int item, int v) {
        const int p = item / na;
        o[(long long)p * ncols + item - p * na] = v;
      });
  warp_columns<K::TW, K::TH, W, H>(
      np * mh, rot,
      [&](int item, int r, int c0, int (&d)[K::TH]) {
        const int p = item / mh;
        const int* C = pos + p * K::PS;
        angular_row<K::TH, W, H, true, W>(stab, gh, item - p * mh, C,
                                          C + K::SRC, r, c0, maxv, d);
      },
      [&](int item, int v) {
        const int p = item / mh;
        o[(long long)p * ncols + hor0 + item - p * mh] = v;
      });
}

// ---------------------------------------------------------------------------
// MIP

template <int W, int H>
struct Mip {
  static constexpr int SIZE_ID = (W == 4 && H == 4) ? 0
                                 : (W == 4 || H == 4 || (W == 8 && H == 8)) ? 1 : 2;
  static constexpr int BDRY = SIZE_ID == 0 ? 2 : 4, RED = SIZE_ID < 2 ? 4 : 8;
  static constexpr int IN = 2 * BDRY, RR = RED * RED;
  static constexpr int NM = SIZE_ID == 0 ? 16 : SIZE_ID == 1 ? 8 : 6;
  static constexpr int UPH = W / RED, UPV = H / RED;
  static constexpr int NP = cmin(8, cmax(1, 256 / (W * H)));
  static constexpr int THREADS_ = NP == 1 ? 128 : THREADS;
  static constexpr int T1 = 0, L1 = W, SRC = W + H, INP = SRC + W * H;
  static constexpr int IOFF = INP + 2 * IN, OFFS = IOFF + 2, RP = OFFS + 2;
  static constexpr int PS = RP + 2 * NM * RR;  // ints a position
  static constexpr int WADJ = NM * RR * IN;
  static constexpr size_t SMEM = (size_t)(WADJ + NP * PS) * sizeof(int);
  static constexpr int KIND = satd_kind(H, W);
  static constexpr int TH = satd_tile_rows(KIND), TW = satd_tile_cols(KIND);
};

// Boundary downsampling of MIP (rmd_tpu.py:_mip_jnp dsmp).
template <int LEN, int N>
__device__ __forceinline__ void mip_downsample(const int* full, int* dst) {
  if constexpr (N < LEN) {
    constexpr int FCT = LEN / N, LF = ilog2c(FCT);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int s = 0;
      for (int j = 0; j < FCT; ++j) s += full[i * FCT + j];
      dst[i] = (s + (1 << (LF - 1))) >> LF;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = full[i];
  }
}

// Upsampled sample (y, x) of the reduced prediction R (predictionUpsampling1D:
// horizontal on the reduced rows with the left column as the boundary, then
// vertical with the top row).
template <int W, int H>
__device__ __forceinline__ int mip_sample(const int* R, const int* t1,
                                          const int* l1, int y, int x) {
  using K = Mip<W, H>;
  auto hval = [&](int r) {
    if constexpr (K::UPH == 1) {
      return R[r * K::RED + x];
    } else {
      constexpr int LF = ilog2c(K::UPH);
      const int k = x / K::UPH, q = x % K::UPH;
      const int before = k == 0 ? l1[(r + 1) * K::UPV - 1] : R[r * K::RED + k - 1];
      return (before * (K::UPH - 1 - q) + R[r * K::RED + k] * (q + 1) + (1 << (LF - 1))) >> LF;
    }
  };
  if constexpr (K::UPV == 1) {
    return hval(y);
  } else {
    constexpr int LF = ilog2c(K::UPV);
    const int k = y / K::UPV, q = y % K::UPV;
    const int before = k == 0 ? t1[x] : hval(k - 1);
    return (before * (K::UPV - 1 - q) + hval(k) * (q + 1) + (1 << (LF - 1))) >> LF;
  }
}

template <int W, int H>
__global__ void __launch_bounds__(Mip<W, H>::THREADS_, 2)
rmd_mip_kernel(const int* __restrict__ srcpad, int Hp, int Wp,
               const int* __restrict__ xs, const int* __restrict__ ys, int P,
               const int* __restrict__ wadj, int bit_depth,
               int* __restrict__ out, int ncols) {
  using K = Mip<W, H>;
  extern __shared__ int sm[];
  int* wsm = sm;
  int* pos = sm + K::WADJ;
  const int p0 = blockIdx.x * K::NP, np = min(K::NP, P - p0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int maxv = (1 << bit_depth) - 1;
  for (int k = tid; k < K::WADJ; k += nth) wsm[k] = wadj[k];
  constexpr int RAW = K::INP;  // t1, l1, source
  for (int k = tid; k < np * RAW; k += nth) {
    const int p = k / RAW, e = k - p * RAW;
    const int x = xs[p0 + p], y = ys[p0 + p];
    int v;
    if (e < K::L1) {
      v = pix(srcpad, Hp, Wp, y, x + 1 + e);
    } else if (e < K::SRC) {
      v = pix(srcpad, Hp, Wp, y + 1 + e - K::L1, x);
    } else {
      const int j = e - K::SRC;
      v = pix(srcpad, Hp, Wp, y + 1 + j / W, x + 1 + j % W);
    }
    pos[p * K::PS + e] = v;
  }
  __syncthreads();
  // boundary inputs, a thread per (position, transpose)
  for (int k = tid; k < 2 * np; k += nth) {
    int* b = pos + (k >> 1) * K::PS;
    const int trp = k & 1;
    int tr_red[K::BDRY], lr_red[K::BDRY];
    mip_downsample<W, K::BDRY>(b + K::T1, tr_red);
    mip_downsample<H, K::BDRY>(b + K::L1, lr_red);
    const int off0 = trp ? lr_red[0] : tr_red[0];
    int s = 0;
#pragma unroll
    for (int i = 0; i < K::IN; ++i) {
      const int r = i < K::BDRY ? (trp ? lr_red[i] : tr_red[i])
                                : (trp ? tr_red[i - K::BDRY] : lr_red[i - K::BDRY]);
      const int v = i == 0 ? (K::SIZE_ID < 2 ? (1 << (bit_depth - 1)) - off0 : 0) : r - off0;
      b[K::INP + trp * K::IN + i] = v;
      s += v;
    }
    b[K::IOFF + trp] = off0;
    b[K::OFFS + trp] = (1 << (MIP_SHIFT - 1)) - MIP_OFFSET * s;
  }
  __syncthreads();
  // the matrix step: every reduced sample of every (mode, transpose)
  constexpr int RED_ITEMS = 2 * K::NM * K::RR;
  for (int k = tid; k < np * RED_ITEMS; k += nth) {
    const int p = k / RED_ITEMS, e = k - p * RED_ITEMS;
    const int trp = e / (K::NM * K::RR), rem = e % (K::NM * K::RR);
    const int m = rem / K::RR, q = rem % K::RR;
    int* b = pos + p * K::PS;
    const int* in = b + K::INP + trp * K::IN;
    const int* wv = wsm + (m * K::RR + q) * K::IN;
    int acc = 0;
#pragma unroll
    for (int i = 0; i < K::IN; ++i) acc += in[i] * wv[i];
    const int v = clip3(0, maxv, ((acc + b[K::OFFS + trp]) >> MIP_SHIFT) + b[K::IOFF + trp]);
    // the transposed pair is stored transposed (reduced rows x cols)
    b[K::RP + (trp * K::NM + m) * K::RR +
      (trp ? (q % K::RED) * K::RED + q / K::RED : q)] = v;
  }
  __syncthreads();
  int* o = out + (long long)p0 * ncols + N_ANG;
  constexpr int NC = 2 * K::NM;  // columns a position: (mode, transpose)
  warp_columns<K::TH, K::TW, H, W>(
      np * NC, 0,
      [&](int item, int y, int x0, int (&d)[K::TW]) {
        const int p = item / NC, col = item - p * NC;
        const int* b = pos + p * K::PS;
        const int* R = b + K::RP + ((col & 1) * K::NM + (col >> 1)) * K::RR;
        const int* src = b + K::SRC + y * W;
#pragma unroll
        for (int i = 0; i < K::TW; ++i)
          d[i] = mip_sample<W, H>(R, b + K::T1, b + K::L1, y, x0 + i) - src[x0 + i];
      },
      [&](int item, int v) {
        const int p = item / NC;
        o[(long long)p * ncols + item - p * NC] = v;
      });
}

// ---------------------------------------------------------------------------
// reduction

// A warp a position: lane l reads columns l, l + 32, ... of the row (the
// warp's loads coalesced) and keeps, for the angular and for the MIP
// columns, its minimum and the first column that holds it; the warp takes
// the minimum value, then the least column among the lanes that hold it:
// the first minimum in the native column order, as jnp.argmin takes it.
// The grid holds as many warps as the card keeps resident; each warp walks
// the positions with its next position's loads in flight while it reduces
// the current one.
constexpr int REDUCE_THREADS = 256;
constexpr int REDUCE_LOADS = 4;  // columns a lane: 32 x 4 >= 67 + 2 x 16

__device__ __forceinline__ void reduce_load(const int* __restrict__ out, int p, int P,
                                            int ncols, int lane, int (&v)[REDUCE_LOADS]) {
  const int* row = out + (long long)p * ncols;
#pragma unroll
  for (int k = 0; k < REDUCE_LOADS; ++k) {
    const int c = lane + 32 * k;
    v[k] = p < P && c < ncols ? row[c] : INT_MAX;
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
    rmd_reduce_kernel(const int* __restrict__ out, int P, int ncols, int n_mip_cols,
                      int* __restrict__ red) {
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * (REDUCE_THREADS / 32);
  int p = blockIdx.x * (REDUCE_THREADS / 32) + (threadIdx.x >> 5);
  int next[REDUCE_LOADS];
  reduce_load(out, p, P, ncols, lane, next);
  for (; p < P; p += step) {  // uniform across the warp
    int v[REDUCE_LOADS];
#pragma unroll
    for (int k = 0; k < REDUCE_LOADS; ++k) v[k] = next[k];
    reduce_load(out, p + step, P, ncols, lane, next);
    int ab = INT_MAX, aa = INT_MAX, mb = INT_MAX, ma = INT_MAX;
#pragma unroll
    for (int k = 0; k < REDUCE_LOADS; ++k) {
      const int c = lane + 32 * k;
      if (c < N_ANG) {
        if (v[k] < ab || aa == INT_MAX) ab = v[k], aa = c;
      } else if (c < ncols) {
        if (v[k] < mb || ma == INT_MAX) mb = v[k], ma = c - N_ANG;
      }
    }
    const unsigned all = 0xffffffffu;
    const int best = __reduce_min_sync(all, ab);
    const int arg = __reduce_min_sync(all, ab == best ? aa : INT_MAX);
    const int mbest = __reduce_min_sync(all, mb);
    const int marg = __reduce_min_sync(all, mb == mbest ? ma : INT_MAX);
    const int planar = __shfl_sync(all, v[0], 0);
    const bool mip = n_mip_cols > 0;
    if (lane < 5) {
      const int r = lane == 0   ? best
                    : lane == 1 ? arg
                    : lane == 2 ? planar
                    : lane == 3 ? (mip ? mbest : 1 << 30)
                                : (mip ? marg : 0);
      red[(long long)p * 5 + lane] = r;
    }
  }
}

// ---------------------------------------------------------------------------
// entry points: one instantiation per class of the intra class list
// (encoder/rmd.py:intra_class_list); another class is refused

#define RMD_CLASSES(X)                                                      \
  X(4, 4) X(4, 8) X(4, 16) X(4, 32) X(8, 4) X(8, 8) X(8, 16) X(8, 32)     \
  X(16, 4) X(16, 8) X(16, 16) X(16, 32) X(32, 4) X(32, 8) X(32, 16)        \
  X(32, 32) X(64, 64)

static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int W, int H>
static int launch_angular(const int* srcpad, int Hp, int Wp, const int* xs,
                          const int* ys, int P, const int* tab, int bit_depth,
                          int* out, int ncols, cudaStream_t st) {
  using K = Ang<W, H>;
  const int e = set_smem((const void*)rmd_angular_kernel<W, H>, K::SMEM);
  if (e) return e;
  rmd_angular_kernel<W, H><<<(P + K::NP - 1) / K::NP, THREADS, K::SMEM, st>>>(
      srcpad, Hp, Wp, xs, ys, P, tab, (1 << bit_depth) - 1, out, ncols);
  return launch_status();
}

template <int W, int H>
static int launch_mip(const int* srcpad, int Hp, int Wp, const int* xs,
                      const int* ys, int P, const int* wadj, int n_modes,
                      int bit_depth, int* out, int ncols, cudaStream_t st) {
  using K = Mip<W, H>;
  if (n_modes != K::NM) return (int)cudaErrorInvalidValue;
  const int e = set_smem((const void*)rmd_mip_kernel<W, H>, K::SMEM);
  if (e) return e;
  rmd_mip_kernel<W, H><<<(P + K::NP - 1) / K::NP, K::THREADS_, K::SMEM, st>>>(
      srcpad, Hp, Wp, xs, ys, P, wadj, bit_depth, out, ncols);
  return launch_status();
}

VTM_API int vtm_rmd_angular(const int* srcpad, int Hp, int Wp, const int* xs,
                            const int* ys, int P, const int* tab, int w, int h,
                            int bit_depth, int* out, int ncols, void* stream) {
#define RMD_ANGULAR(W_, H_)                                                  \
  if (w == W_ && h == H_)                                                   \
    return P == 0 ? 0 : launch_angular<W_, H_>(srcpad, Hp, Wp, xs, ys, P,   \
                                               tab, bit_depth, out, ncols,  \
                                               (cudaStream_t)stream);
  RMD_CLASSES(RMD_ANGULAR)
#undef RMD_ANGULAR
  return (int)cudaErrorInvalidValue;
}

VTM_API int vtm_rmd_mip(const int* srcpad, int Hp, int Wp, const int* xs,
                        const int* ys, int P, const int* wadj, int n_modes,
                        int w, int h, int bit_depth, int* out, int ncols,
                        void* stream) {
#define RMD_MIP(W_, H_)                                                      \
  if (w == W_ && h == H_)                                                   \
    return P == 0 ? 0 : launch_mip<W_, H_>(srcpad, Hp, Wp, xs, ys, P, wadj, \
                                           n_modes, bit_depth, out, ncols,  \
                                           (cudaStream_t)stream);
  RMD_CLASSES(RMD_MIP)
#undef RMD_MIP
  return (int)cudaErrorInvalidValue;
}

VTM_API int vtm_rmd_reduce(const int* out, int P, int ncols, int n_mip_cols,
                           int* red, void* stream) {
  if (ncols != N_ANG + n_mip_cols || n_mip_cols < 0 || ncols > 32 * REDUCE_LOADS)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  // as many blocks as the card keeps resident (2048 threads an SM), or fewer
  int dev = 0, sms = 0;
  int e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e) return e;
  constexpr int per_block = REDUCE_THREADS / 32;
  const int blocks = min((P + per_block - 1) / per_block, sms * (2048 / REDUCE_THREADS));
  rmd_reduce_kernel<<<blocks, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      out, P, ncols, n_mip_cols, red);
  return launch_status();
}

// What a class's two kernels run with on this card, into o[12]: for the
// angular then the MIP kernel, threads a block, dynamic shared bytes,
// resident blocks an SM, positions a block, registers a thread and local
// (spill) bytes a thread.  Not a kernel: nothing is launched.
template <class F>
static int kernel_config(F* fn, int threads, size_t smem, int np, int* o) {
  int e = set_smem((const void*)fn, smem);
  if (e) return e;
  cudaFuncAttributes a;
  e = (int)cudaFuncGetAttributes(&a, (const void*)fn);
  if (e) return e;
  int blocks = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (e) return e;
  o[0] = threads;
  o[1] = (int)smem;
  o[2] = blocks;
  o[3] = np;
  o[4] = a.numRegs;
  o[5] = (int)a.localSizeBytes;
  return 0;
}

VTM_API int vtm_rmd_config(int w, int h, int* o) {
#define RMD_CONFIG(W_, H_)                                                   \
  if (w == W_ && h == H_) {                                                 \
    const int e = kernel_config(rmd_angular_kernel<W_, H_>, THREADS,        \
                                Ang<W_, H_>::SMEM, Ang<W_, H_>::NP, o);     \
    return e ? e : kernel_config(rmd_mip_kernel<W_, H_>,                    \
                                 Mip<W_, H_>::THREADS_, Mip<W_, H_>::SMEM,  \
                                 Mip<W_, H_>::NP, o + 6);                   \
  }
  RMD_CLASSES(RMD_CONFIG)
#undef RMD_CONFIG
  return (int)cudaErrorInvalidValue;
}
