// Tile motion compensation of a slice (translational MC, uni and bi).
//
// Replaces vtm_tpu/ops/mc_kernel.py:mc_tiles (and its pair form
// _mc_tiles_pair, which the wrapper builds from two calls into one
// output).  Each tile (4x4 luma, 2x2 chroma) is an independent job: its own
// reference plane, window and filters.  The two-pass FIR runs over the
// tile's window, rows and columns clamped to its reference plane, then the
// branch-free final stage of the jax kernel (the four VTM filter paths in
// one form, see vtm_tpu_torch/ops/mc_kernel.py):
//   tmp   = (sum_k cH[k] * win[r][c + k] + off1) >> s1     (isFirst, notLast)
//   acc   =  sum_k cV[k] * tmp[r + k][c]                   (notFirst)
//   inter = acc >> 6                                       (bi: 14-bit)
//   r_v   = clip((acc + (1 << (5 + hr)) + (IF_OFFS << 6)) >> (6 + hr))
//   r_c   = clip((inter + IF_OFFS + (1 << (hr - 1))) >> hr)
//   out   = rnd ? (fy_nz ? r_v : r_c) : inter
// with sums in uint32_t, so that they wrap as jax's int32 sums do.
//
// The reference planes reach the kernel by value, as a kernel-parameter
// struct of up to MC_MAX_PLANES pointers (__grid_constant__: read in place,
// no local copy), so the decoder's DPB planes are read where they lie and
// the wrapper makes no host-to-device copy.
//
// Bound on the H100: bytes.  The job data (plane, x0, y0, two filters of
// `taps` coefficients, two flags: 78 B a luma tile, 46 B a chroma tile) and
// the output (16 B a tile) stream through device memory once; the windows
// (11x11 or 5x5 samples) are read through L2, where the reference planes
// stay, a window row touching 2-3 (luma) or 1-2 (chroma) 32-byte sectors.
// A block takes a group of tiles (64 luma or 128 chroma, 256 threads) and
//   1. stages the group's job fields and coefficients in shared memory with
//      coalesced loads, each read once;
//   2. loads every tile's window into shared memory, clamped, a warp a
//      tile at a time, so that a sample costs a clamp pair, an address, a
//      load and a store (no division and no tile lookup a sample: they, not
//      the memory traffic, set the pace of a flat loop over the samples);
//   3. gives each thread one column of one tile: the horizontal pass down
//      the window's rows at that column, (tile + taps - 1) sums, in
//      registers, then the vertical pass and the final stage of the
//      column's tile samples from those registers;
//   4. turns columns into rows through the tile's own window in shared
//      memory and writes the group's contiguous outputs, 16 bytes a thread
//      (luma) or 8 (chroma).
// That is 480 multiply-adds a luma tile, where one thread a sample (the
// horizontal pass redone for each) takes 1,152.

#include "fir.cuh"

constexpr int MC_MAX_PLANES = 256;  // 2 KB of the 4 KB of kernel parameters
constexpr int MC_THREADS = 256;

struct McPlanes {
  const int* p[MC_MAX_PLANES];
};

template <int TAPS, int TILE>
struct McShape {
  static constexpr int WIN = TILE + TAPS - 1;  // window side
  static constexpr int G = MC_THREADS / TILE;  // tiles a block: a thread a column
  // a tile's window in shared memory: 124 (luma) / 26 (chroma) words, so
  // that the tiles of a warp start on distinct banks (no conflict in the
  // horizontal pass) and a luma tile row is 16-byte aligned
  static constexpr int WS = TILE == 4 ? 124 : 26;
  static_assert(WS >= WIN * WIN && WS % TILE == 0, "window stride");
};

// The final stage of N accumulators of one tile.
template <int N>
__device__ __forceinline__ void mc_round(const uint32_t (&acc)[N], int (&v)[N],
                                         bool rnd, bool fy_nz, int hr, int maxv) {
  const int shl = 6 + hr;
  const uint32_t offl = (1u << (shl - 1)) + ((uint32_t)IF_OFFS << 6);
  const uint32_t offc = (uint32_t)IF_OFFS + (1u << (hr - 1));
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int inter = (int)acc[i] >> 6;
    int r = inter;
    if (rnd) {
      r = fy_nz ? clip3(0, maxv, (int)(acc[i] + offl) >> shl)
                : clip3(0, maxv, (int)((uint32_t)inter + offc) >> hr);
    }
    v[i] = r;
  }
}

template <int TAPS, int TILE>
__global__ void __launch_bounds__(MC_THREADS)
    mc_tiles_kernel(const __grid_constant__ McPlanes planes, int R, int H, int W,
                    const int* __restrict__ r_idx, const int* __restrict__ x0,
                    const int* __restrict__ y0, const int* __restrict__ cH,
                    const int* __restrict__ cV, const uint8_t* __restrict__ fy_nz,
                    const uint8_t* __restrict__ rnd, int n, int bd, int vec_out,
                    int* __restrict__ out) {
  using S = McShape<TAPS, TILE>;
  constexpr int G = S::G, WIN = S::WIN, NT = MC_THREADS;
  __shared__ const int* s_plane[G];
  __shared__ int s_x0[G], s_y0[G];
  __shared__ __align__(16) int s_ch[G * TAPS];
  __shared__ __align__(16) int s_cv[G * TAPS];
  __shared__ uint8_t s_fy[G], s_rnd[G];
  __shared__ __align__(16) int s_win[G * S::WS];
  const int t = threadIdx.x;
  const long long j0 = (long long)blockIdx.x * G;
  const int ng = (int)min((long long)G, (long long)n - j0);

  // 1. job fields, each read once; the tail past n gets a harmless job
  for (int i = t; i < G; i += NT) {
    const bool on = i < ng;
    s_plane[i] = planes.p[on ? clampi(r_idx[j0 + i], R) : 0];
    s_x0[i] = on ? x0[j0 + i] : 0;
    s_y0[i] = on ? y0[j0 + i] : 0;
    s_fy[i] = on ? fy_nz[j0 + i] : 0;
    s_rnd[i] = on ? rnd[j0 + i] : 0;
  }
  for (int i = t; i < G * TAPS; i += NT) {
    const bool on = i < ng * TAPS;
    s_ch[i] = on ? cH[j0 * TAPS + i] : 0;
    s_cv[i] = on ? cV[j0 * TAPS + i] : 0;
  }
  __syncthreads();

  // 2. the windows, clamped to their planes: a warp loads one tile's window
  // at a time, lane l taking samples l, l + 32, ... in row-major order, so
  // the lanes' (row, column) offsets are fixed and the tile's plane and
  // origin are the same for the whole warp
  constexpr int WW = WIN * WIN, SPAN = (WW + 31) / 32, WARPS = NT / 32;
  const int lane = t & 31, warp = t >> 5;
  int wr[SPAN], wc[SPAN];
#pragma unroll
  for (int k = 0; k < SPAN; ++k) {
    const int e = lane + 32 * k;
    wr[k] = e / WIN, wc[k] = e % WIN;
  }
#pragma unroll 2
  for (int g = warp; g < G; g += WARPS) {
    const int* plane = s_plane[g];
    const int gx = s_x0[g], gy = s_y0[g];
    int v[SPAN];
#pragma unroll
    for (int k = 0; k < SPAN; ++k) {
      if (lane + 32 * k < WW)
        v[k] = plane[clampi(gy + wr[k], H) * W + clampi(gx + wc[k], W)];
    }
#pragma unroll
    for (int k = 0; k < SPAN; ++k) {
      if (lane + 32 * k < WW) s_win[g * S::WS + lane + 32 * k] = v[k];
    }
  }
  __syncthreads();

  // 3. thread (tile g, column c): the horizontal pass down the window's
  // rows at column c, kept in registers, then the vertical pass and the
  // final stage of the column
  const int g = t / TILE, c = t % TILE;
  int* win = s_win + g * S::WS;
  int ch[TAPS], cv[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; k += 4) {
    const int4 a = *reinterpret_cast<const int4*>(s_ch + g * TAPS + k);
    const int4 b = *reinterpret_cast<const int4*>(s_cv + g * TAPS + k);
    ch[k] = a.x, ch[k + 1] = a.y, ch[k + 2] = a.z, ch[k + 3] = a.w;
    cv[k] = b.x, cv[k + 1] = b.y, cv[k + 2] = b.z, cv[k + 3] = b.w;
  }
  const int hr = max(2, IF_INTERNAL_PREC - bd);
  const int s1 = 6 - hr;
  const uint32_t off1 = (uint32_t)(-(IF_OFFS << s1));
  int tmp[WIN];
#pragma unroll
  for (int r = 0; r < WIN; ++r) {
    uint32_t acc = 0;
#pragma unroll
    for (int kh = 0; kh < TAPS; ++kh)
      acc += (uint32_t)ch[kh] * (uint32_t)win[r * WIN + c + kh];
    tmp[r] = (int)(acc + off1) >> s1;
  }
  uint32_t acc[TILE];
#pragma unroll
  for (int y = 0; y < TILE; ++y) {
    acc[y] = 0;
#pragma unroll
    for (int kv = 0; kv < TAPS; ++kv) acc[y] += (uint32_t)cv[kv] * (uint32_t)tmp[y + kv];
  }
  int v[TILE];
  mc_round(acc, v, s_rnd[g] != 0, s_fy[g] != 0, hr, (1 << bd) - 1);

  // 4. columns to rows through the tile's own window (only this warp reads
  // it), then each thread stores row c of its tile: a warp's stores are
  // contiguous, 16 bytes a thread (luma) or 8 (chroma)
  __syncwarp();
#pragma unroll
  for (int y = 0; y < TILE; ++y) win[y * TILE + c] = v[y];
  __syncwarp();
  if (g >= ng) return;
  int* o = out + (j0 + g) * (TILE * TILE) + c * TILE;
  if (TILE == 4 && vec_out) {
    *reinterpret_cast<int4*>(o) = *reinterpret_cast<const int4*>(win + c * TILE);
  } else if (TILE == 2 && vec_out) {
    *reinterpret_cast<int2*>(o) = *reinterpret_cast<const int2*>(win + c * TILE);
  } else {
#pragma unroll
    for (int x = 0; x < TILE; ++x) o[x] = win[c * TILE + x];
  }
}

template <int TAPS, int TILE>
static void launch_mc(const McPlanes& tab, int R, int H, int W, const int* r_idx,
                      const int* x0, const int* y0, const int* cH, const int* cV,
                      const uint8_t* fy_nz, const uint8_t* rnd, int n, int bd,
                      int* out, cudaStream_t st) {
  constexpr int G = McShape<TAPS, TILE>::G;
  const dim3 grid((unsigned)((n + G - 1) / G));
  const int vec_out = ((uintptr_t)out & 15) == 0;
  mc_tiles_kernel<TAPS, TILE><<<grid, MC_THREADS, 0, st>>>(
      tab, R, H, W, r_idx, x0, y0, cH, cV, fy_nz, rnd, n, bd, vec_out, out);
}

// planes: a host array of R device pointers (R <= MC_MAX_PLANES), copied
// into the kernel's parameters; taps/tile 8/4 (luma) or 4/2 (chroma).
VTM_API int vtm_mc_tiles(const int* const* planes, int R, int H, int W,
                         const int* r_idx, const int* x0, const int* y0,
                         const int* cH, const int* cV, const uint8_t* fy_nz,
                         const uint8_t* rnd, int n, int taps, int tile, int bd,
                         int* out, void* stream) {
  // planes of at most 2^31 - 1 samples: the kernel's offsets are 32-bit
  if (R < 1 || R > MC_MAX_PLANES || (long long)H * W > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  McPlanes tab;
  for (int i = 0; i < MC_MAX_PLANES; ++i) tab.p[i] = i < R ? planes[i] : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (taps == 8 && tile == 4) {
    launch_mc<8, 4>(tab, R, H, W, r_idx, x0, y0, cH, cV, fy_nz, rnd, n, bd, out, st);
  } else if (taps == 4 && tile == 2) {
    launch_mc<4, 2>(tab, R, H, W, r_idx, x0, y0, cH, cV, fy_nz, rnd, n, bd, out, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return launch_status();
}
