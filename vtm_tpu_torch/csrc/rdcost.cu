// Batched Hadamard SATD of difference blocks.
//
// Replaces vtm_tpu/ops/rdcost.py:satd_batch_jax, which ran the tile
// transforms as float32 matrix products on the TPU's matrix unit.  Here the
// tile kind is fixed at compile time (one instantiation per kind, chosen on
// the host by satd_kind) and lanes take tile rows: the G = TR / R lanes of a
// tile hold R rows each (lane q: rows q, q + G, ...), so the column
// transform's first log2 R stages run in registers and the rest across the
// lanes by shuffles (satd.cuh's rows_satd_tile).  A block's
// L = h * (w / TC) / R lane rows go to P lanes (the least power of two >= L,
// at most a CTA's 256 threads); neighbouring lanes read neighbouring rows,
// 16 bytes at a time where a row is aligned.  A block's sum stays on chip:
// xor shuffles within a warp, and where a block spans several warps
// (P > 32: 64x64 blocks of 8x8 tiles, SAD blocks of 33 or more samples) one
// partial a warp through shared memory.  Then one plain store a block: no
// memset, no atomics, so a call is one launch and `out` may hold anything
// before it.  SAD blocks (odd sizes) are the same with 1 x 1 tiles: lanes
// stride over the samples.  A persistent grid (as many CTAs as fit on the
// card at once) walks over steps of U x 256 / P blocks (U where L <= P, one
// block a step where L > 256), each lane loading the rows of its U blocks
// before it transforms any of them.  A step's first block is a 64-bit
// offset, every other offset is 32-bit.
//
// R and U were chosen on the H100 by timing the 1920x1080 tilings: a whole
// tile a thread only for 4x4 and 2x2 tiles (64 and 16 bytes), whose lanes
// then read 64 bytes apart; larger tiles a thread read too far apart.
// Bound on the H100: memory.  Each sample is read once (4 bytes) and costs
// about log2(TR * TC) adds and a few shuffles; a call of 1920x1080 samples
// moves 8.29 MB.

#include "satd.cuh"

constexpr int SATD_THREADS = 256;

// rows of a tile a lane: R; blocks a lane takes a step: U
template <int KIND>
struct SatdLanes {
  static constexpr int TR = satd_tile_rows(KIND), TC = satd_tile_cols(KIND);
  static constexpr int R = KIND == SATD_8x16 || KIND == SATD_4x8 || KIND == SATD_2x2 ? 2
                           : KIND == SATD_SAD ? 1 : 4;
  static constexpr int G = TR / R;  // lanes a tile
  static constexpr int U = R * TC >= 16 ? 1 : 16 / (R * TC);
};

// Offset in its block of lane row r's first row: the G lane rows of a tile
// are consecutive, tiles in raster order (ntx across); a SAD block's lane
// rows are its samples.
template <int KIND>
__device__ __forceinline__ int satd_row_offset(int r, int w, int ntx) {
  using S = SatdLanes<KIND>;
  if constexpr (KIND == SATD_SAD) {
    return r;
  } else {
    const int t = r / S::G, ty = t / ntx;
    return (ty * S::TR + r % S::G) * w + (t - ty * ntx) * S::TC;
  }
}

// TC samples from p: 16-byte (TC = 2: 8-byte) loads where p is aligned.
template <int TC>
__device__ __forceinline__ void satd_load_row(const int* __restrict__ p, int (&d)[TC]) {
  if constexpr (TC >= 4) {
    if (((uintptr_t)p & 15) == 0) {
#pragma unroll
      for (int i = 0; i < TC; i += 4) {
        const int4 v = *reinterpret_cast<const int4*>(p + i);
        d[i] = v.x;
        d[i + 1] = v.y;
        d[i + 2] = v.z;
        d[i + 3] = v.w;
      }
      return;
    }
  } else if constexpr (TC == 2) {
    if (((uintptr_t)p & 7) == 0) {
      const int2 v = *reinterpret_cast<const int2*>(p);
      d[0] = v.x;
      d[1] = v.y;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < TC; ++i) d[i] = p[i];
}

// TC samples of each of the lane's R rows of a tile, from its first, p.
template <int KIND>
__device__ __forceinline__ void satd_load_rows(const int* __restrict__ p, int w, bool live,
                                               int (&d)[SatdLanes<KIND>::R][SatdLanes<KIND>::TC]) {
  using S = SatdLanes<KIND>;
  if (live) {
#pragma unroll
    for (int j = 0; j < S::R; ++j) satd_load_row<S::TC>(p + j * S::G * w, d[j]);
  } else {
#pragma unroll
    for (int j = 0; j < S::R; ++j)
#pragma unroll
      for (int i = 0; i < S::TC; ++i) d[j][i] = 0;  // an all-zero tile adds 0
  }
}

template <int KIND>
__device__ __forceinline__ int satd_lane_value(int (&d)[SatdLanes<KIND>::R][SatdLanes<KIND>::TC]) {
  using S = SatdLanes<KIND>;
  if constexpr (KIND == SATD_SAD) return abs(d[0][0]);
  else return rows_satd_tile<S::TR, S::TC, S::R>(d);
}

template <int KIND>
__global__ void __launch_bounds__(SATD_THREADS)
    satd_batch_kernel(const int* __restrict__ diff, int* __restrict__ out, long long n,
                      long long steps, int h, int w, int L, int lp) {
  using S = SatdLanes<KIND>;
  constexpr int U = S::U;
  __shared__ int part[2][U][SATD_THREADS / 32];
  const int P = 1 << lp, tid = threadIdx.x, p = tid & (P - 1);
  const int per_cta = SATD_THREADS >> lp, hw = h * w;
  const int ntx = max(w / S::TC, 1);  // w = 0: no rows at all
  const int off0 = satd_row_offset<KIND>(min(p, L - 1), w, ntx);  // the same in every block
  // blocks a step: U a lane where a block has at most P lane rows, else one
  // (its rows p, p + P, ... in turn); `steps` of them cover the n blocks
  const int u_step = L <= P ? U : 1;
  int buf = 0;
  for (long long g = blockIdx.x; g < steps; g += gridDim.x) {
    // the lane's blocks: b0 + u per_cta, u < u_step; the 64-bit offset is
    // taken once a step, a block's offset from it fits 32 bits (where
    // u_step > 1 a block has at most 256 lane rows: at most 16,384 samples)
    const long long b0 = g * (u_step * per_cta) + (tid >> lp);
    const int left = (int)min(n - b0, 0x7fffffffLL);  // blocks from b0 on
    const int* __restrict__ src = diff + b0 * hw;
    auto live = [&](int u) { return u < u_step && u * per_cta < left; };
    int acc[U];
    if (L <= P) {
      // every row of the lane's U blocks loaded before any tile is taken
      int d[U][S::R][S::TC];
#pragma unroll
      for (int u = 0; u < U; ++u)
        satd_load_rows<KIND>(src + u * per_cta * hw + off0, w, live(u) && p < L, d[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = satd_lane_value<KIND>(d[u]);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = 0;
#pragma unroll 1
      for (int r = p; r < L + P - 1 - (L - 1) % P; r += P) {
        int d[S::R][S::TC];
        satd_load_rows<KIND>(src + satd_row_offset<KIND>(r, w, ntx), w, live(0) && r < L, d);
        acc[0] += satd_lane_value<KIND>(d);
      }
    }
    // every lane of a tile holds its value: add the tiles of the block's
    // lanes in this warp
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int s = S::G; s < 32; s <<= 1)
        if (s < P) acc[u] += __shfl_xor_sync(FULL_WARP, acc[u], s);
    if (P <= 32) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (live(u) && p == 0) out[b0 + u * per_cta] = acc[u];
    } else {
      if ((tid & 31) == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) part[buf][u][tid >> 5] = acc[u];
      }
      __syncthreads();
      if (p == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          int sum = 0;
          for (int i = 0; i < P / 32; ++i) sum += part[buf][u][(tid >> 5) + i];
          if (live(u)) out[b0 + u * per_cta] = sum;
        }
      }
      buf ^= 1;  // the next step writes the other half: no second barrier
    }
  }
}

template <int KIND>
static int launch_satd(const int* diff, int* out, long long n, int h, int w,
                       cudaStream_t stream) {
  using S = SatdLanes<KIND>;
  const int L = h * (w / S::TC) / S::R;
  int lp = 0;
  while ((1 << lp) < L && (1 << lp) < SATD_THREADS) ++lp;
  const auto kernel = satd_batch_kernel<KIND>;
  int dev = 0, sms = 0, per_sm = 0;
  int e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SATD_THREADS, 0);
  if (e) return e;
  const int per_step = (SATD_THREADS >> lp) * (L <= SATD_THREADS ? S::U : 1);
  const long long steps = (n + per_step - 1) / per_step;
  const long long resident = sms * per_sm > 0 ? (long long)sms * per_sm : 1;
  const unsigned grid = (unsigned)(steps < resident ? steps : resident);
  kernel<<<grid, SATD_THREADS, 0, stream>>>(diff, out, n, steps, h, w, L, lp);
  return launch_status();
}

// out[b] = SATD of the b-th h x w block of diff, for b < n; every out[b] is
// written (0 for an empty block).
VTM_API int vtm_satd_batch(const int* diff, int* out, long long n, int h, int w,
                           void* stream) {
  if (n <= 0) return 0;
  if (h < 0 || w < 0 || (long long)h * w > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (satd_kind(h, w)) {
    case SATD_8x16: return launch_satd<SATD_8x16>(diff, out, n, h, w, st);
    case SATD_16x8: return launch_satd<SATD_16x8>(diff, out, n, h, w, st);
    case SATD_4x8: return launch_satd<SATD_4x8>(diff, out, n, h, w, st);
    case SATD_8x4: return launch_satd<SATD_8x4>(diff, out, n, h, w, st);
    case SATD_8x8: return launch_satd<SATD_8x8>(diff, out, n, h, w, st);
    case SATD_4x4: return launch_satd<SATD_4x4>(diff, out, n, h, w, st);
    case SATD_2x2: return launch_satd<SATD_2x2>(diff, out, n, h, w, st);
    default: return launch_satd<SATD_SAD>(diff, out, n, h, w, st);
  }
}
