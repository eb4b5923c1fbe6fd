// Halo exchanges of the multi-device path: the lanes' shards extended by
// their neighbours' edges, and the return of the deblocking's edge deltas.
//
// Replaces the reference's ppermute halos inside shard_map:
//   vtm_tpu/parallel/mesh.py:35 halo_exchange (rows, the ring's wrap at the
//     ends), vtm_tpu/parallel/pic_shard.py:37 _halo_cols (columns, the
//     picture's borders edge-replicated) with the jnp.pad(mode="edge") of
//     the other axis that follows it for SAO and ALF (pic_shard.py:112-113,
//     :121)  -> vtm_halo_gather;
//   vtm_tpu/parallel/pic_shard.py:89-95, each lane's deblocking deltas over
//     its own columns plus those its neighbours computed for its first and
//     last h columns  -> vtm_halo_add_deltas.
//
// Every lane of a card goes in one launch.  The lanes' pointers reach the
// kernel by value, as a __grid_constant__ parameter table (as McPlanes in
// mc.cu), so a lane reads its neighbours' shards where they lie.  A
// neighbour on another card is read from a strip of h columns (or rows) that
// the wrapper copied to this card first (vtm_tpu_torch/parallel/mesh.py); the
// table names that strip in the neighbour's place, with its own stride and
// offset.
//
// Bound on the H100: bytes.  Each output element is one load and one store
// (the delta return: two loads, three where a neighbour's edge delta adds
// in).  A launch of many elements (the 1080p chain's eight 240-column
// shards, the ring, the live mesh's 960-column shards) takes the row
// kernels:
//   * a warp owns a whole output row (a grid-stride loop over the rows of
//     one lane: blockIdx.y is the lane, so a CTA reads only its own record,
//     and the grid is capped at the CTAs the card holds at once);
//   * the row's middle (the lane's own len, or across for a row of the
//     ring) moves as 16-byte chunks: each lane loads aligned int4s of the
//     source (read-only path), and where source and destination sit at
//     different word offsets inside 16 bytes (h or pad odd, a row stride
//     that is not a multiple of 4, a base pointer at a storage offset or a
//     strip) takes the words it lacks from the next lane with __shfl_sync,
//     so that every store of a whole destination chunk is an aligned int4;
//     a chunk that the row shares with its halo or with the rows before
//     and after it takes scalar stores of its middle elements;
//   * the halo elements of a row (2h of them, or 2 pad edge replicas; for
//     the delta return the columns with a neighbour's delta) go one a lane:
//     loaded before the row's chunks and stored after them, so no lane
//     waits on them between its loads and its chunk stores;
//   * each lane has all its loads of a pass in flight (HALO_UNROLL chunks, two of
//     each stream for the delta return) before its first store;
//   * the table entry and the row's pointers are resolved once a row, in
//     32-bit index arithmetic: the C entries refuse a lane whose extents
//     do not fit in an int.
// A launch of few elements (the live mesh's 104- and 208-column shards:
// HALO_ELEM_MAX) cannot fill the card, and there a warp's path through one
// row (pointers, alignment, realign, halo, partial stores) is the launch's
// time; it takes the element kernels, a thread an element, whose path is
// one load and one store.  No shared memory, no second launch, no memset.

#include <climits>
#include <cstring>

#include "common.cuh"

constexpr int HALO_MAX_LANES = 32;

// One lane of vtm_halo_gather, every field 8 bytes (the wrapper packs the
// table as 64-bit words).  "Along" is the split axis (columns when
// split_cols, else rows); a source element (a along, b across) of a source
// with row stride ld lies at b * ld + a (split columns) or a * ld + b.
struct HaloLane {
  const int* src;       // the lane's shard: len along, `across` across
  int* dst;             // its extended shard: len + 2h along, across + 2 pad
  const int* nb[2];     // the halo's sources before and after the shard;
                        // nullptr: the shard's own edge element, replicated
  long long len;        // the shard's extent along the split axis
  long long nb_ld[2];   // row stride of each source, in elements
  long long nb_off[2];  // index along the split axis of its halo's first element
};
static_assert(sizeof(HaloLane) == 72, "the wrapper packs 9 words a lane");

struct HaloTable {
  HaloLane lane[HALO_MAX_LANES];
};

// One lane of vtm_halo_add_deltas (10 words).
struct DeltaLane {
  const int* x;         // the lane's shard [rows, len]
  const int* d;         // its deltas [rows, len + 2h]
  int* out;             // x + its own deltas + its neighbours' edge deltas
  const int* nb[2];     // the deltas that the lanes before and after computed
                        // for this lane's first and last h columns; nullptr: none
  long long len;
  long long nb_ld[2];
  long long nb_off[2];  // column of the first of those h deltas in each source
};
static_assert(sizeof(DeltaLane) == 80, "the wrapper packs 10 words a lane");

struct DeltaTable {
  DeltaLane lane[HALO_MAX_LANES];
};

constexpr int HALO_THREADS = 256;  // a CTA: 8 warps, a warp a row at a time
constexpr int HALO_WARPS = HALO_THREADS / 32;
constexpr int HALO_MIN_BLOCKS = 4;  // at most 64 registers a thread
constexpr int HALO_UNROLL = 2;      // 16-byte chunks a lane loads before it stores
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int word_mis(const void* p) {
  return (int)((uintptr_t)p >> 2 & 3);  // words past a 16-byte boundary
}

// A source row realigned to its destination row's 16-byte chunks:
// destination chunk q takes words 4q + t .. 4q + t + 3 of `al`, the source
// row's pointer rounded down to 16 bytes.  Words lo .. hi - 1 of `al` are
// the row's; the others are never used, and only chunks that hold one of
// the row's words are loaded (such a chunk lies in the row's allocation).
struct Src {
  const int4* al;
  int t, lo, hi;
};

// `row`'s n words are destination elements off .. off + n - 1 of a row that
// starts dmis words past a 16-byte boundary.
__device__ __forceinline__ Src src_row(const int* row, int n, int dmis, int off) {
  const int m = word_mis(row);
  return {reinterpret_cast<const int4*>(row - m), m - dmis - off, m, m + n};
}

__device__ __forceinline__ int4 chunk(const Src& s, int c, bool want) {
  return want && 4 * c + 3 >= s.lo && 4 * c < s.hi ? __ldg(s.al + c) : make_int4(0, 0, 0, 0);
}

// Loads of one pass: chunk q0 + 32u + lane of the destination's source for
// u < U, and for lane 0 the chunk after the pass (lane 31's neighbour in
// realign).
template <int U>
__device__ __forceinline__ void load_pass(const Src& s, int q0, int lane, int4 (&a)[U + 1]) {
  const int cb = s.t >> 2;
#pragma unroll
  for (int u = 0; u < U; ++u) a[u] = chunk(s, q0 + 32 * u + lane + cb, true);
  a[U] = chunk(s, q0 + 32 * U + cb, lane == 0);
}

// The four source words of this lane's destination chunk: words sh .. 3 of
// its own chunk `a`, then words 0 .. sh - 1 of the next lane's (lane 31:
// lane 0's `next`, the first chunk of the next 32).  sh is the same for
// the whole warp: an aligned row takes no shuffle, an offset one three, and
// selects rather than branches.
__device__ __forceinline__ int4 realign(int4 a, int4 next, int sh, int lane) {
  if (sh == 0) return a;
  const int4 v = lane == 0 ? next : a;
  const int src = (lane + 1) & 31;
  const int bx = __shfl_sync(FULL, v.x, src), by = __shfl_sync(FULL, v.y, src),
            bz = __shfl_sync(FULL, v.z, src);
  return make_int4(sh == 1 ? a.y : sh == 2 ? a.z : a.w, sh == 1 ? a.z : sh == 2 ? a.w : bx,
                   sh == 1 ? a.w : sh == 2 ? bx : by, sh == 1 ? bx : sh == 2 ? by : bz);
}

// The elements lo .. hi - 1 of destination chunk q of a row that starts
// dmis words into `al`: one aligned int4 store when the chunk lies inside
// them, else a scalar store for each of its elements that does.
__device__ __forceinline__ void store_chunk(int4* al, int q, int dmis, int lo, int hi,
                                            const int (&v)[4]) {
  const int e0 = 4 * q - dmis;
  if (e0 >= lo && e0 + 3 < hi) {
    al[q] = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
  int* row = reinterpret_cast<int*>(al) + dmis;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (e0 + i >= lo && e0 + i < hi) row[e0 + i] = v[i];
}

// One row of an extended shard, by the 32 lanes of a warp: nl elements from
// `pl` (nullptr: mid[0] repeated), the n words of `mid`, nr elements from
// `pr` (nullptr: mid[n - 1] repeated).  The halo elements go one a lane:
// loaded before the middle's chunks and stored after them, so that no lane
// waits on them ahead of its chunk stores (runs over 32 elements, an h or
// pad above 32, end the row with a loop of their own).  The chunks store
// the middle.
__device__ void gather_row(int* dst, const int* pl, const int* mid, int n, const int* pr,
                           int nl, int nr, int lane) {
  const int W = nl + n + nr, dmis = word_mis(dst);
  int4* al = reinterpret_cast<int4*>(dst - dmis);
  const int* const lsrc = pl ? pl : mid;          // left element e at lsrc[e * lstep]
  const int* const rsrc = pr ? pr : mid + n - 1;  // right element e at rsrc[e * rstep]
  const int lstep = pl ? 1 : 0, rstep = pr ? 1 : 0;
  const int x = lane < nl ? __ldg(lsrc + lane * lstep) : 0;
  const int y = lane < nr ? __ldg(rsrc + lane * rstep) : 0;
  const Src s = src_row(mid, n, dmis, nl);
  const int nq = (dmis + W + 3) >> 2, sh = s.t & 3;
  for (int q0 = 0; q0 < nq; q0 += 32 * HALO_UNROLL) {
    int4 a[HALO_UNROLL + 1];
    load_pass<HALO_UNROLL>(s, q0, lane, a);
#pragma unroll
    for (int u = 0; u < HALO_UNROLL; ++u) {
      const int qb = q0 + 32 * u;
      if (qb >= nq) break;
      const int4 w = realign(a[u], a[u + 1], sh, lane);
      const int v[4] = {w.x, w.y, w.z, w.w};
      if (qb + lane < nq) store_chunk(al, qb + lane, dmis, nl, nl + n, v);
    }
  }
  if (lane < nl) dst[lane] = x;
  if (lane < nr) dst[nl + n + lane] = y;
  for (int e = lane + 32; e < nl || e < nr; e += 32) {
    if (e < nl) dst[e] = __ldg(lsrc + e * lstep);
    if (e < nr) dst[nl + n + e] = __ldg(rsrc + e * rstep);
  }
}

// grid: (CTAs a lane, lanes); block HALO_THREADS; a warp a row at a time.
__global__ void __launch_bounds__(HALO_THREADS, HALO_MIN_BLOCKS)
halo_gather_kernel(const __grid_constant__ HaloTable t, int across, int h, int pad,
                   int split_cols) {
  const HaloLane& L = t.lane[blockIdx.y];
  const int len = (int)L.len, lane = threadIdx.x & 31;
  const int rows = split_cols ? across + 2 * pad : len + 2 * h;
  for (int r = blockIdx.x * HALO_WARPS + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * HALO_WARPS) {
    if (split_cols) {
      // row b of the shard (edge-replicated across), h columns a side
      const int b = min(max(r - pad, 0), across - 1);
      const int* pl = L.nb[0] ? L.nb[0] + (b * (int)L.nb_ld[0] + (int)L.nb_off[0]) : nullptr;
      const int* pr = L.nb[1] ? L.nb[1] + (b * (int)L.nb_ld[1] + (int)L.nb_off[1]) : nullptr;
      gather_row(L.dst + r * (len + 2 * h), pl, L.src + b * len, len, pr, h, h, lane);
    } else {
      // a whole source row: the neighbours' (or the edge row) for the h
      // halo rows a side, then `pad` edge replicas a side
      const int a = r - h;
      const int* row;
      if (a < 0)
        row = L.nb[0] ? L.nb[0] + ((int)L.nb_off[0] + h + a) * (int)L.nb_ld[0] : L.src;
      else if (a >= len)
        row = L.nb[1] ? L.nb[1] + ((int)L.nb_off[1] + a - len) * (int)L.nb_ld[1]
                      : L.src + (len - 1) * across;
      else
        row = L.src + a * across;
      gather_row(L.dst + r * (across + 2 * pad), nullptr, row, across, nullptr, pad, pad,
                 lane);
    }
  }
}

// The words of delta-row column k with its neighbours' deltas: x, d, n0's
// (k < h) and n1's (k >= n - h), 0 where there is none; `sum` adds them
// (int32 sums that wrap, as torch's do).  Loaded ahead, added once the
// row's chunks are stored.
struct Edge {
  int x, d, a, b;
  __device__ __forceinline__ int sum() const {
    return (int)((uint32_t)x + (uint32_t)d + (uint32_t)a + (uint32_t)b);
  }
};

__device__ __forceinline__ Edge edge_load(bool on, const int* x, const int* d, const int* n0,
                                          const int* n1, int n, int h, int k) {
  return {on ? __ldg(x + k) : 0, on ? __ldg(d + k) : 0,
          on && n0 && k < h ? __ldg(n0 + k) : 0,
          on && n1 && k >= n - h ? __ldg(n1 + (k - (n - h))) : 0};
}

// One row of the delta return, by the 32 lanes of a warp: out = x + d over
// n columns, plus n0[c] for c < h and n1[c - (n - h)] for c >= n - h where
// those neighbours' deltas exist (both, on a shard narrower than 2h).  The
// columns with a neighbour's delta go one a lane: loaded before the
// chunks and stored after them (h above 32: a loop of their own ends the
// row); the chunks store the others.
__device__ void delta_row(int* out, const int* x, const int* d, const int* n0, const int* n1,
                          int n, int h, int lane) {
  constexpr int U = 2;  // two chunks of x and two of d a lane before it stores
  const int dmis = word_mis(out);
  int4* al = reinterpret_cast<int4*>(out - dmis);
  const int lo = n0 ? h : 0, hi = n1 ? n - h : n;  // the chunks' columns
  // lane k: column k (n0's) and column n - h + k (n1's) unless column k
  // took it (a shard narrower than 2h)
  const int cr = n - h + lane;
  const bool left = n0 && lane < h, right = n1 && lane < h && !(n0 && cr < h);
  const Edge el = edge_load(left, x, d, n0, n1, n, h, lane);
  const Edge er = edge_load(right, x, d, n0, n1, n, h, cr);
  const Src sx = src_row(x, n, dmis, 0), sd = src_row(d, n, dmis, 0);
  const int nq = (dmis + n + 3) >> 2;
  for (int q0 = 0; q0 < nq; q0 += 32 * U) {
    int4 ax[U + 1], ad[U + 1];
    load_pass<U>(sx, q0, lane, ax);
    load_pass<U>(sd, q0, lane, ad);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int qb = q0 + 32 * u;
      if (qb >= nq) break;
      const int4 wx = realign(ax[u], ax[u + 1], sx.t & 3, lane);
      const int4 wd = realign(ad[u], ad[u + 1], sd.t & 3, lane);
      const int v[4] = {(int)((uint32_t)wx.x + (uint32_t)wd.x),
                        (int)((uint32_t)wx.y + (uint32_t)wd.y),
                        (int)((uint32_t)wx.z + (uint32_t)wd.z),
                        (int)((uint32_t)wx.w + (uint32_t)wd.w)};
      if (qb + lane < nq) store_chunk(al, qb + lane, dmis, lo, hi, v);
    }
  }
  if (left) out[lane] = el.sum();
  if (right) out[cr] = er.sum();
  for (int k = lane + 32; k < h; k += 32) {
    const int c = n - h + k;
    const bool r = n1 && !(n0 && c < h);
    const Edge ek = edge_load(n0, x, d, n0, n1, n, h, k);
    const Edge ec = edge_load(r, x, d, n0, n1, n, h, c);
    if (n0) out[k] = ek.sum();
    if (r) out[c] = ec.sum();
  }
}

// grid: (CTAs a lane, lanes); block HALO_THREADS; a warp a row at a time.
__global__ void __launch_bounds__(HALO_THREADS, HALO_MIN_BLOCKS)
halo_add_deltas_kernel(const __grid_constant__ DeltaTable t, int rows, int h) {
  const DeltaLane& L = t.lane[blockIdx.y];
  const int len = (int)L.len, lane = threadIdx.x & 31;
  for (int r = blockIdx.x * HALO_WARPS + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * HALO_WARPS) {
    const int* n0 = L.nb[0] ? L.nb[0] + (r * (int)L.nb_ld[0] + (int)L.nb_off[0]) : nullptr;
    const int* n1 = L.nb[1] ? L.nb[1] + (r * (int)L.nb_ld[1] + (int)L.nb_off[1]) : nullptr;
    delta_row(L.out + r * len, L.x + r * len, L.d + (r * (len + 2 * h) + h), n0, n1, len, h,
              lane);
  }
}

// Launches too small to fill the card: a thread an element, in 32 x 8
// tiles (grid: column tiles, row tiles, lanes).  On such a launch a warp
// takes one row, and its path (the row's pointers and alignment, the
// realign, the halo, the stores of a partial chunk) is the launch's time;
// a thread's path here is one load and one store.
constexpr int HALO_TILE_X = 32, HALO_TILE_Y = 8;

__global__ void __launch_bounds__(HALO_TILE_X * HALO_TILE_Y)
halo_gather_elem_kernel(const __grid_constant__ HaloTable t, int across, int h, int pad,
                        int split_cols) {
  const HaloLane& L = t.lane[blockIdx.z];
  const int len = (int)L.len;
  const int rows = split_cols ? across + 2 * pad : len + 2 * h;
  const int cols = split_cols ? len + 2 * h : across + 2 * pad;
  const int r = blockIdx.y * HALO_TILE_Y + threadIdx.y;
  const int c = blockIdx.x * HALO_TILE_X + threadIdx.x;
  if (r >= rows || c >= cols) return;
  const int a = (split_cols ? c : r) - h;  // along, in the shard's coordinates
  const int b = min(max((split_cols ? r : c) - pad, 0), across - 1);  // across, edge-replicated
  // the source element (a along, b across): its pointer, row stride, index along
  const int* p = L.src;
  int ld = split_cols ? len : across, i = min(max(a, 0), len - 1);
  if (a < 0 && L.nb[0]) {
    p = L.nb[0];
    ld = (int)L.nb_ld[0];
    i = (int)L.nb_off[0] + h + a;
  } else if (a >= len && L.nb[1]) {
    p = L.nb[1];
    ld = (int)L.nb_ld[1];
    i = (int)L.nb_off[1] + a - len;
  }
  L.dst[r * cols + c] = p[split_cols ? b * ld + i : i * ld + b];
}

__global__ void __launch_bounds__(HALO_TILE_X * HALO_TILE_Y)
halo_add_deltas_elem_kernel(const __grid_constant__ DeltaTable t, int rows, int h) {
  const DeltaLane& L = t.lane[blockIdx.z];
  const int len = (int)L.len;
  const int r = blockIdx.y * HALO_TILE_Y + threadIdx.y;
  const int c = blockIdx.x * HALO_TILE_X + threadIdx.x;
  if (r >= rows || c >= len) return;
  // int32 sums that wrap, as torch's do
  uint32_t v = (uint32_t)L.x[r * len + c] + (uint32_t)L.d[r * (len + 2 * h) + h + c];
  if (L.nb[0] && c < h) v += (uint32_t)L.nb[0][r * (int)L.nb_ld[0] + (int)L.nb_off[0] + c];
  if (L.nb[1] && c >= len - h)
    v += (uint32_t)L.nb[1][r * (int)L.nb_ld[1] + (int)L.nb_off[1] + c - (len - h)];
  L.out[r * len + c] = (int)v;
}

// Output elements of a launch (all its lanes) up to which the element
// kernels run: near where the two kernels meet on an H100, timed on seeded
// shards of growing size (the `halo crossover` lines of chip_smoke.py
// --versus; PERF.md).
#ifndef HALO_ELEM_MAX
#define HALO_ELEM_MAX (1 << 19)
#endif

static bool fits_int(long long v) { return v >= 0 && v <= INT_MAX; }

static bool word_aligned(const void* p) { return ((uintptr_t)p & 3) == 0; }

// CTAs a lane: enough warps for its rows, and no more than the card holds at
// once shared among the lanes (the SMs times the resident CTAs an SM, asked
// once a device).
template <class K>
static int ctas_a_lane(K kernel, int (&cache)[64], int n_lanes, long long rows) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& resident = cache[dev & 63];
  if (!resident) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, HALO_THREADS, 0);
    resident = sms * per_sm > 1 ? sms * per_sm : 1;
  }
  const long long need = (rows + HALO_WARPS - 1) / HALO_WARPS;
  const long long share = (resident + n_lanes - 1) / n_lanes;
  return (int)(need < share ? need : share);
}

// `table`: n_lanes HaloLane records (host memory).  Each lane's dst is
// written whole.  Returns cudaErrorInvalidValue for a bad table: a shard,
// an extended shard or a neighbour's extent whose element indices do not
// fit in an int, or a pointer that is not 4-byte aligned.
VTM_API int vtm_halo_gather(const void* table, int n_lanes, int across, int h, int pad,
                            int split_cols, cudaStream_t stream) {
  if (n_lanes < 1 || n_lanes > HALO_MAX_LANES || across < 1 || h < 1 || pad < 0)
    return (int)cudaErrorInvalidValue;
  HaloTable t;
  memcpy(t.lane, table, sizeof(HaloLane) * n_lanes);
  long long max_rows = 0, max_cols = 0, total = 0;
  for (int i = 0; i < n_lanes; ++i) {
    const HaloLane& L = t.lane[i];
    if (L.len < 1 || !L.src || !L.dst || !word_aligned(L.src) || !word_aligned(L.dst))
      return (int)cudaErrorInvalidValue;
    const long long along = L.len + 2LL * h, acr = across + 2LL * pad;
    if (!fits_int(along) || !fits_int(acr * along)) return (int)cudaErrorInvalidValue;
    for (int s = 0; s < 2; ++s) {
      if (!L.nb[s]) continue;
      if (L.nb_off[s] < 0 || L.nb_ld[s] < 1 || !word_aligned(L.nb[s]))
        return (int)cudaErrorInvalidValue;
      // the last element read: h columns of `across` rows, or h rows
      const long long last = split_cols
          ? (across - 1LL) * L.nb_ld[s] + L.nb_off[s] + h
          : (L.nb_off[s] + h - 1) * L.nb_ld[s] + across;
      if (L.nb_ld[s] > INT_MAX || L.nb_off[s] > INT_MAX || !fits_int(last))
        return (int)cudaErrorInvalidValue;
    }
    const long long rows = split_cols ? acr : along, cols = split_cols ? along : acr;
    max_rows = rows > max_rows ? rows : max_rows;
    max_cols = cols > max_cols ? cols : max_cols;
    total += rows * cols;
  }
  if (total <= HALO_ELEM_MAX) {
    const dim3 grid((unsigned)((max_cols + HALO_TILE_X - 1) / HALO_TILE_X),
                    (unsigned)((max_rows + HALO_TILE_Y - 1) / HALO_TILE_Y), (unsigned)n_lanes);
    halo_gather_elem_kernel<<<grid, dim3(HALO_TILE_X, HALO_TILE_Y), 0, stream>>>(
        t, across, h, pad, split_cols);
  } else {
    static int resident[64];
    const dim3 grid((unsigned)ctas_a_lane(halo_gather_kernel, resident, n_lanes, max_rows),
                    (unsigned)n_lanes);
    halo_gather_kernel<<<grid, HALO_THREADS, 0, stream>>>(t, across, h, pad, split_cols);
  }
  return launch_status();
}

// `table`: n_lanes DeltaLane records (host memory); every lane has `rows`
// rows and len >= h columns.  Refused like vtm_halo_gather's.
VTM_API int vtm_halo_add_deltas(const void* table, int n_lanes, int rows, int h,
                                cudaStream_t stream) {
  if (n_lanes < 1 || n_lanes > HALO_MAX_LANES || rows < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  DeltaTable t;
  memcpy(t.lane, table, sizeof(DeltaLane) * n_lanes);
  long long max_len = 0, total = 0;
  for (int i = 0; i < n_lanes; ++i) {
    const DeltaLane& L = t.lane[i];
    if (L.len < h || !L.x || !L.d || !L.out || !word_aligned(L.x) || !word_aligned(L.d) ||
        !word_aligned(L.out) || !fits_int(rows * (L.len + 2LL * h)))
      return (int)cudaErrorInvalidValue;
    for (int s = 0; s < 2; ++s) {
      if (!L.nb[s]) continue;
      if (L.nb_off[s] < 0 || L.nb_ld[s] < 1 || L.nb_ld[s] > INT_MAX ||
          L.nb_off[s] > INT_MAX || !word_aligned(L.nb[s]) ||
          !fits_int((rows - 1LL) * L.nb_ld[s] + L.nb_off[s] + h))
        return (int)cudaErrorInvalidValue;
    }
    max_len = L.len > max_len ? L.len : max_len;
    total += rows * L.len;
  }
  if (total <= HALO_ELEM_MAX) {
    const dim3 grid((unsigned)((max_len + HALO_TILE_X - 1) / HALO_TILE_X),
                    (unsigned)((rows + HALO_TILE_Y - 1) / HALO_TILE_Y), (unsigned)n_lanes);
    halo_add_deltas_elem_kernel<<<grid, dim3(HALO_TILE_X, HALO_TILE_Y), 0, stream>>>(t, rows, h);
  } else {
    static int resident[64];
    const dim3 grid((unsigned)ctas_a_lane(halo_add_deltas_kernel, resident, n_lanes, rows),
                    (unsigned)n_lanes);
    halo_add_deltas_kernel<<<grid, HALO_THREADS, 0, stream>>>(t, rows, h);
  }
  return launch_status();
}

// The launch shape of the four kernels on the current card, five ints each
// (threads, static shared bytes, registers, resident CTAs an SM, local
// bytes): halo_gather_kernel, halo_add_deltas_kernel, then the element
// kernels halo_gather_elem_kernel and halo_add_deltas_elem_kernel.
template <class K>
static int halo_kernel_config(K kernel, int threads, int* o) {
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, (const void*)kernel);
  if (e) return e;
  int blocks = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  if (e) return e;
  o[0] = threads;
  o[1] = (int)a.sharedSizeBytes;
  o[2] = a.numRegs;
  o[3] = blocks;
  o[4] = (int)a.localSizeBytes;
  return 0;
}

VTM_API int vtm_halo_config(int* o) {
  constexpr int tile = HALO_TILE_X * HALO_TILE_Y;
  int e = halo_kernel_config(halo_gather_kernel, HALO_THREADS, o);
  if (!e) e = halo_kernel_config(halo_add_deltas_kernel, HALO_THREADS, o + 5);
  if (!e) e = halo_kernel_config(halo_gather_elem_kernel, tile, o + 10);
  if (!e) e = halo_kernel_config(halo_add_deltas_elem_kernel, tile, o + 15);
  return e;
}
