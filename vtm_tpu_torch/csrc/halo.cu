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
// (the delta return: three loads at most, one for most elements); a thread
// takes one output element, a warp 32 neighbours along a row, so every load
// and store of a warp is one coalesced run.  No shared memory: nothing is
// read twice.

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

__device__ __forceinline__ int at(const int* p, long long ld, long long a, long long b,
                                  bool split_cols) {
  return split_cols ? p[b * ld + a] : p[a * ld + b];
}

// grid: (output columns / 32, output rows / 8, lanes); block 32 x 8.
__global__ void halo_gather_kernel(const __grid_constant__ HaloTable t, int across,
                                   int h, int pad, int split_cols) {
  const HaloLane& L = t.lane[blockIdx.z];
  const long long len = L.len;
  const long long along_out = len + 2 * h, across_out = across + 2 * pad;
  const long long rows = split_cols ? across_out : along_out;
  const long long cols = split_cols ? along_out : across_out;
  const long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows || c >= cols) return;
  const bool sc = split_cols != 0;
  const long long a = (sc ? c : r) - h;  // along, in the shard's coordinates
  long long b = (sc ? r : c) - pad;      // across, edge-replicated
  b = b < 0 ? 0 : (b >= across ? across - 1 : b);
  const long long own_ld = sc ? len : across;
  int v;
  if (a < 0) {
    v = L.nb[0] ? at(L.nb[0], L.nb_ld[0], L.nb_off[0] + h + a, b, sc)
                : at(L.src, own_ld, 0, b, sc);
  } else if (a >= len) {
    v = L.nb[1] ? at(L.nb[1], L.nb_ld[1], L.nb_off[1] + a - len, b, sc)
                : at(L.src, own_ld, len - 1, b, sc);
  } else {
    v = at(L.src, own_ld, a, b, sc);
  }
  L.dst[r * cols + c] = v;
}

// grid: (columns / 32, rows / 8, lanes); block 32 x 8.
__global__ void halo_add_deltas_kernel(const __grid_constant__ DeltaTable t, int rows,
                                       int h) {
  const DeltaLane& L = t.lane[blockIdx.z];
  const long long len = L.len;
  const long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows || c >= len) return;
  // int32 sums that wrap, as torch's do
  uint32_t v = (uint32_t)L.x[r * len + c] + (uint32_t)L.d[r * (len + 2 * h) + h + c];
  if (L.nb[0] && c < h) v += (uint32_t)L.nb[0][r * L.nb_ld[0] + L.nb_off[0] + c];
  if (L.nb[1] && c >= len - h)
    v += (uint32_t)L.nb[1][r * L.nb_ld[1] + L.nb_off[1] + c - (len - h)];
  L.out[r * len + c] = (int)v;
}

// `table`: n_lanes HaloLane records (host memory).  Each lane's dst is
// written whole.  Returns cudaErrorInvalidValue for a bad table.
VTM_API int vtm_halo_gather(const void* table, int n_lanes, int across, int h, int pad,
                            int split_cols, cudaStream_t stream) {
  if (n_lanes < 1 || n_lanes > HALO_MAX_LANES || across < 1 || h < 1 || pad < 0)
    return (int)cudaErrorInvalidValue;
  HaloTable t;
  memcpy(t.lane, table, sizeof(HaloLane) * n_lanes);
  long long max_len = 0;
  for (int i = 0; i < n_lanes; ++i) {
    const HaloLane& L = t.lane[i];
    if (L.len < 1 || !L.src || !L.dst) return (int)cudaErrorInvalidValue;
    for (int s = 0; s < 2; ++s)
      if (L.nb[s] && (L.nb_off[s] < 0 || L.nb_ld[s] < 1)) return (int)cudaErrorInvalidValue;
    max_len = L.len > max_len ? L.len : max_len;
  }
  const long long along = max_len + 2 * h, acr = (long long)across + 2 * pad;
  const long long rows = split_cols ? acr : along, cols = split_cols ? along : acr;
  if (rows > 65535LL * 8) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((unsigned)((cols + 31) / 32), (unsigned)((rows + 7) / 8),
                  (unsigned)n_lanes);
  halo_gather_kernel<<<grid, block, 0, stream>>>(t, across, h, pad, split_cols);
  return launch_status();
}

// `table`: n_lanes DeltaLane records (host memory); every lane has `rows`
// rows and len >= h columns.
VTM_API int vtm_halo_add_deltas(const void* table, int n_lanes, int rows, int h,
                                cudaStream_t stream) {
  if (n_lanes < 1 || n_lanes > HALO_MAX_LANES || rows < 1 || h < 1)
    return (int)cudaErrorInvalidValue;
  if (rows > 65535 * 8) return (int)cudaErrorInvalidValue;
  DeltaTable t;
  memcpy(t.lane, table, sizeof(DeltaLane) * n_lanes);
  long long max_len = 0;
  for (int i = 0; i < n_lanes; ++i) {
    const DeltaLane& L = t.lane[i];
    if (L.len < h || !L.x || !L.d || !L.out) return (int)cudaErrorInvalidValue;
    max_len = L.len > max_len ? L.len : max_len;
  }
  const dim3 block(32, 8);
  const dim3 grid((unsigned)((max_len + 31) / 32), (unsigned)((rows + 7) / 8),
                  (unsigned)n_lanes);
  halo_add_deltas_kernel<<<grid, block, 0, stream>>>(t, rows, h);
  return launch_status();
}
