// Sample adaptive offset of one plane.
//
// Replaces vtm_tpu/ops/sao_kernel.py:sao_apply (L19) and sao_apply_ext (L28).
// One thread per sample: the edge class from the signs against its two
// neighbours in the CTU's direction, or the band c >> (bd - 5); then the
// per-CTU offset gather offsets[ctu_map, idx], the clip and the validity
// mask.  Both gather indices are clamped as jax clamps them.  The two entry
// points differ only in where the neighbours come from: `vtm_sao_apply`
// clamps into the plane (edge replication at the picture border, as
// jnp.pad "edge" does), `vtm_sao_apply_ext` reads a source already
// extended by one sample on every side (a shard's halo under sharding).
//
// A thread loads its sample, validity, type and CTU index at once; an
// invalid sample (most of a picture where SAO is off) stores its sample and
// ends, a valid one then reads the two neighbours of its class (from L1:
// the CTA's other threads loaded them) and gathers its offset.  CTAs of
// 32 x 16 samples: a 1080 x 240 shard is 544 of them (1,080 of 32 x 8).
//
// Why not several samples a thread (measured on the H100; PERF.md §6 has
// the times): runs of 4 or 2 samples a thread with 16-byte loads were
// faster where no sample of a run is valid, and slower where a whole CTU
// is: a valid run's class, gather and clip are one thread's chain of
// dependent steps, so its latency grows with the samples a thread takes.
// The shards with a valid CTU took longer than with this kernel, and so
// did every shard of a picture with SAO on in half its CTUs.
//
// Bound on the H100: memory.  Each sample moves 4 (src) + 4 (type) + 4 (ctu)
// + 1 (valid) bytes in and 4 out, about 17 bytes; the 3x3 neighbourhood and
// the offset table come from L1/L2.  At shard shapes a launch's floor,
// about 2 us, is larger than the bound.

#include "common.cuh"

// EXT: `src` is (H + 2) x (W + 2), the plane with a one-sample border.
template <bool EXT>
__global__ void sao_kernel(const int* __restrict__ src, int* __restrict__ out,
                           const int* __restrict__ type_map,
                           const int* __restrict__ ctu_map,
                           const int* __restrict__ offsets,
                           const uint8_t* __restrict__ valid, int H, int W,
                           int n_ctu, int band_shift, int maxv) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long o = (long long)y * W + x;
  auto at = [&](int dy, int dx) {
    if (EXT) return src[(long long)(y + 1 + dy) * (W + 2) + (x + 1 + dx)];
    return src[(long long)clampi(y + dy, H) * W + clampi(x + dx, W)];
  };
  const int c = at(0, 0);
  const bool ok = valid[o];
  const int t = type_map[o], cu = ctu_map[o];
  if (!ok) {
    out[o] = c;
    return;
  }
  int idx;
  switch (t) {
    case 0: idx = sgn(c - at(0, -1)) + sgn(c - at(0, 1)) + 2; break;
    case 1: idx = sgn(c - at(-1, 0)) + sgn(c - at(1, 0)) + 2; break;
    case 2: idx = sgn(c - at(-1, -1)) + sgn(c - at(1, 1)) + 2; break;
    case 3: idx = sgn(c - at(-1, 1)) + sgn(c - at(1, -1)) + 2; break;
    default: idx = c >> band_shift; break;
  }
  const int off = offsets[clampi(cu, n_ctu) * 32 + clampi(idx, 32)];
  out[o] = clip3(0, maxv, c + off);
}

template <bool EXT>
static int launch_sao(const int* src, int* out, const int* type_map, const int* ctu_map,
                      const int* offsets, const uint8_t* valid, int H, int W, int n_ctu,
                      int bit_depth, cudaStream_t stream) {
  if (H == 0 || W == 0) return 0;
  const dim3 block(32, 16);
  sao_kernel<EXT><<<grid2d(W, H, block), block, 0, stream>>>(
      src, out, type_map, ctu_map, offsets, valid, H, W, n_ctu, bit_depth - 5,
      (1 << bit_depth) - 1);
  return launch_status();
}

// Message of a cudaError_t returned by any entry point of the library.
VTM_API const char* vtm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// `src`, out, the maps and `valid` are H x W.
VTM_API int vtm_sao_apply(const int* src, int* out, const int* type_map,
                          const int* ctu_map, const int* offsets,
                          const uint8_t* valid, int H, int W, int n_ctu,
                          int bit_depth, void* stream) {
  return launch_sao<false>(src, out, type_map, ctu_map, offsets, valid, H, W, n_ctu,
                           bit_depth, (cudaStream_t)stream);
}

// `pad` is (H + 2) x (W + 2); out, the maps and `valid` are H x W.
VTM_API int vtm_sao_apply_ext(const int* pad, int* out, const int* type_map,
                              const int* ctu_map, const int* offsets,
                              const uint8_t* valid, int H, int W, int n_ctu,
                              int bit_depth, void* stream) {
  return launch_sao<true>(pad, out, type_map, ctu_map, offsets, valid, H, W, n_ctu,
                          bit_depth, (cudaStream_t)stream);
}
