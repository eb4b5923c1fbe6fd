// Sample adaptive offset of one plane.
//
// Replaces vtm_tpu/ops/sao_kernel.py:sao_apply (sao_apply_ext).  One thread
// per sample: the edge class from the signs against its two neighbours in
// the CTU's direction (edge-replicated at the picture border, as jnp.pad
// "edge" does), or the band c >> (bd - 5); then the per-CTU offset gather
// offsets[ctu_map, idx], the clip and the validity mask.  Both gather indices
// are clamped as jax clamps them.
//
// Bound on the H100: memory.  Each sample moves 4 (src) + 4 (type) + 4 (ctu)
// + 1 (valid) bytes in and 4 out, about 17 bytes; the 3x3 neighbourhood and
// the offset table come from L1/L2.

#include "common.cuh"

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
  const int c = src[o];
  if (!valid[o]) {
    out[o] = c;
    return;
  }
  auto at = [&](int dy, int dx) {
    return src[(long long)clampi(y + dy, H) * W + clampi(x + dx, W)];
  };
  const int t = type_map[o];
  int idx;
  switch (t) {
    case 0: idx = sgn(c - at(0, -1)) + sgn(c - at(0, 1)) + 2; break;
    case 1: idx = sgn(c - at(-1, 0)) + sgn(c - at(1, 0)) + 2; break;
    case 2: idx = sgn(c - at(-1, -1)) + sgn(c - at(1, 1)) + 2; break;
    case 3: idx = sgn(c - at(-1, 1)) + sgn(c - at(1, -1)) + 2; break;
    default: idx = c >> band_shift; break;
  }
  const int off = offsets[clampi(ctu_map[o], n_ctu) * 32 + clampi(idx, 32)];
  out[o] = clip3(0, maxv, c + off);
}

// Message of a cudaError_t returned by any entry point of the library.
VTM_API const char* vtm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

VTM_API int vtm_sao_apply(const int* src, int* out, const int* type_map,
                          const int* ctu_map, const int* offsets,
                          const uint8_t* valid, int H, int W, int n_ctu,
                          int bit_depth, void* stream) {
  if (H == 0 || W == 0) return 0;
  const dim3 block(32, 8);
  sao_kernel<<<grid2d(W, H, block), block, 0, (cudaStream_t)stream>>>(
      src, out, type_map, ctu_map, offsets, valid, H, W, n_ctu, bit_depth - 5,
      (1 << bit_depth) - 1);
  return launch_status();
}
