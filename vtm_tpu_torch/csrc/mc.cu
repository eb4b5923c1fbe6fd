// Tile motion compensation of a slice (translational MC, uni and bi).
//
// Replaces vtm_tpu/ops/mc_kernel.py:mc_tiles (and its pair form
// _mc_tiles_pair, which the wrapper builds from two calls into one
// output).  One thread per output sample of a tile (4x4 luma, 2x2 chroma):
// the two-pass FIR of fir.cuh over the tile's window, rows and columns
// clamped to its reference plane, then the branch-free final stage of the
// jax kernel (the four VTM filter paths in one form, see
// vtm_tpu_torch/ops/mc_kernel.py):
//   inter = acc >> 6                                    (bi: 14-bit)
//   r_v   = clip((acc + (1 << (5 + hr)) + (IF_OFFS << 6)) >> (6 + hr))
//   r_c   = clip((inter + IF_OFFS + (1 << (hr - 1))) >> hr)
//   out   = rnd ? (fy_nz ? r_v : r_c) : inter
// The reference planes come as a device table of pointers, one per plane
// (all planes of a class share H and W), so the decoder's DPB planes are
// read where they lie, without stacking them for every slice.
//
// Bound on the H100: at 1080p a tile reads an 11x11 (luma) or 5x5 (chroma)
// window mostly from L1/L2 (neighbouring tiles overlap) and does 64 or 16
// multiply-adds per sample for 4 bytes out; the per-tile job data (r, x0,
// y0, 2 x taps coefficients, 2 flags) is read by every thread of the tile.
// Launch and job upload, not the card, set the time at the decoder's
// batch sizes.

#include "fir.cuh"

template <int TAPS>
__global__ void mc_tiles_kernel(const int* const* __restrict__ planes, int R,
                                int H, int W, const int* __restrict__ r_idx,
                                const int* __restrict__ x0,
                                const int* __restrict__ y0,
                                const int* __restrict__ cH,
                                const int* __restrict__ cV,
                                const uint8_t* __restrict__ fy_nz,
                                const uint8_t* __restrict__ rnd, int n,
                                int tile, int bd, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int tt = tile * tile;
  if (i >= (long long)n * tt) return;
  const int j = (int)(i / tt);
  const int s = (int)(i % tt);
  const int ty = s / tile, tx = s % tile;
  const int hr = max(2, IF_INTERNAL_PREC - bd);
  const int maxv = (1 << bd) - 1;
  const int* plane = planes[clampi(r_idx[j], R)];
  const int acc = fir_acc<TAPS>(plane, H, W, x0[j] + tx, y0[j] + ty,
                                cH + (long long)j * TAPS,
                                cV + (long long)j * TAPS, 6 - hr);
  const int inter = acc >> 6;
  int v = inter;
  if (rnd[j]) {
    if (fy_nz[j]) {
      const int shl = 6 + hr;
      const uint32_t offl = (1u << (shl - 1)) + ((uint32_t)IF_OFFS << 6);
      v = clip3(0, maxv, (int)((uint32_t)acc + offl) >> shl);
    } else {
      const uint32_t offc = (uint32_t)IF_OFFS + (1u << (hr - 1));
      v = clip3(0, maxv, (int)((uint32_t)inter + offc) >> hr);
    }
  }
  out[i] = v;
}

VTM_API int vtm_mc_tiles(const int* const* planes, int R, int H, int W,
                         const int* r_idx, const int* x0, const int* y0,
                         const int* cH, const int* cV, const uint8_t* fy_nz,
                         const uint8_t* rnd, int n, int taps, int tile, int bd,
                         int* out, void* stream) {
  if (n == 0) return 0;
  const long long total = (long long)n * tile * tile;
  const int block = 256;
  const dim3 grid((unsigned)((total + block - 1) / block));
  cudaStream_t st = (cudaStream_t)stream;
  if (taps == 8) {
    mc_tiles_kernel<8><<<grid, block, 0, st>>>(planes, R, H, W, r_idx, x0, y0,
                                               cH, cV, fy_nz, rnd, n, tile, bd,
                                               out);
  } else if (taps == 4) {
    mc_tiles_kernel<4><<<grid, block, 0, st>>>(planes, R, H, W, r_idx, x0, y0,
                                               cH, cV, fy_nz, rnd, n, tile, bd,
                                               out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return launch_status();
}
