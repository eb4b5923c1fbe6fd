// Batched Hadamard SATD of difference blocks.
//
// Replaces vtm_tpu/ops/rdcost.py:satd_batch_jax, which ran the tile
// transforms as float32 matrix products on the TPU's matrix unit.  Here one
// thread takes one tile of one block (satd.cuh: butterflies in registers)
// and adds its normalised value to the block's sum with an integer atomic,
// so the result does not depend on the order of the additions.
//
// Bound on the H100: memory.  Each sample is read once (4 bytes) and costs
// about 2 log2(tile) adds; an 8x8 tile's 64 registers stay on chip.

#include "satd.cuh"

__global__ void satd_batch_kernel(const int* __restrict__ diff,
                                  int* __restrict__ out, long long n, int h,
                                  int w, int kind) {
  const int th = satd_tile_rows(kind), tw = satd_tile_cols(kind);
  const int ntx = w / tw, nt = (h / th) * ntx;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * nt) return;
  const long long b = i / nt;
  const int t = (int)(i - b * nt);
  const int* d = diff + b * h * w;
  const int v = satd_tile(kind, (t / ntx) * th, (t % ntx) * tw,
                          [&](int y, int x) { return d[y * w + x]; });
  atomicAdd(out + b, v);
}

VTM_API int vtm_satd_batch(const int* diff, int* out, long long n, int h,
                           int w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)n * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const int kind = satd_kind(h, w);
  const long long items =
      n * (h / satd_tile_rows(kind)) * (w / satd_tile_cols(kind));
  if (items == 0) return 0;
  const int block = 128;
  satd_batch_kernel<<<(unsigned)((items + block - 1) / block), block, 0, st>>>(
      diff, out, n, h, w, kind);
  return launch_status();
}
