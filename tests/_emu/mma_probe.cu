// Test support: one m16n8k32 product through tc.cuh's mma_k32 (in the
// emulated build, its twin), D = A B + C, with A (16 x 32) and B (32 x 8)
// row-major bytes and C, D (16 x 8) row-major int32.  Each lane forms its
// fragment words from the matrices by the PTX ISA's tables, as a kernel
// does, so the product can be held to one computed another way.

#include "common.cuh"
#include "tc.cuh"

template <bool A_S, bool B_S>
__global__ void mma_probe_kernel(const uint8_t* A, const uint8_t* B, const int* C, int* D) {
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  uint32_t a[4], b[2];
  for (int r = 0; r < 4; ++r) {
    const uint8_t* p = A + (g + 8 * (r & 1)) * 32 + 16 * (r >> 1) + 4 * t;
    a[r] = p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24;
  }
  for (int r = 0; r < 2; ++r) {
    const uint8_t* p = B + (16 * r + 4 * t) * 8 + g;
    b[r] = p[0] | p[8] << 8 | p[16] << 16 | (uint32_t)p[24] << 24;
  }
  int c[4];
  for (int i = 0; i < 4; ++i) c[i] = C[(g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)];
  mma_k32<A_S, B_S>(c, a, b);
  for (int i = 0; i < 4; ++i) D[(g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = c[i];
}

// a_signed / b_signed choose .s8 or .u8 for each operand
VTM_API int emu_mma_k32(const uint8_t* A, const uint8_t* B, const int* C, int* D,
                        int a_signed, int b_signed) {
  if (a_signed && b_signed) mma_probe_kernel<true, true><<<1, 32>>>(A, B, C, D);
  else if (a_signed) mma_probe_kernel<true, false><<<1, 32>>>(A, B, C, D);
  else if (b_signed) mma_probe_kernel<false, true><<<1, 32>>>(A, B, C, D);
  else mma_probe_kernel<false, false><<<1, 32>>>(A, B, C, D);
  return launch_status();
}
