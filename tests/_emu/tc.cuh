// CPU twin of vtm_tpu_torch/csrc/tc.cuh for the emulation: build.py writes
// it in that header's place.
//
// mma_k32 is warp-collective, as on the card: each lane puts its fragment
// words into its exchange slot (emu_frag_slot), waits on the warp's
// barrier, forms its own four sums from every lane's words, and waits
// again.  Fragments follow the PTX ISA's tables for mma.m16n8k32 with .s8 /
// .u8 operands: lane (g, t) = (lane >> 2, lane & 3) holds A[g][4t..4t+3] in
// a[0], A[g+8][4t..] in a[1], A[g][16+4t..] in a[2], A[g+8][16+4t..] in
// a[3], B[4t..4t+3][g] in b[0], B[16+4t..][g] in b[1] (the lowest k in the
// low byte), and C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1] in c[0..3];
// sums wrap as int32.  cp_async copies at once, so the commit and the waits
// have nothing to do.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

inline int emu_byte(uint32_t w, int e, bool is_signed) {
  const uint32_t v = w >> 8 * e & 0xFF;
  return is_signed ? (int)(int8_t)v : (int)v;
}

template <bool A_S, bool B_S>
inline void mma_k32(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const unsigned base = threadIdx.x & ~31u, lane = threadIdx.x & 31;
  uint32_t* slot = emu_frag_slot[threadIdx.x];
  for (int i = 0; i < 4; ++i) slot[i] = a[i];
  slot[4] = b[0];
  slot[5] = b[1];
  __syncwarp();
  // this lane's rows g, g + 8 of A and columns 2t, 2t + 1 of B, unpacked
  const int g = lane >> 2, t = lane & 3;
  int A[2][32], B[2][32];
  for (int k = 0; k < 32; ++k) {
    const uint32_t* sa = emu_frag_slot[base + g * 4 + (k & 15) / 4];
    for (int h = 0; h < 2; ++h) {
      A[h][k] = emu_byte(sa[h + 2 * (k >> 4)], k & 3, A_S);
      const uint32_t* sb = emu_frag_slot[base + (2 * t + h) * 4 + (k & 15) / 4];
      B[h][k] = emu_byte(sb[4 + (k >> 4)], k & 3, B_S);
    }
  }
  int d[4];
  for (int i = 0; i < 4; ++i) {
    uint32_t s = (uint32_t)c[i];
    for (int k = 0; k < 32; ++k) s += (uint32_t)(A[i >> 1][k] * B[i & 1][k]);
    d[i] = (int)s;
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) c[i] = d[i];
}

template <int BYTES>
inline void cp_async(void* smem, const void* gmem) {
  memcpy(smem, gmem, BYTES);
}

inline void cp_async_commit() {}

template <int N>
inline void cp_async_wait() {}
