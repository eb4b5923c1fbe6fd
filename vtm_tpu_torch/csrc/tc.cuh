// Int8 tensor-core products and asynchronous copies as inline PTX for sm_90a
// (transform.cu's vtm_inv_transform_s8).  The CPU emulation of the CUDA
// sources builds a twin of this header instead (tests/_emu/tc.cuh).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define VTM_MMA_K32(AT, BT)                                                       \
  asm("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT ".s32 "                  \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"         \
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))

// c += A B on one m16n8k32 tile: A (16 x 32) row-major, B (32 x 8)
// column-major, four 8-bit values to a 32-bit word (the lowest k in the low
// byte), int32 sums.  A_S / B_S: the operand's bytes are signed (.s8), else
// unsigned (.u8).  Lane (g, t) = (lane >> 2, lane & 3) holds, as the PTX
// ISA's fragment tables for mma.m16n8k32 with .s8 / .u8 give them:
//   a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..], a[2] = A[g][16+4t..],
//   a[3] = A[g+8][16+4t..]; b[0] = B[4t..4t+3][g], b[1] = B[16+4t..][g];
//   c[0], c[1] = C[g][2t], C[g][2t+1]; c[2], c[3] = C[g+8][2t], C[g+8][2t+1].
template <bool A_S, bool B_S>
__device__ __forceinline__ void mma_k32(int (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  if constexpr (A_S && B_S) VTM_MMA_K32("s8", "s8");
  else if constexpr (A_S) VTM_MMA_K32("s8", "u8");
  else if constexpr (B_S) VTM_MMA_K32("u8", "s8");
  else VTM_MMA_K32("u8", "u8");
}

#undef VTM_MMA_K32

// BYTES (4, 8 or 16) from global to shared memory, both BYTES-aligned,
// without registers; complete after cp_async_wait of its group.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES)
                 : "memory");
}

// Closes the group of this thread's cp_async calls since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
