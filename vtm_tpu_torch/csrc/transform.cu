// Batched two-stage inverse transform (DCT2 / DST7 / DCT8) of (B, H, W) int32
// coefficient blocks.
//
// Replaces vtm_tpu/ops/transform.py:inv_transform_batch (L131) with
// `vtm_inv_transform` and inv_transform_batch_mxu (L152) with
// `vtm_inv_transform_s8`.  Both compute, per block,
//   tmp = clip16((Tv^T c + 64) >> 7),  out = clip16((tmp Th + rnd) >> (20 - bd))
// with Tv (H x H) and Th (W x W) the inverse basis matrices of rom.tr_matrix.
// Magnitudes: |c| <= 32768 and |t| <= 91 over at most 64 terms, so every sum
// stays below 2^28 and no int32 product or accumulation wraps.
//
// `vtm_inv_transform` dispatches by shape.  Square N x N blocks, N in
// {8, 16, 32, 64}, with every pointer 16-byte aligned, take
// `inv_transform_tile_kernel<N>`: a persistent grid (as many CTAs of 256
// threads as the card keeps resident, or fewer), each CTA loading both
// basis matrices into shared memory once and then walking groups of
// G = 256 / (N/4)^2 blocks (64, 16, 4, 1).  A thread owns one 4 x 4 tile of
// one block's output in each stage: per k, one 16-byte shared load of four
// matrix values and one of four data values feed 16 int32 multiply-adds.
// Stage 1 stores its tiles transposed, so stage 2 reads tmp's columns as
// 16-byte rows; in shared memory a block of 8 (16) points is followed by
// 8 (16) spare words, so a warp's loads from several blocks spread over the
// banks.  Coefficients
// come in with 16-byte loads, the next group's held in registers while the
// current one computes; outputs leave as 16-byte stores.  Every other shape
// or alignment takes `inv_transform_kernel`: one CUDA block per group of G
// coefficient blocks (G * H * W about 1024 samples, at least one block),
// both basis matrices and the group's coefficients in shared memory, the
// stage-1 result too, and every thread forming whole output samples.
//
// `vtm_inv_transform_s8`: the same function on the int8 tensor cores, as the
// reference ran it on the TPU's matrix unit.  An int16 operand x splits into
// hi = (x - (x & 255)) >> 8 and lo - 128 = (x & 255) - 128, both int8; a
// stage is two int8 x int8 -> int32 products, hi * 256 + lo, plus the
// correction 128 * sum_k t[k].  Each product is tiled into
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 tiles (A 16x32 row-major,
// B 32x8 stored n-major so each thread's four k-consecutive bytes are one
// 32-bit word), operands zero-padded in shared memory to the tile sizes:
//   stage 1: D[y, g*W + x] = sum_k Tv[k, y] * c[g][k, x]  (A = Tv^T, B = c)
//   stage 2: D[g*H + y, x] = sum_k tmp[g][y, k] * Th[k, x] (A = tmp, B = Th)
//
// `vtm_recon_sse` is the per-lane epilogue of the sharded reconstruction
// step (vtm_tpu/parallel/mesh.py:sharded_recon_step, L78-84): recon =
// clip(pred + resid, 0, 255) as int16, and the lane's exact int64 sum of
// (recon - orig)^2 (a block reduction, then one integer atomic per block).
//
// Bound on the H100 at 1080p sizes: the int32 kernel does H + W multiply-adds
// per sample, so at 32 and 64 points it is bound by integer throughput, at 4
// points by memory (8 bytes a sample); the int8 products are far below the
// tensor cores' rate, so the s8 kernel is bound by memory and by the padding
// of small blocks to whole tiles.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kS8Threads = 128;

__device__ __forceinline__ int clip16(int v) { return clip3(-32768, 32767, v); }

static int set_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

static int group_size(int H, int W, int target) {
  const int g = target / (H * W);
  return g > 1 ? g : 1;
}

__global__ void inv_transform_kernel(const int* __restrict__ coeff,
                                     int* __restrict__ out,
                                     const int* __restrict__ tv,
                                     const int* __restrict__ th, long long B,
                                     int H, int W, int G, int shift2) {
  extern __shared__ int smem[];
  int* stv = smem;               // H x H
  int* sth = stv + H * H;        // W x W
  int* sc = sth + W * W;         // G x H x W
  int* stmp = sc + G * H * W;    // G x H x W
  const long long blk0 = (long long)blockIdx.x * G;
  const int n = (int)min((long long)G, B - blk0);
  const int hw = H * W;
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) stv[i] = tv[i];
  for (int i = threadIdx.x; i < W * W; i += blockDim.x) sth[i] = th[i];
  const int* src = coeff + blk0 * hw;
  for (int i = threadIdx.x; i < n * hw; i += blockDim.x) sc[i] = src[i];
  __syncthreads();
  // stage 1, vertical: tmp[g][y][x] = sum_k tv[k][y] * c[g][k][x]
  for (int i = threadIdx.x; i < n * hw; i += blockDim.x) {
    const int g = i / hw, y = (i - g * hw) / W, x = i % W;
    const int* cg = sc + g * hw + x;
    int acc = 0;
    for (int k = 0; k < H; ++k) acc += stv[k * H + y] * cg[k * W];
    stmp[i] = clip16((acc + 64) >> 7);
  }
  __syncthreads();
  // stage 2, horizontal: out[g][y][x] = sum_k tmp[g][y][k] * th[k][x]
  const int rnd = 1 << (shift2 - 1);
  int* dst = out + blk0 * hw;
  for (int i = threadIdx.x; i < n * hw; i += blockDim.x) {
    const int x = i % W;
    const int* row = stmp + (i - x);
    int acc = 0;
    for (int k = 0; k < W; ++k) acc += row[k] * sth[k * W + x];
    dst[i] = clip16((acc + rnd) >> shift2);
  }
}

// ---- square blocks in register tiles ---------------------------------------

template <int N>
struct TileShape {
  static constexpr int kSide = N / 4;                    // 4 x 4 tiles a side
  static constexpr int kG = kThreads / (kSide * kSide);  // blocks a group
  static constexpr int kStride = N * N + (N == 8 ? 8 : N == 16 ? 16 : 0);
  static constexpr int kQuads = N * N / 4;               // int4s a block
  static constexpr int kLoads = kG * kQuads / kThreads;  // int4s a thread a group
  static constexpr int kWords = 2 * N * N + 2 * kG * kStride;  // shared words
};

// acc[i][j] += sum_k a[k][y0 + i] * b[k][x0 + j] over rows of N words.
template <int N>
__device__ __forceinline__ void tile_mac(const int* a, const int* b, int acc[4][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int4 u = *reinterpret_cast<const int4*>(a + k * N);
    const int4 v = *reinterpret_cast<const int4*>(b + k * N);
    const int ua[4] = {u.x, u.y, u.z, u.w}, vb[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += ua[i] * vb[j];
  }
}

// Group gi's coefficients, this thread's share (int4 q = tid + e * 256),
// into registers.
template <int N>
__device__ __forceinline__ void load_group(const int4* __restrict__ coeff, long long B,
                                           long long gi, int4 (&next)[TileShape<N>::kLoads]) {
  using S = TileShape<N>;
  const long long quads = min((long long)S::kG, B - gi * S::kG) * S::kQuads;
  const int4* src = coeff + gi * S::kG * S::kQuads;
#pragma unroll
  for (int e = 0; e < S::kLoads; ++e) {
    const int q = threadIdx.x + e * kThreads;
    if (q < quads) next[e] = src[q];
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    inv_transform_tile_kernel(const int4* __restrict__ coeff, int4* __restrict__ out,
                              const int4* __restrict__ tv, const int4* __restrict__ th,
                              long long B, int shift2) {
  using S = TileShape<N>;
  extern __shared__ int smem[];
  int* stv = smem;                  // N x N: stv[k * N + y] = Tv[k][y]
  int* sth = stv + N * N;           // N x N: sth[k * N + x] = Th[k][x]
  int* sc = sth + N * N;            // G blocks, S::kStride apart
  int* stt = sc + S::kG * S::kStride;  // tmp transposed: stt[x * N + y]
  const int tid = threadIdx.x;
  for (int q = tid; q < N * N / 4; q += kThreads) {
    reinterpret_cast<int4*>(stv)[q] = tv[q];
    reinterpret_cast<int4*>(sth)[q] = th[q];
  }
  const int g = tid / (S::kSide * S::kSide);
  const int r = tid % (S::kSide * S::kSide);
  const int y0 = r / S::kSide * 4, x0 = r % S::kSide * 4;
  const long long groups = (B + S::kG - 1) / S::kG;
  const int rnd = 1 << (shift2 - 1);
  int4 next[S::kLoads];
  if (blockIdx.x < groups) load_group<N>(coeff, B, blockIdx.x, next);
  for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
    const int n = (int)min((long long)S::kG, B - gi * S::kG);
#pragma unroll
    for (int e = 0; e < S::kLoads; ++e) {
      const int q = tid + e * kThreads;
      if (q < n * S::kQuads)
        reinterpret_cast<int4*>(sc + q / S::kQuads * S::kStride)[q % S::kQuads] = next[e];
    }
    __syncthreads();
    if (gi + gridDim.x < groups) load_group<N>(coeff, B, gi + gridDim.x, next);
    if (g < n) {
      // stage 1, vertical: tmp[y][x] = sum_k Tv[k][y] c[k][x]
      int acc[4][4] = {};
      tile_mac<N>(stv + y0, sc + g * S::kStride + x0, acc);
      int* t = stt + g * S::kStride;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<int4*>(t + (x0 + j) * N + y0) =
            make_int4(clip16((acc[0][j] + 64) >> 7), clip16((acc[1][j] + 64) >> 7),
                      clip16((acc[2][j] + 64) >> 7), clip16((acc[3][j] + 64) >> 7));
    }
    __syncthreads();
    if (g < n) {
      // stage 2, horizontal: out[y][x] = sum_k tmp[y][k] Th[k][x]
      int acc[4][4] = {};
      tile_mac<N>(stt + g * S::kStride + y0, sth + x0, acc);
      int4* dst = out + (gi * S::kG + g) * S::kQuads + (y0 * N + x0) / 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i * N / 4] = make_int4(
            clip16((acc[i][0] + rnd) >> shift2), clip16((acc[i][1] + rnd) >> shift2),
            clip16((acc[i][2] + rnd) >> shift2), clip16((acc[i][3] + rnd) >> shift2));
    }
  }
}

template <int N>
static int launch_tiles(const int* coeff, int* out, const int* tv, const int* th,
                        long long B, int shift2, cudaStream_t stream) {
  using S = TileShape<N>;
  const auto kernel = inv_transform_tile_kernel<N>;
  const int smem = S::kWords * (int)sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  int e = set_smem((const void*)kernel, smem);
  if (!e) e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e) return e;
  const long long groups = (B + S::kG - 1) / S::kG;
  const long long resident = sms * per_sm > 0 ? sms * per_sm : 1;
  const unsigned grid = (unsigned)(groups < resident ? groups : resident);
  kernel<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const int4*>(coeff), reinterpret_cast<int4*>(out),
      reinterpret_cast<const int4*>(tv), reinterpret_cast<const int4*>(th), B, shift2);
  return launch_status();
}

// ---- int8 tensor-core form ------------------------------------------------

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The int8 halves of an int16-range value; hi wraps as a cast to int8 does.
__device__ __forceinline__ void split_s8(int v, int8_t& hi, int8_t& lo) {
  const int l = v & 0xFF;
  hi = (int8_t)((v - l) >> 8);
  lo = (int8_t)(l - 128);
}

// One 16x8 output tile of D = A1 B + A2 B (two products sharing B, or two
// sharing A): A is [Mp x Kp] row-major (lda bytes per row), Bt is [Np x Kp]
// (B stored n-major, ldb bytes per row).  Returns the two int32 accumulators
// of this thread's four tile elements.
struct TilePair {
  int d1[4], d2[4];
};

__device__ __forceinline__ TilePair mma_tile(const int8_t* A1, const int8_t* A2,
                                             int lda, const int8_t* B1,
                                             const int8_t* B2, int ldb, int m0,
                                             int n0, int Kp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  TilePair r = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int k0 = 0; k0 < Kp; k0 += 32) {
    const int ka = k0 + t * 4;
    uint32_t a1[4], a2[4], b1[2], b2[2];
    a1[0] = ld32(A1 + (m0 + g) * lda + ka);
    a1[1] = ld32(A1 + (m0 + g + 8) * lda + ka);
    a1[2] = ld32(A1 + (m0 + g) * lda + ka + 16);
    a1[3] = ld32(A1 + (m0 + g + 8) * lda + ka + 16);
    a2[0] = ld32(A2 + (m0 + g) * lda + ka);
    a2[1] = ld32(A2 + (m0 + g + 8) * lda + ka);
    a2[2] = ld32(A2 + (m0 + g) * lda + ka + 16);
    a2[3] = ld32(A2 + (m0 + g + 8) * lda + ka + 16);
    b1[0] = ld32(B1 + (n0 + g) * ldb + ka);
    b1[1] = ld32(B1 + (n0 + g) * ldb + ka + 16);
    b2[0] = ld32(B2 + (n0 + g) * ldb + ka);
    b2[1] = ld32(B2 + (n0 + g) * ldb + ka + 16);
    mma_s8(r.d1, a1, b1);
    mma_s8(r.d2, a2, b2);
  }
  return r;
}

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct S8Layout {
  int G, Mp1, Kp1, Np1, Mp2, Kp2, Np2;
  int off_a1, off_b1h, off_b1l, off_a2h, off_a2l, off_b2, off_tmp, off_c1,
      off_c2, bytes;
};

__host__ __device__ inline S8Layout s8_layout(int H, int W, int G) {
  S8Layout L;
  L.G = G;
  L.Mp1 = round_up(H, 16);
  L.Kp1 = round_up(H, 32);
  L.Np1 = round_up(G * W, 8);
  L.Mp2 = round_up(G * H, 16);
  L.Kp2 = round_up(W, 32);
  L.Np2 = round_up(W, 8);
  int o = 0;
  L.off_a1 = o;  o += L.Mp1 * L.Kp1;
  L.off_b1h = o; o += L.Np1 * L.Kp1;
  L.off_b1l = o; o += L.Np1 * L.Kp1;
  L.off_a2h = o; o += L.Mp2 * L.Kp2;
  L.off_a2l = o; o += L.Mp2 * L.Kp2;
  L.off_b2 = o;  o += L.Np2 * L.Kp2;
  o = round_up(o, 16);
  L.off_tmp = o; o += G * H * W * 4;
  L.off_c1 = o;  o += H * 4;
  L.off_c2 = o;  o += W * 4;
  L.bytes = o;
  return L;
}

__global__ void inv_transform_s8_kernel(const int* __restrict__ coeff,
                                        int* __restrict__ out,
                                        const int* __restrict__ tv,
                                        const int* __restrict__ th, long long B,
                                        int H, int W, int G, int shift2) {
  extern __shared__ __align__(16) int8_t sm[];
  const S8Layout L = s8_layout(H, W, G);
  int8_t* A1 = sm + L.off_a1;    // Tv^T   [Mp1 x Kp1]
  int8_t* B1h = sm + L.off_b1h;  // hi(c)  [Np1 x Kp1], n = g*W + x, k = row
  int8_t* B1l = sm + L.off_b1l;  // lo(c) - 128
  int8_t* A2h = sm + L.off_a2h;  // hi(tmp) [Mp2 x Kp2], m = g*H + y, k = col
  int8_t* A2l = sm + L.off_a2l;
  int8_t* B2 = sm + L.off_b2;    // Th^T    [Np2 x Kp2]: B2[x][k] = th[k][x]
  int* tmp = reinterpret_cast<int*>(sm + L.off_tmp);  // G x H x W
  int* corr1 = reinterpret_cast<int*>(sm + L.off_c1);  // 128 * sum_k tv[k][y]
  int* corr2 = reinterpret_cast<int*>(sm + L.off_c2);  // 128 * sum_k th[k][x]
  const long long blk0 = (long long)blockIdx.x * G;
  const int n = (int)min((long long)G, B - blk0);
  const int hw = H * W;
  const int tid = threadIdx.x, nth = blockDim.x;

  for (int i = tid; i < L.off_tmp; i += nth) sm[i] = 0;
  __syncthreads();
  for (int i = tid; i < H * H; i += nth) {
    const int k = i / H, y = i % H;
    A1[y * L.Kp1 + k] = (int8_t)tv[i];
  }
  for (int i = tid; i < W * W; i += nth) {
    const int k = i / W, x = i % W;
    B2[x * L.Kp2 + k] = (int8_t)th[i];
  }
  for (int y = tid; y < H; y += nth) {
    int s = 0;
    for (int k = 0; k < H; ++k) s += tv[k * H + y];
    corr1[y] = 128 * s;
  }
  for (int x = tid; x < W; x += nth) {
    int s = 0;
    for (int k = 0; k < W; ++k) s += th[k * W + x];
    corr2[x] = 128 * s;
  }
  const int* src = coeff + blk0 * hw;
  for (int i = tid; i < n * hw; i += nth) {
    const int g = i / hw, k = (i - g * hw) / W, x = i % W;
    int8_t hi, lo;
    split_s8(src[i], hi, lo);
    B1h[(g * W + x) * L.Kp1 + k] = hi;
    B1l[(g * W + x) * L.Kp1 + k] = lo;
  }
  __syncthreads();

  const int warp = tid >> 5, nwarp = nth >> 5;
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  // stage 1: both products share A = Tv^T
  const int tiles1 = (L.Mp1 / 16) * (L.Np1 / 8);
  for (int tile = warp; tile < tiles1; tile += nwarp) {
    const int m0 = (tile / (L.Np1 / 8)) * 16, n0 = (tile % (L.Np1 / 8)) * 8;
    const TilePair r = mma_tile(A1, A1, L.Kp1, B1h, B1l, L.Kp1, m0, n0, L.Kp1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int y = m0 + gq + (e >> 1) * 8, col = n0 + tq * 2 + (e & 1);
      if (y < H && col < n * W) {
        const int g = col / W, x = col % W;
        const int acc = r.d1[e] * 256 + r.d2[e] + corr1[y];
        tmp[g * hw + y * W + x] = clip16((acc + 64) >> 7);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n * hw; i += nth) {
    const int g = i / hw, y = (i - g * hw) / W, k = i % W;
    int8_t hi, lo;
    split_s8(tmp[i], hi, lo);
    A2h[(g * H + y) * L.Kp2 + k] = hi;
    A2l[(g * H + y) * L.Kp2 + k] = lo;
  }
  __syncthreads();
  // stage 2: both products share B = Th
  const int rnd = 1 << (shift2 - 1);
  int* dst = out + blk0 * hw;
  const int tiles2 = (L.Mp2 / 16) * (L.Np2 / 8);
  for (int tile = warp; tile < tiles2; tile += nwarp) {
    const int m0 = (tile / (L.Np2 / 8)) * 16, n0 = (tile % (L.Np2 / 8)) * 8;
    const TilePair r = mma_tile(A2h, A2l, L.Kp2, B2, B2, L.Kp2, m0, n0, L.Kp2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + gq + (e >> 1) * 8, x = n0 + tq * 2 + (e & 1);
      if (m < n * H && x < W) {
        const int acc = r.d1[e] * 256 + r.d2[e] + corr2[x];
        dst[(long long)m * W + x] = clip16((acc + rnd) >> shift2);
      }
    }
  }
}

__global__ void recon_sse_kernel(const int* __restrict__ resid,
                                 const int* __restrict__ pred,
                                 const int* __restrict__ orig,
                                 int16_t* __restrict__ recon,
                                 unsigned long long* __restrict__ sse,
                                 long long n) {
  __shared__ long long part[kThreads / 32];
  long long s = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = clip3(0, 255, pred[i] + resid[i]);
    recon[i] = (int16_t)r;
    const long long d = r - orig[i];
    s += d * d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += part[w];
    atomicAdd(sse, (unsigned long long)t);
  }
}

VTM_API int vtm_inv_transform(const int* coeff, int* out, const int* tv,
                              const int* th, long long B, int H, int W,
                              int bit_depth, void* stream) {
  if (B == 0) return 0;
  const int shift2 = 20 - bit_depth;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t ptrs = (uintptr_t)coeff | (uintptr_t)out | (uintptr_t)tv | (uintptr_t)th;
  const bool aligned = ptrs % 16 == 0;
  if (aligned && H == W) {
    switch (H) {
      case 8: return launch_tiles<8>(coeff, out, tv, th, B, shift2, st);
      case 16: return launch_tiles<16>(coeff, out, tv, th, B, shift2, st);
      case 32: return launch_tiles<32>(coeff, out, tv, th, B, shift2, st);
      case 64: return launch_tiles<64>(coeff, out, tv, th, B, shift2, st);
      default: break;
    }
  }
  const int G = group_size(H, W, 1024);
  const int smem = (H * H + W * W + 2 * G * H * W) * (int)sizeof(int);
  const int e = set_smem((const void*)inv_transform_kernel, smem);
  if (e) return e;
  const unsigned grid = (unsigned)((B + G - 1) / G);
  inv_transform_kernel<<<grid, kThreads, smem, st>>>(coeff, out, tv, th, B, H, W, G,
                                                    shift2);
  return launch_status();
}

VTM_API int vtm_inv_transform_s8(const int* coeff, int* out, const int* tv,
                                 const int* th, long long B, int H, int W,
                                 int bit_depth, void* stream) {
  if (B == 0) return 0;
  const int G = group_size(H, W, 512);
  const S8Layout L = s8_layout(H, W, G);
  const int e = set_smem((const void*)inv_transform_s8_kernel, L.bytes);
  if (e) return e;
  const unsigned grid = (unsigned)((B + G - 1) / G);
  inv_transform_s8_kernel<<<grid, kS8Threads, L.bytes, (cudaStream_t)stream>>>(
      coeff, out, tv, th, B, H, W, G, 20 - bit_depth);
  return launch_status();
}

// recon and orig as int16 / int32 of n samples; *sse (int64) is zeroed here.
VTM_API int vtm_recon_sse(const int* resid, const int* pred, const int* orig,
                          int16_t* recon, long long* sse, long long n,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(sse, 0, sizeof(long long), st);
  if (e != cudaSuccess || n == 0) return (int)e;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  recon_sse_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      resid, pred, orig, recon, reinterpret_cast<unsigned long long*>(sse), n);
  return launch_status();
}
