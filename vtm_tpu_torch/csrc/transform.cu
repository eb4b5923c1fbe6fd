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
// reference ran it on the TPU's matrix unit.  An int16-range operand x is
// hi * 256 + lo, lo = x & 255 its low byte (unsigned) and hi its second byte
// (signed: x >> 8 wrapped to int8, as the reference's cast).  A stage is a
// hi and a lo product on mma.sync m16n8k32 (csrc/tc.cuh): s8 x s8 for hi,
// s8 x u8 (stage 1) or u8 x s8 (stage 2) for lo, summed as hi * 256 + lo,
// so no correction term:
//   stage 1: D1[m][n] = sum_K A1[m][K] B1[K][n], A1 = Tv^T, B1 = coefficients
//   stage 2: D2[m][n] = sum_k A2[m][k] B2[k][n], A2 = D1 shifted and clipped,
//            B2 = Th.
// Small blocks share tiles with no padding: rows m = (b, y) stack r = 16 / H
// blocks (H <= 16: A1 block-diagonal, K = (b, k) 16 deep, the upper 16 of
// the 32 zero), columns n = (b', x) put s = 32 / W blocks side by side (W <=
// 32: B2 block-diagonal).  A job is the KR x NC coefficients one B1 covers
// (KR = 16, 32 or 64 rows by NC = 32 or 64 columns, an instantiation each:
// six); a warp's task is 16 rows of a job.  A persistent CTA of 4 warps walks
// groups of 4,096 coefficients, each copied by 16-byte cp.async (8 or 4
// bytes for 2-wide blocks or lesser alignment) into one of two stage buffers
// while the other is computed: each job a row-major KR x NC matrix whose
// 16-byte chunks are XORed by 2 * ((K >> 2) & 3) within their 128-byte line.
// Nothing is reset: a block past the batch's end is computed from stale
// words and not stored.  Each warp holds A1's and B2's fragments in
// registers for all its tasks.  Lane (g, t) = (lane >> 2, lane & 3) builds
// B1's words from rows 4t..4t+3 of column g (one 32-bit load each, the swizzle
// putting the warp's 32 on distinct banks; bytes gathered with prmt).  Its
// stage-1 accumulators hold D1[g, g + 8][2t, 2t + 1] of each 8-column
// n-tile, so stage 2 takes k in that order: logical 4t + e of a 32-column
// chunk is column 8 (e >> 1) + 2t + (e & 1) (16 more for logical 16-31),
// B2's rows permuted to match.  Stage 1 is shifted, clipped and split in
// registers and fed to stage 2 with no trip through shared memory; lanes
// store two adjacent outputs, 8 bytes, guarded past the last block.
//
// `vtm_recon_sse` is the per-lane epilogue of the sharded reconstruction
// step (vtm_tpu/parallel/mesh.py:sharded_recon_step, L78-84): recon =
// clip(pred + resid, 0, 255) as int16, and the lane's exact int64 sum of
// (recon - orig)^2 (a block reduction, then one integer atomic per block).
//
// Bound on the H100 at 1080p sizes: the int32 kernel does H + W multiply-adds
// per sample, so at 32 and 64 points it is bound by integer throughput, at 4
// points by memory (8 bytes a sample).  The s8 kernel's tensor-core work, 4
// (H + W) operations a sample, is far below its 8 bytes a sample (a 1080p
// plane at 64 points: 0.54 us against 4.95 us at the H100 SXM's published
// 1,979 T int8 operations and 3.35 TB/s, 700 W), so memory bounds every
// size.  At 1080p a launch is about one group a CTA: a load wave, one
// group's products, the stores.  At 64 points each of the four warps reads
// the whole 64 x 64 block for its 16 rows, and blocks 64 wide run at most
// two CTAs an SM, so each CTA's second group loads under its first group's
// products.

#include "common.cuh"
#include "tc.cuh"

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

constexpr int kS8GroupWords = 4096;  // coefficients a CTA stages a step (16 KB)

// A job is KR x NC coefficients that one stage-1 operand covers: KR = 16
// rows (b, k) of r = 16 / H blocks stacked (H <= 16), or the H = 32 or 64
// rows k of one block row; NC = 32 columns (b', x) of s = 32 / W blocks side
// by side (W <= 32), or the 64 columns of W = 64.  A task, one warp's work,
// is 16 output rows of a job: KR / 16 tasks a job, 256 / NC a group.
template <int KR, int NC>
struct S8Shape {
  static constexpr int kNT = NC / 8;              // n-tiles of a task
  static constexpr int kKC1 = KR == 64 ? 2 : 1;   // stage-1 k chunks of 32
  static constexpr int kKC2 = NC / 32;            // stage-2 k chunks of 32
  static constexpr int kRegs1 = KR == 16 ? 1 : 2; // stage-1 B words a chunk
  static constexpr int kMT = KR / 16;             // tasks a job
  static constexpr int kTasksPerWarp = 256 / NC / (kS8Threads / 32);
};

// Word of logical job element (K, n) in a stage: rows of NC words, each
// 16-byte chunk XORed by 2 * ((K >> 2) & 3) within its 128-byte line, so the
// eight chunks of rows K, K + 4, K + 8, K + 12 that a fragment load touches
// fall on eight distinct bank groups.
template <int NC>
__device__ __forceinline__ int stage_word(int K, int n) {
  return K * NC + ((((n >> 2) ^ ((K >> 1) & 6))) << 2) + (n & 3);
}

// Words [w0, w0 + words) of the coefficients into `stage`, UNIT words (a
// 4 * UNIT-byte cp.async) at a time, each to its job element.
template <int KR, int NC, int UNIT>
__device__ __forceinline__ void stage_group(int* stage, const int* __restrict__ coeff,
                                            long long w0, int words, int lh, int lw,
                                            int ls, int lrs) {
  for (int o = threadIdx.x * UNIT; o < words; o += kS8Threads * UNIT) {
    const int blk = o >> (lh + lw);
    const int bj = blk & ((1 << lrs) - 1);
    const int K = ((bj >> ls) << lh) + ((o >> lw) & ((1 << lh) - 1));
    const int n = ((bj & ((1 << ls) - 1)) << lw) + (o & ((1 << lw) - 1));
    cp_async<4 * UNIT>(stage + (blk >> lrs) * (KR * NC) + stage_word<NC>(K, n),
                       coeff + w0 + o);
  }
}

// Four int16-range values -> the word of their low bytes (u8) and of their
// second bytes (s8: the int8 wrap of x >> 8); x = hi * 256 + lo.
__device__ __forceinline__ void split4(int v0, int v1, int v2, int v3, uint32_t& hi,
                                       uint32_t& lo) {
  const uint32_t p01 = __byte_perm(v0, v1, 0x5140), p23 = __byte_perm(v2, v3, 0x5140);
  lo = __byte_perm(p01, p23, 0x5410);
  hi = __byte_perm(p01, p23, 0x7632);
}

// The low bytes of m[idx[e]] (0 where !ok[e]) as one fragment word.
__device__ __forceinline__ uint32_t pack_bytes(const int* __restrict__ m, const int (&idx)[4],
                                               const bool (&ok)[4]) {
  int v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = ok[e] ? __ldg(m + idx[e]) : 0;
  return __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040), 0x5410);
}

template <int KR, int NC>
__global__ void __launch_bounds__(kS8Threads)
    inv_transform_s8_kernel(const int* __restrict__ coeff, int* __restrict__ out,
                            const int* __restrict__ tv, const int* __restrict__ th,
                            long long B, int lh, int lw, int shift2, int unit) {
  using S = S8Shape<KR, NC>;
  extern __shared__ __align__(16) int s8_stage[];  // two groups
  const int H = 1 << lh, W = 1 << lw, lhw = lh + lw;
  const int ls = (NC == 32 ? 5 : 6) - lw;            // log2 s
  const int lrs = (KR == 16 ? 4 - lh : 0) + ls;      // log2 (r * s), blocks a job
  const int lgrp = 12 - lhw;                         // log2 blocks a group
  const long long groups = (B + (1 << lgrp) - 1) >> lgrp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mt = warp % S::kMT;  // the 16-row slice of its jobs this warp takes
  if (blockIdx.x >= groups) return;

  auto stage = [&](long long gi, int* buf) {
    const long long w0 = gi * kS8GroupWords;
    const int words = (int)min((long long)kS8GroupWords, (B << lhw) - w0);
    if (unit == 4) stage_group<KR, NC, 4>(buf, coeff, w0, words, lh, lw, ls, lrs);
    else if (unit == 2) stage_group<KR, NC, 2>(buf, coeff, w0, words, lh, lw, ls, lrs);
    else stage_group<KR, NC, 1>(buf, coeff, w0, words, lh, lw, ls, lrs);
  };
  stage(blockIdx.x, s8_stage);
  cp_async_commit();

  // Stage 1's A (Tv^T, block-diagonal over the r stacked blocks when
  // KR = 16) and stage 2's B (Th, block-diagonal over the s blocks side by
  // side, its rows in the permuted k order below), once, in registers.
  uint32_t a1[S::kKC1][4], b2[S::kNT][S::kKC2][2];
#pragma unroll
  for (int q = 0; q < S::kKC1; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = g + 8 * (r & 1);
      int idx[4];
      bool ok[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int K = 32 * q + 16 * (r >> 1) + 4 * t + e;
        ok[e] = KR != 16 || (K < 16 && (K >> lh) == (m >> lh));
        idx[e] = KR == 16 ? (K & (H - 1)) * H + (m & (H - 1)) : K * H + mt * 16 + m;
      }
      a1[q][r] = pack_bytes(tv, idx, ok);
    }
  // Stage 2 takes k in the order its A words come out of stage 1's
  // accumulators: logical 16r + 4t + e of chunk q is column
  // 32q + 16r + 8(e >> 1) + 2t + (e & 1) of stage 1's output.
#pragma unroll
  for (int j = 0; j < S::kNT; ++j)
#pragma unroll
    for (int q = 0; q < S::kKC2; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = 8 * j + g;
        int idx[4];
        bool ok[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 32 * q + 16 * r + 8 * (e >> 1) + 2 * t + (e & 1);
          ok[e] = NC == 64 || (p >> lw) == (n >> lw);
          idx[e] = NC == 64 ? p * 64 + n : (p & (W - 1)) * W + (n & (W - 1));
        }
        b2[j][q][r] = pack_bytes(th, idx, ok);
      }

  const int rnd = 1 << (shift2 - 1);
  const bool out8 = ((uintptr_t)out & 7) == 0;
  int it = 0;
  for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x, ++it) {
    if (gi + gridDim.x < groups)
      stage(gi + gridDim.x, s8_stage + ((it + 1) & 1) * kS8GroupWords);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int* buf = s8_stage + (it & 1) * kS8GroupWords;
#pragma unroll 1
    for (int u = 0; u < S::kTasksPerWarp; ++u) {
      const int jb = (warp + 4 * u) / S::kMT;
      const long long blk0 = (gi << lgrp) + (jb << lrs);  // the job's first block
      if (blk0 >= B) continue;
      // stage 1: D1 = A1 B1, B1 the job's coefficients, hi and lo bytes;
      // lane (g, t) reads rows 4t + e at column g of each n-tile
      const int* js = buf + jb * (KR * NC) + 4 * t * NC + g;
      int d1[S::kNT][4];
#pragma unroll
      for (int j = 0; j < S::kNT; ++j) {
        const int* col = js + 8 * (j ^ t);
        uint32_t bh[S::kKC1][2], bl[S::kKC1][2];
#pragma unroll
        for (int q = 0; q < S::kKC1; ++q)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (r < S::kRegs1) {
              const int* v = col + (32 * q + 16 * r) * NC;
              split4(v[0], v[NC], v[2 * NC], v[3 * NC], bh[q][r], bl[q][r]);
            } else {
              bh[q][r] = bl[q][r] = 0;  // rows 16-31: zero in A1
            }
          }
        int hi[4] = {0, 0, 0, 0}, lo[4] = {64, 64, 64, 64};  // lo starts at the rounding
#pragma unroll
        for (int q = 0; q < S::kKC1; ++q) mma_k32<true, true>(hi, a1[q], bh[q]);
#pragma unroll
        for (int q = 0; q < S::kKC1; ++q) mma_k32<true, false>(lo, a1[q], bl[q]);
#pragma unroll
        for (int e = 0; e < 4; ++e) d1[j][e] = clip16((hi[e] * 256 + lo[e]) >> 7);
      }
      // stage 2's A from the accumulators: chunk q's words are n-tiles
      // 4q, 4q + 1 (k 0-15) and 4q + 2, 4q + 3 (k 16-31), rows g and g + 8
      uint32_t a2h[S::kKC2][4], a2l[S::kKC2][4];
#pragma unroll
      for (int q = 0; q < S::kKC2; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * q + 2 * (r >> 1), e = 2 * (r & 1);
          split4(d1[j][e], d1[j][e + 1], d1[j + 1][e], d1[j + 1][e + 1], a2h[q][r],
                 a2l[q][r]);
        }
      // stage 2: D2 = A2 B2, then the output rows g and g + 8 of each n-tile
      long long rb[2];
      int ry[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = g + 8 * h;
        rb[h] = blk0 + (KR == 16 ? (long long)((m >> lh) << ls) : 0);
        ry[h] = (KR == 16 ? (m & (H - 1)) : mt * 16 + m) << lw;
      }
#pragma unroll
      for (int j = 0; j < S::kNT; ++j) {
        int hi[4] = {0, 0, 0, 0}, lo[4] = {rnd, rnd, rnd, rnd};
#pragma unroll
        for (int q = 0; q < S::kKC2; ++q) mma_k32<true, true>(hi, a2h[q], b2[j][q]);
#pragma unroll
        for (int q = 0; q < S::kKC2; ++q) mma_k32<false, true>(lo, a2l[q], b2[j][q]);
        const int n = 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long blk = rb[h] + (n >> lw);
          if (blk >= B) continue;
          int* dst = out + (blk << lhw) + ry[h] + (n & (W - 1));
          const int o0 = clip16((hi[2 * h] * 256 + lo[2 * h]) >> shift2);
          const int o1 = clip16((hi[2 * h + 1] * 256 + lo[2 * h + 1]) >> shift2);
          if (out8) {
            *reinterpret_cast<int2*>(dst) = make_int2(o0, o1);
          } else {
            dst[0] = o0;
            dst[1] = o1;
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int KR, int NC>
static int launch_s8(const int* coeff, int* out, const int* tv, const int* th,
                     long long B, int lh, int lw, int shift2, int unit,
                     cudaStream_t stream) {
  const auto kernel = inv_transform_s8_kernel<KR, NC>;
  const int smem = 2 * kS8GroupWords * (int)sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  int e = set_smem((const void*)kernel, smem);
  if (!e) e = (int)cudaGetDevice(&dev);
  if (!e) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kS8Threads, smem);
  if (e) return e;
  const long long groups = ((B << (lh + lw)) + kS8GroupWords - 1) / kS8GroupWords;
  // blocks 64 wide: at most two CTAs an SM, each walking about two 1080p
  // groups, the next group's copies under this one's products
  if (NC == 64 && per_sm > 2) per_sm = 2;
  const long long resident = sms * per_sm > 0 ? sms * per_sm : 1;
  const unsigned grid = (unsigned)(groups < resident ? groups : resident);
  kernel<<<grid, kS8Threads, smem, stream>>>(coeff, out, tv, th, B, lh, lw, shift2, unit);
  return launch_status();
}

// log2 of a transform size 2-64, else -1
static int log2_size(int n) {
  for (int l = 1; l <= 6; ++l)
    if (n == 1 << l) return l;
  return -1;
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
  const int lh = log2_size(H), lw = log2_size(W), shift2 = 20 - bit_depth;
  if (lh < 0 || lw < 0) return (int)cudaErrorInvalidValue;
  // words a copy: 16 bytes, a row of a 2-wide block, or what the alignment allows
  const uintptr_t c = (uintptr_t)coeff;
  const int unit = c % 8 ? 1 : c % 16 || W == 2 ? 2 : 4;
  cudaStream_t st = (cudaStream_t)stream;
  if (H <= 16)
    return W <= 32 ? launch_s8<16, 32>(coeff, out, tv, th, B, lh, lw, shift2, unit, st)
                   : launch_s8<16, 64>(coeff, out, tv, th, B, lh, lw, shift2, unit, st);
  if (H == 32)
    return W <= 32 ? launch_s8<32, 32>(coeff, out, tv, th, B, lh, lw, shift2, unit, st)
                   : launch_s8<32, 64>(coeff, out, tv, th, B, lh, lw, shift2, unit, st);
  return W <= 32 ? launch_s8<64, 32>(coeff, out, tv, th, B, lh, lw, shift2, unit, st)
                 : launch_s8<64, 64>(coeff, out, tv, th, B, lh, lw, shift2, unit, st);
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
