// bf16 descriptor product with a row-min only (K2): the matcher's roofline
// probe.
//
// Replaces the Pallas kernel of tools/exp_matcher_roofline.py (`make(TI, TJ,
// D, semantics).run`, :36; pallas_call at :67, body :37-57). For each pair p
// it computes out[p, i] = min(3.4e38, min_j sum_d d1[p, i, d] * d2t[p, d, j])
// with bf16 products accumulated in f32. It has no norms, no masks and no
// column reductions: it is the matcher's product with the cheapest selection,
// so its rate is the rate that K1's product (csrc/streaming_top2.cu) should
// reach, and the product core it is built from is csrc/mma_core.cuh.
//
// Bound on an H100: 2 P N^2 D operations against 2 P N D bf16 inputs and one
// [P, N] f32 output. At N = 4096, D >= 128 that is over 1000 bf16 operations
// per byte of device memory, far above the card's ~295, so the tensor cores
// bound it, and only `wgmma` reaches their rate. What the design does about
// it:
//
//  - d1 stays resident. A block owns R = 128 rows of one pair, 64 for each of
//    its two consumer warpgroups, loads that [R, D] slab into shared memory
//    once (32 KB at D = 128, 128 KB at D = 512) and keeps it for the whole
//    walk over the columns. Only d2t streams, and each of its tiles serves
//    all R rows: 2 * 128 * 128 * 64 operations for a 16 KB stage, 128
//    operations per byte read from L2. A launch reads
//    ceil(N/R) P (R D + D ceil(N/128) 128) 2 bytes through L2: 0.277 GB at
//    P = 8, N = 4096, D = 128, and 0.554 and 1.107 GB at D = 256 and 512.
//  - d2t comes by TMA into a ring of STAGES stages of [64 deep, 128 wide],
//    each two 64 x 64 boxes under the 128-byte swizzle, with a `full` and an
//    `empty` mbarrier. One thread of the producer warp issues every load;
//    the consumers touch device memory only for the final store.
//  - The product is `wgmma` m64n128k16 with both operands in shared memory,
//    D / 16 instructions for a 64 x 128 tile; d2t's columns are contiguous,
//    so B is the transposed (MN-major) operand.
//  - The row-min is taken from the accumulator registers: a thread owns two
//    rows and 32 values of each per tile, carries two running minima across
//    the tiles and merges across its quad once, after the last tile. No f32
//    tile in shared memory and no block-wide barrier after the set-up. While
//    one warpgroup scans its accumulator the other's `wgmma` keep the tensor
//    cores busy.
//
// N and D are positive multiples of 64. When N is an odd multiple of 64 the
// last tile's upper 64 columns lie past N, TMA fills them with zeros, and
// they are left out of the minimum. A block's rows past N (N = 64) are
// computed on whatever the map returns and never written. D is at most
// MAX_DEPTH = 640, what fits beside the ring in a block's 227 KB; the launch
// refuses a larger D and the wrapper raises ValueError before it.

#include <cstdint>

#include <cuda_runtime.h>

#include "mma_core.cuh"

namespace {

using namespace mma_core;
using AL = ADepthContiguous;
using BL = BColumnsContiguous;

constexpr int CONSUMERS = 2;          // consumer warpgroups of a block
constexpr int R = CONSUMERS * MMA_M;  // rows of d1 per block
constexpr int TJ = MMA_N;             // columns of d2t per tile
constexpr int KC = 64;                // contraction chunk: one stage's depth
constexpr int STAGES = 4;
constexpr int THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr uint32_t SLAB_CHUNK_BYTES = R * ROW_BYTES;  // [R, 64] of d1: 16 KB
constexpr uint32_t RING_BYTES = STAGES * BL::STAGE_BYTES;
constexpr uint32_t BARRIER_BYTES = 128;  // 2 STAGES + 1 barriers of 8 bytes
constexpr uint32_t SMEM_LIMIT = 232448;  // what a block can use on sm_90
// Dynamic shared memory: up to 1023 bytes to reach a 1024-byte boundary, the
// ring, the slab, the barriers.
constexpr uint32_t smem_bytes(int D) {
  return 1024 + RING_BYTES + (D / KC) * SLAB_CHUNK_BYTES + BARRIER_BYTES;
}
constexpr int MAX_DEPTH =
    KC * ((SMEM_LIMIT - smem_bytes(0)) / SLAB_CHUNK_BYTES);
constexpr float BIG = 3.4e38f;
static_assert(2 * STAGES + 1 <= BARRIER_BYTES / 8, "barriers outgrow their room");
static_assert(MAX_DEPTH >= 512, "D <= 512 must be resident");

// Grid (ceil(N/R), P), THREADS threads. map_a is d1 as [P N, D], map_b is
// d2t as [P D, N], both with 64 x 64 boxes.
__global__ void __launch_bounds__(THREADS, 1)
    matmul_rowmin_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b, int N,
                         int D, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int chunks = D / KC;
  const uint32_t slab = ring + RING_BYTES;
  const uint32_t bars = slab + chunks * SLAB_CHUNK_BYTES;
  const uint32_t full = bars, empty = bars + 8 * STAGES;
  const uint32_t slab_full = bars + 16 * STAGES;

  const int p = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int tiles = (N + TJ - 1) / TJ;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);               // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // lane 0 of each consumer warp
    }
    mbar_init(slab_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // The two roles never meet again: no block-wide barrier below.
  if (wg == CONSUMERS) {
    if (threadIdx.x != CONSUMERS * 128) return;
    mbar_arrive_expect_tx(slab_full, chunks * SLAB_CHUNK_BYTES);
    for (int kc = 0; kc < chunks; ++kc)
      for (int h = 0; h < R / BOX_ROWS; ++h)
        tma_load_2d(slab + kc * SLAB_CHUNK_BYTES + h * BOX_BYTES, &map_a,
                    slab_full, kc * KC, p * N + row0 + h * BOX_ROWS);
    int s = 0;
    uint32_t parity = 1;  // a fresh barrier passes a wait on parity 1
    for (int tile = 0; tile < tiles; ++tile) {
      for (int kc = 0; kc < chunks; ++kc) {
        mbar_wait(empty + 8 * s, parity);
        mbar_arrive_expect_tx(full + 8 * s, BL::STAGE_BYTES);
        for (int h = 0; h < 2; ++h)
          tma_load_2d(ring + s * BL::STAGE_BYTES + h * BOX_BYTES, &map_b,
                      full + 8 * s, BL::c0(tile * TJ, h),
                      BL::c1(p * D, kc * KC));
        if (++s == STAGES) {
          s = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  const int t = threadIdx.x & 127;
  const bool signals = (t & 31) == 0;
  const uint32_t a0 = slab + wg * (MMA_M * ROW_BYTES);  // this warpgroup's rows
  float acc[64];  // a tile's first `wgmma` overwrites it
  float lo = BIG, hi = BIG;
  int s = 0;
  uint32_t parity = 0;
  mbar_wait(slab_full, 0);
  for (int tile = 0; tile < tiles; ++tile) {
    int prev = 0;
    for (int kc = 0; kc < chunks; ++kc) {
      mbar_wait(full + 8 * s, parity);
      const uint64_t da =
          smem_desc(a0 + kc * SLAB_CHUNK_BYTES, AL::LBO, AL::SBO);
      const uint64_t db =
          smem_desc(ring + s * BL::STAGE_BYTES, BL::LBO, BL::SBO);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / MMA_K; ++kk)
        wgmma_m64n128k16<BL::TNSP>(acc, da + ((kk * AL::K_STEP_BYTES) >> 4),
                                   db + ((kk * BL::K_STEP_BYTES) >> 4),
                                   (kc | kk) != 0);
      wgmma_commit();
      // One chunk's products stay in flight; the one before has been read.
      if (kc > 0) {
        wgmma_wait<1>();
        if (signals) mbar_arrive(empty + 8 * prev);
      }
      prev = s;
      if (++s == STAGES) {
        s = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    if (signals) mbar_arrive(empty + 8 * prev);
    acc_fence(acc);
    // Columns past N (the upper half of the last tile when N is an odd
    // multiple of 64) hold zeros and stay out of the minimum.
    if ((tile + 1) * TJ > N)
      acc_row_min<MMA_N / 16>(acc, lo, hi);
    else
      acc_row_min<MMA_N / 8>(acc, lo, hi);
  }
  lo = quad_min(lo);
  hi = quad_min(hi);
  if ((t & 3) == 0) {
    const int row = row0 + wg * MMA_M + acc_row(t, 0);
    float* o = out + static_cast<size_t>(p) * N;
    if (row < N) o[row] = lo;
    if (row + 8 < N) o[row + 8] = hi;
  }
}

}  // namespace

extern "C" {

// N must be a multiple of it (the rows of a TMA box).
int matmul_rowmin_n_multiple() { return BOX_ROWS; }

// Contraction chunk: D must be a multiple of it.
int matmul_rowmin_k_chunk() { return KC; }

// The largest D whose d1 slab fits in shared memory beside the ring.
int matmul_rowmin_max_depth() { return MAX_DEPTH; }

// Rows of d1 per block and columns of d2t per tile: with them a caller
// reckons the bytes a launch reads through L2.
int matmul_rowmin_block_rows() { return R; }
int matmul_rowmin_col_tile() { return TJ; }

// d1: [P, N, D] bf16, d2t: [P, D, N] bf16, both contiguous and 16-byte
// aligned; N and D multiples of 64, D <= MAX_DEPTH. out: [P, N] f32. Encodes
// the two tensor maps, launches on `stream` and returns the first error
// code met (0 on success; a CUDA runtime code, or 10000 + the CUresult of
// the tensor-map encoder).
int matmul_rowmin_launch(const void* d1, const void* d2t, int P, int N, int D,
                         void* out, void* stream) {
  if (D > MAX_DEPTH) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (int err = encode_bf16_rows(&map_a, d1, static_cast<uint64_t>(P) * N, D))
    return err;
  if (int err = encode_bf16_rows(&map_b, d2t, static_cast<uint64_t>(P) * D, N))
    return err;
  const uint32_t smem = smem_bytes(D);
  const cudaError_t attr = cudaFuncSetAttribute(
      matmul_rowmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + R - 1) / R, P);
  matmul_rowmin_kernel<<<grid, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, N, D, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
