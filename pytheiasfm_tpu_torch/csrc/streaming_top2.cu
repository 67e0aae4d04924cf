// Fused squared-L2 descriptor distances + both-direction top-2 (K1).
//
// Replaces the Pallas kernel `streaming_top2` of
// pytheiasfm_tpu/matching/pallas_matcher.py (:163; pallas_call at :195, body
// `_matcher_kernel` :86-157). For each pair p it takes the distances
// max(a1[i] + a2[j] - 2 sum_d d1[i, d] d2[j, d], 0), bf16 products summed in
// f32, and, without writing the [N, N] distances anywhere, the row top-2 +
// argmin (forward, into d2) and the column top-2 + argmin (reverse, into d1).
//
// Bound on an H100: 2 P N^2 D operations against 2 P N D bf16 inputs, two
// [P, N] norms and six [P, N] outputs. At N = 4096, D = 128 that is about
// 1000 operations per byte of device memory, far above the card's ~295, so
// the tensor cores bound it, and only `wgmma` reaches their rate. What the
// design does about it:
//
//  - The product is K2's (csrc/matmul_rowmin.cu) on the product core
//    csrc/mma_core.cuh: a block owns R = 128 rows of one pair, 64 for each of
//    its two consumer warpgroups, keeps that [R, D] slab in shared memory and
//    streams the other side's rows by TMA through a ring of STAGES stages of
//    [128 rows, 64 deep] (two 64 x 64 boxes under the 128-byte swizzle). d2
//    stays [P, N, D], depth contiguous, so B is `wgmma`'s plain (K-major)
//    operand (`BDepthContiguous`). One producer warp issues every load.
//  - Both directions are row top-2s. A block of direction 0 takes rows of d1
//    against columns of d2; a block of direction 1 the same with d1 and d2
//    swapped, so the column top-2 of the forward product is the row top-2 of
//    the transposed one. This doubles the tensor work (the bound stays
//    2 P N^2 D, so the kernel can reach at most half of it), but it needs no
//    reduction across the 64 rows of a warpgroup, across blocks or across
//    launches: no shuffle merge of column top-2s, no partial buffers, no
//    second kernel, no atomics, and the same bits on every launch. By
//    reckoning (PERF.md, section 6) a column merge from the registers
//    costs about as many issue slots as the second product's tensor time,
//    in more code.
//  - The row top-2 is taken from the accumulator registers. A thread owns
//    two rows and 32 columns of each 64 x 128 tile (`acc_row`); it adds the
//    norms in registers, clamps at 0, and carries (best, second, argmin) for
//    its two rows across the tiles in ascending column order, branch-free.
//    The 4 lanes of a quad merge once, after the last tile. No f32 tile in
//    shared memory and no block-wide barrier after the set-up.
//  - A tile's column norms (512 bytes) come by a bulk copy with its last
//    stage and are read from shared memory in the scan, which releases that
//    stage after it. So they take no registers: 94 a thread, two blocks an
//    SM, and one block's scan runs under the other's products.
//
// What sets the pace on the card is the scan, not the product: about 6
// operations a value on the half-rate ALU pipe (min/max, compare, select)
// against 2 multiply-adds a value on the tensor cores' side (PERF.md,
// section 6).
//
// Semantics are the TPU kernel's: the clamp comes before any comparison; the
// lowest index wins among equal minima (ascending order within a thread, the
// index as tie-break across the quad); the second best masks only the argmin
// slot, so duplicates give best2 == best1; every result is merged into the
// TPU kernel's initial (BIG, BIG, index 0) by strict `<`, so a masked row
// (BIG in its norm) comes out as (BIG, BIG, 0).
//
// Tails: the maps are 2-D over [P N, D], so a slab or tile past row N of
// pair p reads pair p + 1's rows (or zeros past the last pair). Rows past N
// are computed and never written; columns past N take an infinite norm (the
// wrapper pads each pair's norms to a whole tile with +inf) and never enter
// a top-2. So any N >= 1 works. D is a positive multiple of 64, at most
// MAX_DEPTH = 640 (the slab beside the ring in a block's 227 KB); the launch
// refuses a larger D and the wrapper raises ValueError before it.

#include <cstdint>

#include <cuda_runtime.h>

#include "mma_core.cuh"

namespace {

using namespace mma_core;
using AL = ADepthContiguous;
using BL = BDepthContiguous;

constexpr int CONSUMERS = 2;          // consumer warpgroups of a block
constexpr int R = CONSUMERS * MMA_M;  // rows per block
constexpr int TJ = MMA_N;             // columns per tile
constexpr int KC = 64;                // contraction chunk: one stage's depth
constexpr int STAGES = 4;
constexpr int THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr uint32_t SLAB_CHUNK_BYTES = R * ROW_BYTES;  // [R, 64] bf16: 16 KB
constexpr uint32_t RING_BYTES = STAGES * BL::STAGE_BYTES;
constexpr uint32_t NORM_BYTES = TJ * 4;  // a tile's column norms
constexpr uint32_t NORM_RING_BYTES = STAGES * NORM_BYTES;
constexpr uint32_t BARRIER_BYTES = 128;  // 2 STAGES + 1 barriers of 8 bytes
constexpr uint32_t SMEM_LIMIT = 232448;  // what a block can use on sm_90
// Dynamic shared memory: up to 1023 bytes to reach a 1024-byte boundary, the
// ring, the column norms beside each stage, the slab, the barriers.
constexpr uint32_t smem_bytes(int D) {
  return 1024 + RING_BYTES + NORM_RING_BYTES + (D / KC) * SLAB_CHUNK_BYTES +
         BARRIER_BYTES;
}
constexpr int MAX_DEPTH =
    KC * ((SMEM_LIMIT - smem_bytes(0)) / SLAB_CHUNK_BYTES);
constexpr float BIG = 3.4e38f;
static_assert(2 * STAGES + 1 <= BARRIER_BYTES / 8, "barriers outgrow their room");
static_assert(MAX_DEPTH >= 512, "D <= 512 must be resident");

// Each direction's norms of its rows and its three outputs; direction 0
// takes rows of d1 (norms a1) against columns of d2 (norms a2).
struct Sides {
  const float* norm[2];  // a1, a2
  float* best1[2];       // fb1, rb1
  float* best2[2];       // fb2, rb2
  int* arg[2];           // fa, ra
};

// A running (best, second best, argmin).
struct Top2 {
  float m1 = BIG, m2 = BIG;
  int a = 0;

  // Adds one value; called in ascending index order, so the first of equal
  // minima is kept and a later equal value becomes the second best.
  __device__ __forceinline__ void push(float v, int idx) {
    a = v < m1 ? idx : a;
    m2 = fminf(m2, fmaxf(m1, v));
    m1 = fminf(m1, v);
  }

  // Merges a top-2 over other indices; the lower index wins a tie.
  __device__ __forceinline__ void merge(float o1, float o2, int oa) {
    a = (o1 < m1 || (o1 == m1 && oa < a)) ? oa : a;
    m2 = fminf(fmaxf(m1, o1), fminf(m2, o2));
    m1 = fminf(m1, o1);
  }

  // Merges across the 4 lanes of a quad.
  __device__ __forceinline__ void quad_merge() {
#pragma unroll
    for (int lane = 1; lane < 4; lane <<= 1)
      merge(__shfl_xor_sync(0xffffffffu, m1, lane),
            __shfl_xor_sync(0xffffffffu, m2, lane),
            __shfl_xor_sync(0xffffffffu, a, lane));
  }
};

// The distance from a product, clamped before any comparison.
__device__ __forceinline__ float dist(float row_norm, float col_norm,
                                      float prod) {
  return fmaxf(fmaf(-2.f, prod, row_norm + col_norm), 0.f);
}

// One tile's accumulator into the thread's two rows: columns c + 8 g and
// c + 8 g + 1 for g = 0..15, whose norms are b[8 g] and b[8 g + 1].
__device__ __forceinline__ void scan_tile(const float (&d)[64],
                                          const float* b, int c, float n_lo,
                                          float n_hi, Top2& lo, Top2& hi) {
#pragma unroll
  for (int g = 0; g < MMA_N / 8; ++g) {
    const float2 n = *reinterpret_cast<const float2*>(b + 8 * g);
    const int c0 = c + 8 * g;
    lo.push(dist(n_lo, n.x, d[4 * g]), c0);
    lo.push(dist(n_lo, n.y, d[4 * g + 1]), c0 + 1);
    hi.push(dist(n_hi, n.x, d[4 * g + 2]), c0);
    hi.push(dist(n_hi, n.y, d[4 * g + 3]), c0 + 1);
  }
}

// Grid (ceil(N/R), P, 2), THREADS threads. map1 is d1 and map2 is d2, each
// as [P N, D] with 64 x 64 boxes; blockIdx.z is the direction. The norms
// are [P, ldn] with ldn a multiple of TJ, +inf past N.
__global__ void __launch_bounds__(THREADS, 1)
    streaming_top2_kernel(const __grid_constant__ CUtensorMap map1,
                          const __grid_constant__ CUtensorMap map2, int N,
                          int D, int ldn, const __grid_constant__ Sides sides) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int chunks = D / KC;
  const uint32_t norms = ring + RING_BYTES;
  const uint32_t slab = norms + NORM_RING_BYTES;
  const uint32_t bars = slab + chunks * SLAB_CHUNK_BYTES;
  const uint32_t full = bars, empty = bars + 8 * STAGES;
  const uint32_t slab_full = bars + 16 * STAGES;

  const int p = blockIdx.y;
  const int dir = blockIdx.z;
  const int base = p * N;  // pair p's first row in either map
  const int row0 = blockIdx.x * R;
  const int tiles = (N + TJ - 1) / TJ;
  const int wg = threadIdx.x >> 7;
  const float* row_norm = sides.norm[dir] + static_cast<size_t>(p) * ldn;
  const float* col_norm = sides.norm[dir ^ 1] + static_cast<size_t>(p) * ldn;

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
    const CUtensorMap* rows = dir ? &map2 : &map1;
    const CUtensorMap* cols = dir ? &map1 : &map2;
    mbar_arrive_expect_tx(slab_full, chunks * SLAB_CHUNK_BYTES);
    for (int kc = 0; kc < chunks; ++kc)
      for (int h = 0; h < R / BOX_ROWS; ++h)
        tma_load_2d(slab + kc * SLAB_CHUNK_BYTES + h * BOX_BYTES, rows,
                    slab_full, kc * KC, base + row0 + h * BOX_ROWS);
    int s = 0;
    uint32_t parity = 1;  // a fresh barrier passes a wait on parity 1
    for (int tile = 0; tile < tiles; ++tile) {
      for (int kc = 0; kc < chunks; ++kc) {
        // A tile's last stage also carries the tile's column norms.
        const bool last = kc == chunks - 1;
        mbar_wait(empty + 8 * s, parity);
        mbar_arrive_expect_tx(full + 8 * s,
                              BL::STAGE_BYTES + (last ? NORM_BYTES : 0));
        for (int h = 0; h < 2; ++h)
          tma_load_2d(ring + s * BL::STAGE_BYTES + h * BOX_BYTES, cols,
                      full + 8 * s, BL::c0(kc * KC), BL::c1(base, tile * TJ, h));
        if (last)
          bulk_load(norms + s * NORM_BYTES, col_norm + tile * TJ, NORM_BYTES,
                    full + 8 * s);
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
  // Rows past N are computed on whatever the map gives and never written.
  const int r_lo = row0 + wg * MMA_M + acc_row(t, 0), r_hi = r_lo + 8;
  const float n_lo = r_lo < N ? row_norm[r_lo] : 0.f;
  const float n_hi = r_hi < N ? row_norm[r_hi] : 0.f;
  // This thread's column norms in a stage's norm slot.
  const float* my_norms = reinterpret_cast<const float*>(
                              smem_raw + (norms - smem_u32(smem_raw))) +
                          2 * (t & 3);
  float acc[64];  // a tile's first `wgmma` overwrites it
  Top2 lo, hi;
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
    acc_fence(acc);
    // The last stage is released after the scan has read its norms.
    scan_tile(acc, my_norms + prev * TJ, tile * TJ + 2 * (t & 3), n_lo, n_hi,
              lo, hi);
    if (signals) mbar_arrive(empty + 8 * prev);
  }
  lo.quad_merge();
  hi.quad_merge();
  if ((t & 3) == 0) {
    const size_t o = static_cast<size_t>(base);
    if (r_lo < N) {
      sides.best1[dir][o + r_lo] = lo.m1;
      sides.best2[dir][o + r_lo] = lo.m2;
      sides.arg[dir][o + r_lo] = lo.a;
    }
    if (r_hi < N) {
      sides.best1[dir][o + r_hi] = hi.m1;
      sides.best2[dir][o + r_hi] = hi.m2;
      sides.arg[dir][o + r_hi] = hi.a;
    }
  }
}

}  // namespace

extern "C" {

// Contraction chunk: D must be a multiple of it.
int streaming_top2_k_chunk() { return KC; }

// The largest D whose slab fits in shared memory beside the ring.
int streaming_top2_max_depth() { return MAX_DEPTH; }

// Rows per block and columns per tile: the wrapper pads the norms to whole
// tiles and reckons L2 bytes (`streaming_matcher.padded_norms`,
// `l2_bytes_per_launch`) with the same numbers; a card test holds them equal.
int streaming_top2_block_rows() { return R; }
int streaming_top2_col_tile() { return TJ; }

// d1, d2: [P, N, D] bf16, contiguous and 16-byte aligned, D a multiple of
// KC and at most MAX_DEPTH. a1, a2: [P, ldn] f32, 16-byte aligned, ldn a
// multiple of TJ and at least N, +inf in columns N..ldn-1. Outputs fb1, fb2, rb1, rb2:
// [P, N] f32; fa, ra: [P, N] int32. Encodes the two tensor maps, launches
// on `stream` and returns the first error code met (0 on success; a CUDA
// runtime code, or 10000 + the CUresult of the tensor-map encoder).
int streaming_top2_launch(const void* d1, const void* d2, const void* a1,
                          const void* a2, int P, int N, int D, int ldn,
                          void* fb1,
                          void* fb2, void* fa, void* rb1, void* rb2, void* ra,
                          void* stream) {
  if (D > MAX_DEPTH || ldn % TJ || ldn < N)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map1, map2;
  if (int err = encode_bf16_rows(&map1, d1, static_cast<uint64_t>(P) * N, D))
    return err;
  if (int err = encode_bf16_rows(&map2, d2, static_cast<uint64_t>(P) * N, D))
    return err;
  const Sides sides = {
      {static_cast<const float*>(a1), static_cast<const float*>(a2)},
      {static_cast<float*>(fb1), static_cast<float*>(rb1)},
      {static_cast<float*>(fb2), static_cast<float*>(rb2)},
      {static_cast<int*>(fa), static_cast<int*>(ra)}};
  const uint32_t smem = smem_bytes(D);
  const cudaError_t attr = cudaFuncSetAttribute(
      streaming_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + R - 1) / R, P, 2);
  streaming_top2_kernel<<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      map1, map2, N, D, ldn, sides);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
