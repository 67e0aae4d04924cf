// Fused squared-L2 descriptor distances + both-direction top-2 (K1).
//
// Replaces the Pallas kernel `streaming_top2` of
// pytheiasfm_tpu/matching/pallas_matcher.py (pallas_call at :195, body
// `_matcher_kernel` :86-157). For each pair p it computes the distance tile
// max(a1 + a2 - 2 * d1 d2^T, 0) with bf16 products accumulated in f32 and,
// without writing the [N, N] distances anywhere, the row top-2 + argmin
// (forward, into d2) and the column top-2 + argmin (reverse, into d1).
//
// Bound on an H100: 2 P N^2 D operations against 2 P N D bf16 inputs, two
// [P, N] norms and six [P, N] outputs. At N = 4096, D = 128 that is about
// 1000 bf16 operations per byte, far above the card's ~295, so the tensor
// cores bound it. This first version is simple rather than fast: WMMA
// (mma.sync) 16x16x16 bf16 tiles from shared memory, no TMA, no wgmma, no
// pipelining; the selections run on CUDA cores from a shared f32 tile.
//
// The TPU kernel carries the column (reverse) accumulators from one row tile
// to the next because its grid runs in order on one core. Here row tiles run
// in parallel blocks, and an atomic min cannot keep the second best, so the
// reverse direction takes two passes: pass 1 writes each row tile's column
// top-2 to partial buffers [P, ceil(N/TI), N]; pass 2 merges them per column.
//
// Tie rules are those of the TPU kernel: the lowest index wins among equal
// minima, and the second best masks only the argmin slot, so duplicates give
// best2 == best1. The merge below picks the lower index on equal values,
// which is what the TPU kernel's strict `<` over ascending tiles gives, and
// makes the result independent of merge order. Every result is merged into
// the TPU kernel's initial accumulator (BIG, BIG, index 0), so rows whose
// distances are all >= BIG (masked rows carry BIG in their norm) come out
// exactly as the TPU kernel gives them.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int TI = 64;        // rows of d1 per block
constexpr int TJ = 64;        // rows of d2 (distance columns) per step
constexpr int KC = 64;        // contraction chunk, bf16 elements
constexpr int THREADS = 128;  // 4 warps; warp w owns a 32x32 quadrant
constexpr int LDK = KC + 8;   // shared row stride of the bf16 chunks
constexpr int LDS = TJ + 4;   // shared row stride of the f32 product tile
constexpr float BIG = 3.4e38f;
constexpr float INF = __builtin_huge_valf();

// Merge a partial (m1 <= m2, argmin ma) into (b1 <= b2, argmin a).
__device__ __forceinline__ void merge_top2(float& b1, float& b2, int& a,
                                           float m1, float m2, int ma) {
  const int na = (m1 < b1 || (m1 == b1 && ma < a)) ? ma : a;
  b2 = fminf(fmaxf(b1, m1), fminf(b2, m2));
  b1 = fminf(b1, m1);
  a = na;
}

// Add one value in ascending index order to a running top-2.
__device__ __forceinline__ void push_top2(float& m1, float& m2, int& a,
                                          float v, int idx) {
  if (v < m1) {
    m2 = m1;
    m1 = v;
    a = idx;
  } else if (v < m2) {
    m2 = v;
  }
}

// Merge the top-2 of the two threads of a pair (lanes 2k, 2k+1).
__device__ __forceinline__ void merge_with_partner(float& m1, float& m2,
                                                   int& a) {
  const float o1 = __shfl_xor_sync(0xffffffffu, m1, 1);
  const float o2 = __shfl_xor_sync(0xffffffffu, m2, 1);
  const int oa = __shfl_xor_sync(0xffffffffu, a, 1);
  merge_top2(m1, m2, a, o1, o2, oa);
}

// Grid (ceil(N/TI), P). Block (it, p) owns rows [it*TI, it*TI+TI) of pair p
// and walks the column tiles in ascending order.
__global__ void __launch_bounds__(THREADS)
    top2_pass1(const __nv_bfloat16* __restrict__ d1,
               const __nv_bfloat16* __restrict__ d2,
               const float* __restrict__ a1, const float* __restrict__ a2,
               int N, int D, float* __restrict__ fb1,
               float* __restrict__ fb2, int* __restrict__ fa,
               float* __restrict__ pb1, float* __restrict__ pb2,
               int* __restrict__ pa) {
  __shared__ __align__(32) __nv_bfloat16 sA[TI * LDK];
  __shared__ __align__(32) __nv_bfloat16 sB[TJ * LDK];
  __shared__ __align__(32) float sS[TI * LDS];
  __shared__ float sa1[TI];
  __shared__ float sa2[TJ];

  const int it = blockIdx.x;
  const int p = blockIdx.y;
  const int nIT = gridDim.x;
  const int row0 = it * TI;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = (warp >> 1) * 32;
  const int wc = (warp & 1) * 32;
  // Selection: each row (forward) and each column (reverse) of the tile is
  // scanned by a pair of threads, one taking the even, one the odd indices.
  const int my = tid >> 1;
  const int half = tid & 1;

  const size_t pbase = static_cast<size_t>(p) * N;
  const __nv_bfloat16* A = d1 + pbase * D;
  const __nv_bfloat16* B = d2 + pbase * D;

  if (tid < TI) {
    const int r = row0 + tid;
    sa1[tid] = r < N ? a1[pbase + r] : 0.f;
  }
  // Forward accumulator of row `my`, held by both threads of its pair.
  float fb1_r = BIG, fb2_r = BIG;
  int fa_r = 0;

  const int nJT = (N + TJ - 1) / TJ;
  for (int jt = 0; jt < nJT; ++jt) {
    const int col0 = jt * TJ;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < D; k0 += KC) {
      for (int v = tid; v < TI * (KC / 8); v += THREADS) {
        const int r = v / (KC / 8);
        const int c8 = (v % (KC / 8)) * 8;
        uint4 va = make_uint4(0u, 0u, 0u, 0u);
        uint4 vb = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < N)
          va = *reinterpret_cast<const uint4*>(
              A + static_cast<size_t>(row0 + r) * D + k0 + c8);
        if (col0 + r < N)
          vb = *reinterpret_cast<const uint4*>(
              B + static_cast<size_t>(col0 + r) * D + k0 + c8);
        *reinterpret_cast<uint4*>(sA + r * LDK + c8) = va;
        *reinterpret_cast<uint4*>(sB + r * LDK + c8) = vb;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa_frag[2];
        // d2 rows are the columns of d2^T: a column-major B operand.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            fb_frag[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa_frag[i], sA + (wr + 16 * i) * LDK + kk,
                                 LDK);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb_frag[j], sB + (wc + 16 * j) * LDK + kk,
                                 LDK);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa_frag[i], fb_frag[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sS + (wr + 16 * i) * LDS + wc + 16 * j,
                                acc[i][j], LDS, wmma::mem_row_major);
    if (tid < TJ) {
      const int c = col0 + tid;
      sa2[tid] = c < N ? a2[pbase + c] : 0.f;
    }
    __syncthreads();

    // Forward: row `my` of the tile over its columns.
    {
      float m1 = INF, m2 = INF;
      int am = INT_MAX;
      const bool row_ok = row0 + my < N;
      const float ar = sa1[my];
      for (int c = half; c < TJ; c += 2) {
        const float v = (row_ok && col0 + c < N)
                            ? fmaxf(ar + sa2[c] - 2.f * sS[my * LDS + c], 0.f)
                            : INF;
        push_top2(m1, m2, am, v, col0 + c);
      }
      merge_with_partner(m1, m2, am);
      merge_top2(fb1_r, fb2_r, fa_r, m1, m2, am);
    }
    // Reverse: column `my` of the tile over its rows -> partial buffers.
    {
      float m1 = INF, m2 = INF;
      int am = INT_MAX;
      const bool col_ok = col0 + my < N;
      const float ac = sa2[my];
      for (int r = half; r < TI; r += 2) {
        const float v = (col_ok && row0 + r < N)
                            ? fmaxf(sa1[r] + ac - 2.f * sS[r * LDS + my], 0.f)
                            : INF;
        push_top2(m1, m2, am, v, row0 + r);
      }
      merge_with_partner(m1, m2, am);
      if (half == 0 && col_ok) {
        const size_t o =
            (static_cast<size_t>(p) * nIT + it) * N + col0 + my;
        pb1[o] = m1;
        pb2[o] = m2;
        pa[o] = am;
      }
    }
    __syncthreads();  // sS and sa2 are rewritten by the next step
  }
  if (half == 0 && row0 + my < N) {
    fb1[pbase + row0 + my] = fb1_r;
    fb2[pbase + row0 + my] = fb2_r;
    fa[pbase + row0 + my] = fa_r;
  }
}

// One thread per (pair, column): merge the row tiles' partials in order.
__global__ void top2_pass2(const float* __restrict__ pb1,
                           const float* __restrict__ pb2,
                           const int* __restrict__ pa, int P, int N, int nIT,
                           float* __restrict__ rb1, float* __restrict__ rb2,
                           int* __restrict__ ra) {
  const size_t idx =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(P) * N) return;
  const size_t p = idx / N;
  const size_t c = idx % N;
  float b1 = BIG, b2 = BIG;
  int a = 0;
  for (int it = 0; it < nIT; ++it) {
    const size_t o = (p * nIT + it) * N + c;
    merge_top2(b1, b2, a, pb1[o], pb2[o], pa[o]);
  }
  rb1[idx] = b1;
  rb2[idx] = b2;
  ra[idx] = a;
}

}  // namespace

extern "C" {

// Rows of d1 per block: the wrapper sizes the partial buffers
// [P, ceil(N / rows), N] with it.
int streaming_top2_row_tile() { return TI; }

// Contraction chunk: the wrapper pads D to a multiple of it.
int streaming_top2_k_chunk() { return KC; }

// d1, d2: [P, N, D] bf16, contiguous, D a multiple of KC. a1, a2: [P, N]
// f32. Outputs fb1, fb2, rb1, rb2: [P, N] f32; fa, ra: [P, N] int32.
// Scratch pb1, pb2 (f32) and pa (int32): [P, ceil(N/TI), N]. Launches both
// passes on `stream` and returns the launch error code (0 on success).
int streaming_top2_launch(const void* d1, const void* d2, const void* a1,
                          const void* a2, int P, int N, int D, void* fb1,
                          void* fb2, void* fa, void* rb1, void* rb2, void* ra,
                          void* pb1, void* pb2, void* pa, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nIT = (N + TI - 1) / TI;
  const dim3 grid1(nIT, P);
  top2_pass1<<<grid1, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(d1),
      static_cast<const __nv_bfloat16*>(d2), static_cast<const float*>(a1),
      static_cast<const float*>(a2), N, D, static_cast<float*>(fb1),
      static_cast<float*>(fb2), static_cast<int*>(fa),
      static_cast<float*>(pb1), static_cast<float*>(pb2),
      static_cast<int*>(pa));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(P) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  top2_pass2<<<blocks, threads, 0, s>>>(
      static_cast<const float*>(pb1), static_cast<const float*>(pb2),
      static_cast<const int*>(pa), P, N, nIT, static_cast<float*>(rb1),
      static_cast<float*>(rb2), static_cast<int*>(ra));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
