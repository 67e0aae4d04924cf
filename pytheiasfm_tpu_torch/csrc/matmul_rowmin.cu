// bf16 descriptor product with a row-min only (K2): the matcher's roofline
// probe.
//
// Replaces the Pallas kernel of tools/exp_matcher_roofline.py (`make(TI, TJ,
// D, semantics).run`, :36; pallas_call at :67, body :37-57). For each pair p
// it computes out[p, i] = min(3.4e38, min_j sum_d d1[p, i, d] * d2t[p, d, j])
// with bf16 products accumulated in f32. It has no norms, no masks and no
// column reductions: it is K1's product with the cheapest selection, so the
// time between K1 (csrc/streaming_top2.cu) and K2 at one shape is the cost of
// K1's top-2 selections and its partial-buffer merge.
//
// Bound on an H100: 2 P N^2 D operations against 2 P N D bf16 inputs and one
// [P, N] f32 output. At N = 4096, D >= 128 that is over 1000 bf16 operations
// per byte, far above the card's ~295, so the tensor cores bound it. The
// design is K1's pass 1 on purpose, so that K2 times exactly K1's product:
// 64x64 output tiles per block of 4 warps, WMMA (mma.sync) 16x16x16 bf16
// tiles with f32 accumulation, 64-deep contraction chunks staged in shared
// memory, no TMA, no wgmma, no pipelining. Each row's running min is carried
// in registers across the column tiles and written once.
//
// d2t is [P, D, N], the tool's own layout (the TPU wants the contracted
// dimension of the right operand leading), read here as a row-major B
// operand. The kernel takes N a multiple of 64 and D a multiple of 64, as the
// TPU tool takes N a multiple of its tiles; the wrapper checks both.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int TI = 64;        // rows of d1 per block
constexpr int TJ = 64;        // columns of d2t per step
constexpr int KC = 64;        // contraction chunk, bf16 elements
constexpr int THREADS = 128;  // 4 warps; warp w owns a 32x32 quadrant
constexpr int LDA = KC + 8;   // shared row stride of the d1 chunk
constexpr int LDB = TJ + 8;   // shared row stride of the d2t chunk
constexpr int LDS = TJ + 4;   // shared row stride of the f32 product tile
constexpr float BIG = 3.4e38f;
// The staging loop below moves both operands' chunks with one index range.
static_assert(TI == KC && TJ == KC, "staging assumes square 64 tiles");

// Grid (N/TI, P). Block (it, p) owns rows [it*TI, it*TI+TI) of pair p and
// walks the column tiles in order.
__global__ void __launch_bounds__(THREADS)
    matmul_rowmin_kernel(const __nv_bfloat16* __restrict__ d1,
                         const __nv_bfloat16* __restrict__ d2t, int N, int D,
                         float* __restrict__ out) {
  __shared__ __align__(32) __nv_bfloat16 sA[TI * LDA];
  __shared__ __align__(32) __nv_bfloat16 sB[KC * LDB];
  __shared__ __align__(32) float sS[TI * LDS];

  const int it = blockIdx.x;
  const int p = blockIdx.y;
  const int row0 = it * TI;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = (warp >> 1) * 32;
  const int wc = (warp & 1) * 32;
  // Row `my` of the tile is scanned by a pair of threads, one taking the
  // even, one the odd columns.
  const int my = tid >> 1;
  const int half = tid & 1;

  const size_t pbase = static_cast<size_t>(p) * N * D;
  const __nv_bfloat16* A = d1 + pbase + static_cast<size_t>(row0) * D;
  const __nv_bfloat16* B = d2t + pbase;

  float row_min = BIG;

  for (int col0 = 0; col0 < N; col0 += TJ) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < D; k0 += KC) {
      // 64 rows x 64 bf16 of each operand: 8 uint4 per row, 4 per thread.
      for (int v = tid; v < TI * (KC / 8); v += THREADS) {
        const int r = v / (KC / 8);
        const int c8 = (v % (KC / 8)) * 8;
        *reinterpret_cast<uint4*>(sA + r * LDA + c8) =
            *reinterpret_cast<const uint4*>(A + static_cast<size_t>(r) * D +
                                            k0 + c8);
        *reinterpret_cast<uint4*>(sB + r * LDB + c8) =
            *reinterpret_cast<const uint4*>(
                B + static_cast<size_t>(k0 + r) * N + col0 + c8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], sA + (wr + 16 * i) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], sB + kk * LDB + wc + 16 * j, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sS + (wr + 16 * i) * LDS + wc + 16 * j,
                                acc[i][j], LDS, wmma::mem_row_major);
    __syncthreads();

    float m = BIG;
    for (int c = half; c < TJ; c += 2) m = fminf(m, sS[my * LDS + c]);
    m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    row_min = fminf(row_min, m);
    __syncthreads();  // sS is rewritten by the next column tile
  }
  if (half == 0) out[static_cast<size_t>(p) * N + row0 + my] = row_min;
}

}  // namespace

extern "C" {

// Rows of d1 per block: N must be a multiple of it.
int matmul_rowmin_row_tile() { return TI; }

// Contraction chunk: D must be a multiple of it.
int matmul_rowmin_k_chunk() { return KC; }

// d1: [P, N, D] bf16, d2t: [P, D, N] bf16, both contiguous and 16-byte
// aligned; N and D multiples of 64. out: [P, N] f32. Launches on `stream`
// and returns the launch error code (0 on success).
int matmul_rowmin_launch(const void* d1, const void* d2t, int P, int N, int D,
                         void* out, void* stream) {
  const dim3 grid(N / TI, P);
  matmul_rowmin_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(d1),
      static_cast<const __nv_bfloat16*>(d2t), N, D, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
