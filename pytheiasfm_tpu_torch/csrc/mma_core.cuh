// The matcher kernels' product core for Hopper (sm_90a): TMA loads into
// 128-byte-swizzled shared memory, mbarriers, `wgmma` from shared memory,
// and the map from accumulator registers to rows and columns.
//
// A kernel that includes this keeps the A operand (rows x depth, depth
// contiguous: "K-major") and streams the B operand through a ring of stages.
// What depends on how B lies in memory is in a traits struct
// (`BColumnsContiguous` for K2's d2t, `BDepthContiguous` for K1's d2);
// everything else is shared.
//
// Shared-memory layout, the same for a TMA box and for a `wgmma` operand:
// rows of 128 bytes (64 bf16), 8 rows to a 1024-byte swizzle atom, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8). A region must start on a
// 1024-byte boundary, because the hardware takes r from address bits 7-9.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace mma_core {

constexpr int BOX_INNER = 64;             // bf16 elements in a 128-byte row
constexpr int BOX_ROWS = 64;              // rows of one TMA box
constexpr uint32_t ROW_BYTES = 128;
constexpr uint32_t ATOM_BYTES = 8 * ROW_BYTES;          // 8 rows: 1024
constexpr uint32_t BOX_BYTES = BOX_ROWS * ROW_BYTES;    // 8192
constexpr int MMA_M = 64;                 // rows of one warpgroup's product
constexpr int MMA_N = 128;                // columns of one `wgmma`
constexpr int MMA_K = 16;                 // depth of one `wgmma`

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Nanoseconds on the card's global timer.
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the barrier's phase differs from `parity`. A wait that never
// ends is a fault of the kernel's bookkeeping: after WAIT_LIMIT_NS on the
// card's timer (read every 4096 polls, so a wait that ends pays nothing for
// it) the thread traps and the launch fails instead of hanging the card. A
// trap leaves the CUDA context unusable: the process must end.
constexpr uint64_t WAIT_LIMIT_NS = 2000000000ull;  // 2 s

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t since = 0;
  for (uint32_t polls = 1; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (polls & 4095u) == 0) {
      const uint64_t now = global_ns();
      if (since == 0)
        since = now;
      else if (now - since > WAIT_LIMIT_NS)
        __trap();
    }
  }
}

// ---- TMA -------------------------------------------------------------------

// One box of the 2-D tensor `map` at (c0 innermost, c1) into shared memory at
// `dst`; its bytes are reported to `bar`. Issued by one thread.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) from global memory at `src` (16-byte aligned)
// into shared memory at `dst`, reported to `bar`. Issued by one thread.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}

// Keeps the compiler from reading accumulator registers before the wait
// that makes them valid (the wait names no register).
template <int COUNT>
__device__ __forceinline__ void acc_fence(float (&d)[COUNT]) {
#pragma unroll
  for (int i = 0; i < COUNT; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units, layout type 1 in bits
// 62-63. Advancing along the depth adds bytes / 16 to the descriptor.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// The A operand, rows x depth with depth contiguous (K-major): 8 rows of one
// 128-byte row each per atom, so SBO is one atom; LBO is not read under a
// swizzle. A step of MMA_K along the depth is 32 bytes inside the row.
struct ADepthContiguous {
  static constexpr uint32_t LBO = 16;
  static constexpr uint32_t SBO = ATOM_BYTES;
  static constexpr uint32_t K_STEP_BYTES = MMA_K * 2;
};

// The B operand as depth x columns with the columns contiguous (MN-major,
// `wgmma`'s transposed B): a stage of 64 depth rows x 128 columns is two
// boxes of 64 x 64, one per 64-column half. LBO is the distance between the
// halves, SBO the distance between groups of 8 depth rows, and a step of
// MMA_K along the depth is 16 rows.
struct BColumnsContiguous {
  static constexpr int TNSP = 1;
  static constexpr uint32_t LBO = BOX_BYTES;
  static constexpr uint32_t SBO = ATOM_BYTES;
  static constexpr uint32_t K_STEP_BYTES = MMA_K * ROW_BYTES;
  static constexpr uint32_t STAGE_BYTES = 2 * BOX_BYTES;
  // TMA coordinates (innermost first) of half `h` of the stage at depth k0,
  // column col0, in a map over [depth rows, columns] starting at row `base`.
  static __device__ __forceinline__ int c0(int col0, int h) {
    return col0 + BOX_INNER * h;
  }
  static __device__ __forceinline__ int c1(int base, int k0) {
    return base + k0;
  }
};

// The B operand kept as columns x depth with the depth contiguous (K-major,
// `wgmma`'s plain B): the same layout as the A operand. A stage of 128
// columns x 64 depth is two 64 x 64 boxes, one per 64 columns, laid one
// after the other, so every 8 columns are one atom (SBO) and LBO is not read
// under a swizzle; a step of MMA_K along the depth is 32 bytes inside the row.
struct BDepthContiguous {
  static constexpr int TNSP = 0;
  static constexpr uint32_t LBO = ADepthContiguous::LBO;
  static constexpr uint32_t SBO = ADepthContiguous::SBO;
  static constexpr uint32_t K_STEP_BYTES = ADepthContiguous::K_STEP_BYTES;
  static constexpr uint32_t STAGE_BYTES = 2 * BOX_BYTES;
  // TMA coordinates (innermost first) of half `h` of the stage at depth k0,
  // column col0, in a map over [columns, depth] whose columns start at row
  // `base`.
  static __device__ __forceinline__ int c0(int k0) { return k0; }
  static __device__ __forceinline__ int c1(int base, int col0, int h) {
    return base + col0 + BOX_ROWS * h;
  }
};

// d (+)= A[64 x 16] . B[16 x 128], bf16 x bf16 -> f32, both operands from
// shared memory. `accumulate` == 0 overwrites d.
template <int TNSP_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
#define MMA_CORE_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MMA_CORE_ACC16(i) \
  MMA_CORE_ACC4(i), MMA_CORE_ACC4(i + 4), MMA_CORE_ACC4(i + 8), MMA_CORE_ACC4(i + 12)
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : MMA_CORE_ACC16(0), MMA_CORE_ACC16(16), MMA_CORE_ACC16(32),
        MMA_CORE_ACC16(48)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TNSP_B));
#undef MMA_CORE_ACC16
#undef MMA_CORE_ACC4
}

// Where the accumulator of one m64n128 product lies. Thread t of the
// warpgroup (warp w = t / 32, lane l = t % 32) holds, in d[i]:
//   row    16 w + l / 4 + 8 ((i / 2) % 2)
//   column 8 (i / 4) + 2 (l % 4) + i % 2
// so a thread owns two rows, and the 4 lanes of a quad share them.
__device__ __forceinline__ int acc_row(int t, int upper) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * upper;
}

// Minima of a thread's two rows over its columns [0, 2 * GROUPS) of 8-column
// groups: lo for row acc_row(t, 0), hi for row acc_row(t, 1).
template <int GROUPS>
__device__ __forceinline__ void acc_row_min(const float (&d)[64], float& lo,
                                            float& hi) {
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    lo = fminf(lo, fminf(d[4 * g], d[4 * g + 1]));
    hi = fminf(hi, fminf(d[4 * g + 2], d[4 * g + 3]));
  }
}

// Merges a value across the 4 lanes of a quad.
__device__ __forceinline__ float quad_min(float v) {
  v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// `cuTensorMapEncodeTiled`, looked up in the loaded libcuda at run time so
// that the library needs no -lcuda. Null if it is not there.
inline EncodeTiled encode_tiled_entry() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map over a row-major bf16 matrix [rows, cols] (cols contiguous, a
// multiple of 64) whose box is 64 x 64 under the 128-byte swizzle; reads
// outside the matrix give zeros. Returns 0, or a non-zero code.
inline int encode_bf16_rows(CUtensorMap* map, const void* base, uint64_t rows,
                            uint64_t cols) {
  EncodeTiled encode = encode_tiled_entry();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {BOX_INNER, BOX_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

}  // namespace mma_core
