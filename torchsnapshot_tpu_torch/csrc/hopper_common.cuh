// Hopper (sm_90a) building blocks of the flash-attention kernels K3
// (forward), K4 (dq) and K5 (dk/dv): TMA tensor maps made on the host and
// the tile loads they drive, mbarriers, wgmma shared-memory descriptors
// for 128-byte-swizzled bf16 tiles, the m64nNk16 bf16 products (A from
// shared memory or from registers) and setmaxnreg.
//
// Tile layout.  A bf16 tile of R rows x 128 columns lives in shared
// memory as two 64-column panels (panel p holds columns 64p..64p+63),
// each R rows of 128 bytes, with TMA's 128-byte swizzle: the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8), so 8 rows make one
// 1024-byte swizzle atom.  Panels start on 1024-byte boundaries.  The
// same tile serves both operand majors of ``wgmma``:
//   - K-major (the reduction runs along the columns, as in q.k^T): a
//     k16 step is 32 bytes inside one panel row, the next 8 rows are
//     1024 bytes on (the descriptor's stride byte offset);
//   - MN-major (the reduction runs along the rows, as in ds.k): a k16
//     step is 16 rows (2048 bytes), the 8-row groups are 1024 bytes
//     apart (stride byte offset) and the second 64 output columns are
//     the next panel (leading byte offset = the panel's size).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tsnp_hopper {

constexpr int kPanelCols = 64;        // bf16 columns of one 128-byte swizzled row
constexpr uint32_t kRowBytes = 128;   // one panel row
constexpr uint32_t kAtomBytes = 1024; // 8 rows: one swizzle atom
// a stuck wait traps instead of hanging the card (~4 s at 2 GHz)
constexpr long long kWaitTrapCycles = 8000000000LL;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after ``raw`` in shared memory (a
// kernel asks for 1024 bytes more than its tiles need).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* raw) {
  return raw + ((kAtomBytes - (smem_u32(raw) & (kAtomBytes - 1))) & (kAtomBytes - 1));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after every mbar_init, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and add ``bytes`` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's current phase parity differs from ``parity``
// (the phase with that parity has completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kWaitTrapCycles) {
      __trap();
    }
  }
}

// ------------------------------------------------------------------ TMA

// Box (c0 .. c0 + 63 columns, c1 .. rows, c2) of a 3-D tensor map into
// shared memory; completion lands on ``bar`` as transaction bytes.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A [rows, 128] bf16 tile (both 64-column panels) of row block ``row0``
// of batch ``b``.  ``panel_bytes`` is the tile's rows x 128 bytes.
__device__ __forceinline__ void tma_load_tile(unsigned char* dst, uint32_t panel_bytes,
                                              const CUtensorMap* map, uint64_t* bar, int row0,
                                              int b) {
  tma_load_3d(dst, map, bar, 0, row0, b);
  tma_load_3d(dst + panel_bytes, map, bar, kPanelCols, row0, b);
}

// -------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand
// starting at ``start``: stride byte offset 1024 (the next 8 rows),
// leading byte offset ``lbo`` (used by MN-major operands only).
__device__ __forceinline__ uint64_t sw128_desc(const void* start, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(start) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) | (1ull << 62);
}

// K-major k16 step ``kk`` of rows starting at ``rows`` of a 128-column
// tile whose panels are ``panel_bytes`` apart
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* rows, uint32_t panel_bytes,
                                                int kk) {
  return sw128_desc(rows + (kk / 4) * panel_bytes + (kk % 4) * 32, 16);
}

// MN-major k16 step ``kk`` (rows 16kk .. 16kk + 15) of a 128-column tile
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, uint32_t panel_bytes,
                                                 int kk) {
  return sw128_desc(tile + kk * 16 * kRowBytes, panel_bytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers
// across the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the same for register A fragments read by an asynchronous product:
// placed after its wait, it keeps them allocated until then
template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

#define TSNP_ACC8(b)                                                                    \
  "+f"(d[(b) + 0]), "+f"(d[(b) + 1]), "+f"(d[(b) + 2]), "+f"(d[(b) + 3]), "+f"(d[(b) + 4]), \
      "+f"(d[(b) + 5]), "+f"(d[(b) + 6]), "+f"(d[(b) + 7])

// d (64 x 64, f32; zeroed first when ``accumulate`` is 0) += A (64 x 16)
// . B (16 x 64), both bf16 K-major in shared memory.  Accumulator
// element 4j + e of a thread (warp w of the warpgroup, lane 4g + t):
// row 16w + g + 8(e >> 1), column 8j + 2t + (e & 1).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a_desc,
                                                   uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n\t}\n"
      : TSNP_ACC8(0), TSNP_ACC8(8), TSNP_ACC8(16), TSNP_ACC8(24)
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers, the layout of an
// m16n8k16 A fragment per warp) . B (16 x 128, bf16 MN-major in shared
// memory).  Accumulator layout as above with j < 16.
__device__ __forceinline__ void wgmma_m64n128k16_rs_mn(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t b_desc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}\n"
      : TSNP_ACC8(0), TSNP_ACC8(8), TSNP_ACC8(16), TSNP_ACC8(24), TSNP_ACC8(32), TSNP_ACC8(40),
        TSNP_ACC8(48), TSNP_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

#undef TSNP_ACC8

// One score product of a flash-attention step, 64 x 64 over a 128-column
// reduction, as one commit group: d = a . b^T, with a a warpgroup's 64
// rows (panels a_panel bytes apart) and b a 64-row tile (panels b_panel
// bytes apart), both K-major.
__device__ __forceinline__ void wgmma_scores(float (&d)[32], const unsigned char* a,
                                             uint32_t a_panel, const unsigned char* b,
                                             uint32_t b_panel) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss(d, kmajor_desc(a, a_panel, kk), kmajor_desc(b, b_panel, kk), kk);
  wgmma_commit();
}

// The two score products of a flash-attention step, each 64 x 64 over a
// 128-column reduction and committed as a group of its own (so the
// first can be waited for alone): d1 = a1 . b1^T, d2 = a2 . b2^T.  All
// four operands are K-major 128-column tiles: a1/a2 start at a
// warpgroup's 64 rows with panels a_panel bytes apart, b1/b2 are 64-row
// tiles with panels b_panel bytes apart.
__device__ __forceinline__ void wgmma_score_pair(float (&d1)[32], float (&d2)[32],
                                                 const unsigned char* a1,
                                                 const unsigned char* a2, uint32_t a_panel,
                                                 const unsigned char* b1,
                                                 const unsigned char* b2, uint32_t b_panel) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss(d1, kmajor_desc(a1, a_panel, kk), kmajor_desc(b1, b_panel, kk), kk);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_ss(d2, kmajor_desc(a2, a_panel, kk), kmajor_desc(b2, b_panel, kk), kk);
  wgmma_commit();
}

// d (64 x 128) += A . B over a 16 KS-row reduction: A as KS k16 register
// fragments, B the 16 KS-row MN-major tile at ``b`` (panels b_panel bytes
// apart); one commit group
template <int KS>
__device__ __forceinline__ void wgmma_rows_product(float (&d)[64], const uint32_t (&a)[KS][4],
                                                   const unsigned char* b, uint32_t b_panel) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_m64n128k16_rs_mn(d, a[kk], mnmajor_desc(b, b_panel, kk));
  wgmma_commit();
}

// ------------------------------------------------------ register budget

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------ host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a contiguous bf16 [batch, rows, d] array (d % 8 == 0,
// 16-byte aligned base) read in boxes of ``box_rows`` x 64 columns with
// the 128-byte swizzle; false when the driver refuses it.
inline bool make_tile_map(CUtensorMap* map, const void* base, int batch, int rows, int d,
                          int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kPanelCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tsnp_hopper
