// Helpers shared by the flash-attention kernels (K3 forward, K4 dq and
// K5 dk/dv backward): the masking rules of the JAX package's
// ``_block_scores`` and the accumulator-to-A-fragment repacking (the
// m16n8k16 layout, which is also wgmma's per warp).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace tsnp_flash {

constexpr int kDMax = 128;  // largest head dim taken
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// First kv column past what a q block [q0, q0 + rows) can see: below
// sk_real and, under the causal mask, at or before the last valid row's
// global position.
__device__ __forceinline__ long long kv_limit(int q0, int rows, int sq_real, int sk_real,
                                              int causal, long long q_offset,
                                              long long k_offset) {
  const int q_last = (q0 + rows < sq_real ? q0 + rows : sq_real) - 1;
  if (q_last < q0) return 0;
  long long end = sk_real;
  if (causal) {
    const long long lim = q_offset + q_last - k_offset + 1;
    if (lim < end) end = lim > 0 ? lim : 0;
  }
  return end;
}

// First q row that can see a kv block starting at column k0 (0 when not
// causal): the transposed counterpart of kv_limit.
__device__ __forceinline__ int q_begin(int k0, int causal, long long q_offset,
                                       long long k_offset) {
  if (!causal) return 0;
  const long long first = k_offset + k0 - q_offset;
  return first > 0 ? static_cast<int>(first) : 0;
}

__device__ __forceinline__ bool visible(int row, int col, int sq_real, int sk_real, int causal,
                                        long long q_offset, long long k_offset) {
  return col < sk_real && row < sq_real && (!causal || q_offset + row >= k_offset + col);
}

// How many of the columns [k0, k0 + n) q row ``row`` sees: they are a
// prefix (below sk_real and, when causal, at or before the row's global
// position); 0 for a row at or past sq_real.
__device__ __forceinline__ int visible_prefix(int row, int k0, int n, int sq_real, int sk_real,
                                              int causal, long long q_offset,
                                              long long k_offset) {
  if (row >= sq_real) return 0;
  long long end = sk_real;
  if (causal && q_offset + row - k_offset + 1 < end) end = q_offset + row - k_offset + 1;
  end -= k0;
  return end <= 0 ? 0 : (end >= n ? n : static_cast<int>(end));
}

// The transposed counterpart: the q rows of [q0, q0 + n) that see kv
// column ``col`` are [q0 + first, q0 + n) cut at sq_real; this returns
// ``first`` (n when none does).
__device__ __forceinline__ int first_visible_row(int col, int q0, int n, int sk_real, int causal,
                                                 long long q_offset, long long k_offset) {
  if (col >= sk_real) return n;
  const long long first = causal ? k_offset + col - q_offset - q0 : 0;
  return first <= 0 ? 0 : (first >= n ? n : static_cast<int>(first));
}

// 2^x on the special function unit (subnormal results flush to zero)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of score tiles 2j and 2j + 1 (16 x 8 each) as the A
// fragment of a 16-wide reduction step: the m16n8k16 accumulator layout
// is the A layout, so no trip through shared memory is needed.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo, const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// every pointer 16-byte aligned (what cp.async and TMA need)
template <typename... Ptrs>
inline bool aligned16(Ptrs... ptrs) {
  return ((reinterpret_cast<uintptr_t>(ptrs) | ... | uintptr_t{0}) & 15) == 0;
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tsnp_flash
