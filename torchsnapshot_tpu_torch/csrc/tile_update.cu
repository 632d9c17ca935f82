// K6, tile update: write one device tile of the stored dtype INTO elements
// [off, off + n) of a contiguous restore template, cast to the template's
// dtype, in one launch.
//
// Replaces: torchsnapshot_tpu/ops/device_pack.py, ``_compiled_tile_update``
// (reached through ``tile_update_device`` from ``_DeviceTileAcc.update``,
// preparers/array.py): ``acc[off:off + n] = cast(tile)`` on a flat
// accumulator, one XLA executable per (accumulator, tile) signature,
// donated so the chain stays in place.  Torch tensors are mutable, so the
// template itself is the accumulator: no donation, no chain, and the
// offset is a 64-bit scalar argument (the JAX program's int32 offset is a
// limit of ``lax.dynamic_update_slice``, not of the format).
//
// A budgeted ``read_object`` into a CUDA template reads the payload in
// tiles of at most the budget.  A tile of the template's own dtype needs
// no device pass (one host-to-device copy lands it in place); the wrapper
// launches this kernel for the cast tiles, after one host-to-device copy
// of the tile.  Cast pairs: those K2 takes (identity as bytes, any pair
// among f16/bf16/f32/f64, any pair among the integer types), with K2's
// element conversion (element_cast.cuh), so the result equals
// ``tile.to(dtype)`` bit for bit.
//
// Bound on this card: memory bandwidth, (tile bytes + output bytes) /
// 3.35 TB/s.  Identity tiles take K1's 16-byte word copy
// (slab_common.cuh); cast tiles convert several elements per thread step,
// all loaded before any is stored, so more loads are in flight per SM.
#include <cuda_runtime.h>

#include "element_cast.cuh"
#include "slab_common.cuh"

namespace {

constexpr long long kChunkBytes = 65536;  // identity: bytes per block
constexpr long long kChunkElems = 8192;   // cast: elements per block
constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // 16-byte loads in flight per thread (identity)
constexpr int kSteps = 4;   // elements loaded per thread before storing (cast)

__global__ void __launch_bounds__(kThreads, 8)
tile_update_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                   long long n, int sc, int dc) {
  const long long c = blockIdx.x;
  if (sc == kBytes) {
    const long long lo = c * kChunkBytes;
    long long len = n - lo;
    if (len > kChunkBytes) len = kChunkBytes;
    block_copy_bytes<kUnroll>(src + lo, dst + lo, len);
    return;
  }
  const long long lo = c * kChunkElems;
  long long hi = lo + kChunkElems;
  if (hi > n) hi = n;
  const bool al = reinterpret_cast<uintptr_t>(src) % code_size(sc) == 0;
  const long long out = reinterpret_cast<long long>(dst);
  const long long stride = static_cast<long long>(blockDim.x);
  for (long long i = lo + threadIdx.x; i < hi; i += kSteps * stride) {
    if (is_float(sc)) {
      double x[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const long long j = i + u * stride;
        if (j < hi) x[u] = load_float(src, sc, j, al);
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const long long j = i + u * stride;
        if (j < hi) store_float(out, dc, j, x[u]);
      }
    } else {
      long long x[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const long long j = i + u * stride;
        if (j < hi) x[u] = load_int(src, sc, j, al);
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const long long j = i + u * stride;
        if (j < hi) store_int(out, dc, j, x[u]);
      }
    }
  }
}

}  // namespace

// src: the device tile; dst: the template's base address; off and n:
// elements of the template for a cast (src_code != 0), bytes for the
// identity copy (src_code == dst_code == 0).  Launches on ``stream`` and
// returns cudaGetLastError() (0 when nothing was launched).
extern "C" int tsnp_tile_update(const void* src, void* dst, long long off, long long n,
                                int src_code, int dst_code, void* stream) {
  if (n <= 0) return 0;
  if ((src_code == kBytes) != (dst_code == kBytes) || off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = src_code == kBytes ? kChunkBytes : kChunkElems;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // the destination's first element, in 64-bit arithmetic
  uint8_t* first =
      static_cast<uint8_t*>(dst) + off * (src_code == kBytes ? 1 : code_size(dst_code));
  tile_update_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), first, n, src_code, dst_code);
  return static_cast<int>(cudaGetLastError());
}
