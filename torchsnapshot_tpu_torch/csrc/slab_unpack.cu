// K2, slab unpack: turn one device-resident uint8 slab into its member
// tensors, casting each to its restore template's dtype and writing it
// INTO the template's storage, in ONE launch.
//
// Replaces: torchsnapshot_tpu/ops/device_pack.py, ``_jitted_unpack``
// (driven by ``unpack_slab_to_device``): per member, slice the slab at a
// runtime byte offset, bitcast to the stored dtype and shape, cast to the
// template dtype.  The JAX program returns new arrays; here the template
// is updated in place (torch tensors are mutable), so the restore holds
// one copy of the state on the device, not two.
//
// Cast pairs taken: identity for every dtype (a byte copy), any pair
// among f16/bf16/f32/f64, any pair among the integer types.  The wrapper
// routes every other pair to the host path before launch.  Float casts go
// through float (and double for f64) exactly as torch's own copy kernel
// does, so the result equals ``tensor.to(dtype)`` bit for bit.
//
// Bound on this card: memory bandwidth, (slab bytes + output bytes) /
// 3.35 TB/s, after the one host-to-device copy of the slab.  Identity
// members take K1's byte copy (16-byte words at any slab offset, the
// misaligned ones realigned by funnel shifts); cast members convert one
// element per thread step.  Members sit at arbitrary byte offsets in the
// slab (no padding between them), so a member whose offset is not a
// multiple of its element size is read with byte-wise loads.
#include <cuda_runtime.h>

#include "element_cast.cuh"
#include "slab_common.cuh"

namespace {

// One member, as rows of six int64 built by the wrapper.
struct UnpackDesc {
  long long src_off;      // byte offset of the member in the slab
  long long dst;          // device address of the template's storage
  long long n;            // bytes for kBytes, elements otherwise
  long long src_code;
  long long dst_code;
  long long chunk_begin;  // index of the member's first chunk
};

constexpr long long kChunkBytes = 65536;
constexpr long long kChunkElems = 8192;
constexpr int kThreads = 256;
// 16-byte loads in flight per thread for identity members, kept at 2 so
// the kernel fits 32 registers: 8 blocks per SM, which the cast path
// (one element per thread step) needs to hide its latency
constexpr int kUnroll = 2;
constexpr int kMinBlocks = 8;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
slab_unpack_kernel(const UnpackDesc* __restrict__ descs, int n,
                   const uint8_t* __restrict__ slab) {
  const long long c = blockIdx.x;
  const UnpackDesc d = descs[find_member(descs, n, c)];
  const uint8_t* src = slab + d.src_off;
  const int sc = static_cast<int>(d.src_code);
  const int dc = static_cast<int>(d.dst_code);
  if (sc == kBytes) {
    const long long lo = (c - d.chunk_begin) * kChunkBytes;
    long long len = d.n - lo;
    if (len > kChunkBytes) len = kChunkBytes;
    block_copy_bytes<kUnroll>(src + lo, reinterpret_cast<uint8_t*>(d.dst) + lo, len);
    return;
  }
  const long long lo = (c - d.chunk_begin) * kChunkElems;
  long long hi = lo + kChunkElems;
  if (hi > d.n) hi = d.n;
  const bool al = reinterpret_cast<uintptr_t>(src) % code_size(sc) == 0;
  if (is_float(sc)) {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
      store_float(d.dst, dc, i, load_float(src, sc, i, al));
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
      store_int(d.dst, dc, i, load_int(src, sc, i, al));
  }
}

}  // namespace

extern "C" long long tsnp_slab_unpack_chunk_bytes() { return kChunkBytes; }
extern "C" long long tsnp_slab_unpack_chunk_elems() { return kChunkElems; }

// descs: device array of ``n`` UnpackDesc; total_chunks: sum of the
// members' chunk counts.  Launches on ``stream`` and returns
// cudaGetLastError() (0 when nothing was launched).
extern "C" int tsnp_slab_unpack(const void* descs, int n, long long total_chunks,
                                const void* slab, void* stream) {
  if (n <= 0 || total_chunks <= 0) return 0;
  if (total_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  slab_unpack_kernel<<<static_cast<unsigned>(total_chunks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const UnpackDesc*>(descs), n, static_cast<const uint8_t*>(slab));
  return static_cast<int>(cudaGetLastError());
}
