// K1, slab pack: gather the bytes of many device tensors into one uint8
// slab in ONE launch, ahead of a single device-to-host copy.
//
// Replaces: torchsnapshot_tpu/ops/device_pack.py, ``_pack`` (launched by
// ``pack_arrays_to_host``), the XLA program that bitcasts every member to
// bytes and concatenates them.  torch's bool is one byte and its complex
// is interleaved (re, im), so the port's pack is a pure byte gather and
// the slab equals the JAX package's byte for byte.
//
// Bound on this card: memory bandwidth.  Every slab byte is read once
// and written once: 2 x slab bytes / 3.35 TB/s.  The design keeps the
// launch count at one whatever the member count (a checkpoint slab has
// hundreds of small optimizer-state members, each of which would
// otherwise pay a launch), splits members into 64 KiB chunks so large
// and small members spread evenly over the SMs, and moves 16 bytes per
// thread per access wherever source and destination alignments agree.
#include <cuda_runtime.h>

#include "slab_common.cuh"

namespace {

// One member: its source bytes, length, and offset in the slab.  Built by
// the Python wrapper as rows of four int64 (the layout must match).
struct PackDesc {
  long long src;          // device address of the member's first byte
  long long nbytes;
  long long dst_off;      // byte offset of the member in the slab
  long long chunk_begin;  // index of the member's first chunk
};

constexpr long long kChunkBytes = 65536;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
slab_pack_kernel(const PackDesc* __restrict__ descs, int n,
                 uint8_t* __restrict__ slab) {
  const long long c = blockIdx.x;
  const PackDesc d = descs[find_member(descs, n, c)];
  const long long lo = (c - d.chunk_begin) * kChunkBytes;
  long long len = d.nbytes - lo;
  if (len > kChunkBytes) len = kChunkBytes;
  block_copy_bytes(reinterpret_cast<const uint8_t*>(d.src) + lo,
                   slab + d.dst_off + lo, len);
}

}  // namespace

extern "C" long long tsnp_slab_pack_chunk_bytes() { return kChunkBytes; }

// descs: device array of ``n`` PackDesc; total_chunks: sum of
// ceil(nbytes / chunk) over members.  Launches on ``stream`` and returns
// cudaGetLastError() (0 when nothing was launched for an empty slab).
extern "C" int tsnp_slab_pack(const void* descs, int n, long long total_chunks,
                              void* slab, void* stream) {
  if (n <= 0 || total_chunks <= 0) return 0;
  if (total_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  slab_pack_kernel<<<static_cast<unsigned>(total_chunks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const PackDesc*>(descs), n, static_cast<uint8_t*>(slab));
  return static_cast<int>(cudaGetLastError());
}
