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
// otherwise pay a launch), splits members into 32 KiB chunks so large
// and small members spread evenly over the SMs, and writes 16-byte
// words at any member alignment with four loads in flight per thread
// (slab_common.cuh).  A table of up to ``kInlineMembers`` members rides
// in the kernel's parameters, so the launch needs no upload before it;
// a longer one is read from device memory.
#include <cuda_runtime.h>

#include <cstring>

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

// 3,840 bytes: with the other arguments, inside the 4 KB of parameters
// a launch takes
constexpr int kInlineMembers = 120;
struct PackTable {
  PackDesc d[kInlineMembers];
};

constexpr long long kChunkBytes = 32768;
constexpr int kThreads = 512;  // with kUnroll, one trip over a chunk
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

__global__ void __launch_bounds__(kThreads)
slab_pack_kernel(const __grid_constant__ PackTable inline_descs,
                 const PackDesc* __restrict__ dev_descs, int n, uint8_t* __restrict__ slab) {
  const PackDesc* descs = dev_descs != nullptr ? dev_descs : inline_descs.d;
  const long long c = blockIdx.x;
  const PackDesc d = descs[find_member(descs, n, c)];
  const long long lo = (c - d.chunk_begin) * kChunkBytes;
  long long len = d.nbytes - lo;
  if (len > kChunkBytes) len = kChunkBytes;
  block_copy_bytes<kUnroll>(reinterpret_cast<const uint8_t*>(d.src) + lo, slab + d.dst_off + lo,
                            len);
}

}  // namespace

extern "C" long long tsnp_slab_pack_chunk_bytes() { return kChunkBytes; }
extern "C" int tsnp_slab_pack_inline_members() { return kInlineMembers; }

// descs: ``n`` PackDesc, in host memory when ``on_device`` is 0 (then
// n <= kInlineMembers; they are copied into the launch's parameters
// before this returns) or in device memory otherwise; total_chunks: sum
// of ceil(nbytes / chunk) over members.  Launches on ``stream`` and
// returns cudaGetLastError() (0 when nothing was launched for an empty
// slab).
extern "C" int tsnp_slab_pack(const void* descs, int on_device, int n, long long total_chunks,
                              void* slab, void* stream) {
  if (n <= 0 || total_chunks <= 0) return 0;
  if (total_chunks > 0x7fffffffLL || (!on_device && n > kInlineMembers))
    return static_cast<int>(cudaErrorInvalidValue);
  PackTable table;
  if (!on_device) memcpy(table.d, descs, static_cast<size_t>(n) * sizeof(PackDesc));
  slab_pack_kernel<<<static_cast<unsigned>(total_chunks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      table, on_device ? static_cast<const PackDesc*>(descs) : nullptr, n,
      static_cast<uint8_t*>(slab));
  return static_cast<int>(cudaGetLastError());
}
