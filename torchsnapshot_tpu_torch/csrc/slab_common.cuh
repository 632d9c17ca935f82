// Shared device helpers of the slab pack (K1) and unpack (K2) kernels.
//
// Both kernels split their work into fixed-size chunks over a table of
// members; block b handles one chunk of the member whose chunk range
// holds b.  Members are concatenated in the slab WITHOUT padding (the
// JAX package's slab layout), so a member's bytes may sit at any
// alignment: the byte copy takes 16-byte vector loads and stores where
// source and destination share an alignment, and single bytes where
// they do not.
#pragma once

#include <cstdint>

// The member whose chunk range holds chunk ``c``: the LAST descriptor
// with chunk_begin <= c (zero-chunk members share their successor's
// chunk_begin and are skipped by taking the last match).
template <typename Desc>
__device__ __forceinline__ int find_member(const Desc* __restrict__ descs,
                                           int n, long long c) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (descs[mid].chunk_begin <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Copy ``len`` bytes with all threads of the block.
__device__ __forceinline__ void block_copy_bytes(const uint8_t* __restrict__ src,
                                                 uint8_t* __restrict__ dst,
                                                 long long len) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  long long bytewise_end = len;  // prefix copied byte by byte
  if (((s ^ d) & 15) == 0) {
    long long head = static_cast<long long>((16 - (d & 15)) & 15);
    if (head > len) head = len;
    const long long nvec = (len - head) >> 4;
    const uint4* vs = reinterpret_cast<const uint4*>(src + head);
    uint4* vd = reinterpret_cast<uint4*>(dst + head);
    for (long long i = threadIdx.x; i < nvec; i += blockDim.x) vd[i] = vs[i];
    for (long long i = head + (nvec << 4) + threadIdx.x; i < len; i += blockDim.x)
      dst[i] = src[i];
    bytewise_end = head;
  }
  for (long long i = threadIdx.x; i < bytewise_end; i += blockDim.x) dst[i] = src[i];
}
