// Shared device helpers of the slab pack (K1) and unpack (K2) kernels.
//
// Both kernels split their work into fixed-size chunks over a table of
// members; block b handles one chunk of the member whose chunk range
// holds b.  Members are concatenated in the slab WITHOUT padding (the
// JAX package's slab layout), so a member's bytes may sit at any
// alignment, and one member whose size is not a multiple of 16 (a 4-byte
// optimizer step, a bool mask) shifts every member after it.  The byte
// copy therefore writes 16-byte words at the destination's alignment
// whatever the source's: where the two agree mod 16 it copies aligned
// words, and where they do not it reads the two aligned source words
// that straddle each destination word and shifts them together (funnel
// shifts).  Single bytes are copied only at a piece's head and tail,
// fewer than 16 of each.  Each thread issues several independent loads
// before their stores (the kernel picks how many), so more bytes are in
// flight per SM.
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

// The 16 bytes that start 4Q + rb / 8 bytes into the 32 bytes lo:hi.
template <int Q>
__device__ __forceinline__ uint4 realign(const uint4& lo, const uint4& hi, uint32_t rb) {
  const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_uint4(__funnelshift_r(x[Q], x[Q + 1], rb), __funnelshift_r(x[Q + 1], x[Q + 2], rb),
                    __funnelshift_r(x[Q + 2], x[Q + 3], rb),
                    __funnelshift_r(x[Q + 3], x[Q + 4], rb));
}

// vd[i] = the 16 source bytes of destination word i, for i < n, with
// ``Unroll`` loads per thread in flight.  With ``Shifted`` the source
// words are vs[i] and vs[i + 1], aligned, and the bytes start 4Q + rb / 8
// into vs[i]; each aligned word read holds at least one byte of the
// piece, so no read leaves the source's pages.
template <int Unroll, bool Shifted, int Q>
__device__ __forceinline__ void copy_words(const uint4* __restrict__ vs, uint4* __restrict__ vd,
                                           long long n, uint32_t rb) {
  const int bd = blockDim.x;
  long long i = threadIdx.x;
  for (; i + (Unroll - 1) * bd < n; i += Unroll * bd) {
    uint4 lo[Unroll], hi[Unroll];
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      lo[u] = vs[i + u * bd];
      if constexpr (Shifted) hi[u] = vs[i + u * bd + 1];
    }
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      if constexpr (Shifted) {
        vd[i + u * bd] = realign<Q>(lo[u], hi[u], rb);
      } else {
        vd[i + u * bd] = lo[u];
      }
    }
  }
  for (; i < n; i += bd) {
    if constexpr (Shifted) {
      vd[i] = realign<Q>(vs[i], vs[i + 1], rb);
    } else {
      vd[i] = vs[i];
    }
  }
}

// Copy ``len`` bytes with all threads of the block.
template <int Unroll>
__device__ __forceinline__ void block_copy_bytes(const uint8_t* __restrict__ src,
                                                 uint8_t* __restrict__ dst,
                                                 long long len) {
  long long head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
  if (head > len) head = len;
  const long long nvec = (len - head) >> 4;
  const long long tail = head + (nvec << 4);
  for (long long i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (long long i = tail + threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
  if (nvec == 0) return;
  uint4* vd = reinterpret_cast<uint4*>(dst + head);
  const uint8_t* s = src + head;
  const uint32_t r = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(s) & 15);
  const uint4* vs = reinterpret_cast<const uint4*>(s - r);
  const uint32_t rb = (r & 3) * 8;
  switch (r == 0 ? -1 : static_cast<int>(r >> 2)) {
    case -1: copy_words<Unroll, false, 0>(vs, vd, nvec, 0); break;
    case 0: copy_words<Unroll, true, 0>(vs, vd, nvec, rb); break;
    case 1: copy_words<Unroll, true, 1>(vs, vd, nvec, rb); break;
    case 2: copy_words<Unroll, true, 2>(vs, vd, nvec, rb); break;
    default: copy_words<Unroll, true, 3>(vs, vd, nvec, rb); break;
  }
}
