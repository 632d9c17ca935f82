// K3, flash-attention forward partials: for q [bh, sq, d] and k/v
// [bh, sk, d] (bf16 or f32, d <= 128), the online-softmax partials of
// block attention — unnormalised pv = sum_j p_ij v_j (f32), the raw row
// max m and the row sum-exp l — with the causal mask taken on GLOBAL
// positions (q_offset + i >= k_offset + j) and rows >= sq_real / columns
// >= sk_real masked out.
//
// Replaces: torchsnapshot_tpu/ops/flash_attention.py, ``_attend_kernel``
// (launched by ``_flash_partials_jit`` through ``pl.pallas_call``), the
// ring-attention step's Pallas kernel.  The TPU kernel walks a sequential
// grid whose innermost axis is the kv block, carrying (acc, m, l) in VMEM
// scratch across grid steps, and pads q/k/v to 128-row blocks and the
// head dim to 128 lanes.  Here blocks run in parallel in no order, so the
// kv walk is a loop INSIDE one thread block, the running (acc, m, l)
// live in registers, and the ragged edge is masked in the kernel with no
// padding copies.
//
// Bound on this card: at the ring-attention shape (bh = 32, s = 2048,
// d = 128, causal) the work is ~34 GFLOP against ~17 MB of operands, so
// it is bound by operations: 34 GFLOP / 989 TFLOP/s (bf16 tensor cores)
// = ~35 us.  Two kernels:
//
// - bf16 inputs: tensor cores through ``mma.sync`` m16n8k16 (bf16 in,
//   f32 accumulate), FlashAttention-2 style.  One thread block of four
//   warps per (bh, 64-row q block); each warp owns 16 q rows, holds its
//   q fragments, its 16 x 128 output accumulator and its scores in
//   registers, and turns the scores into the P operand of the second
//   product without a trip through shared memory (the accumulator and
//   A-operand layouts line up).  k/v blocks of 64 rows are double-
//   buffered in shared memory by ``cp.async`` (the next block loads
//   while this one computes); the V operand is read transposed with
//   ``ldmatrix.trans``.  The softmax runs in base 2 on pre-scaled
//   scores, and only blocks crossing the diagonal or a ragged edge pay
//   the mask.  P enters the second product in bf16, l is summed from the
//   f32 p.  The products do not use ``wgmma`` and the loads not TMA:
//   those are the next steps toward the bound.
// - f32 inputs: plain f32 FMAs on the CUDA cores (a 4 x 2 score tile and
//   a 4 x 8 accumulator tile per thread), keeping f32 products exact.
//
// Causal kv blocks entirely above the diagonal are never loaded.
#include "flash_common.cuh"

namespace {

using namespace tsnp_flash;

// ------------------------------------------------------------ bf16 (mma)

constexpr int kMmaBQ = 64;  // 4 warps x 16 rows
constexpr int kMmaBK = 64;
constexpr int kMmaThreads = 128;
// two stages of (k tile, v tile); the q tile is staged in stage 1's k
// buffer before the kv loop, and read into registers before it refills
constexpr int kTileElems = kMmaBK * kLd;
constexpr size_t kMmaSmemBytes = 4 * kTileElems * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, float* __restrict__ pv_out,
                     float* __restrict__ m_out, float* __restrict__ l_out, int sq, int sk,
                     int d, float scale, int causal, long long q_offset, long long k_offset,
                     int sq_real, int sk_real) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage i: k tile at tiles + 2i * kTileElems, v tile right after it
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = tiles + 2 * kTileElems;  // stage 1's k buffer

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kMmaBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * d;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * sk * d;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * sk * d;
  const bool vec = (d & 7) == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                     reinterpret_cast<uintptr_t>(k) |
                                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  load_tile(qs, qb, q0, kMmaBQ, sq, d, vec);
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // this warp's q rows as A fragments, all eight 16-wide k steps
  uint32_t qf[kDMax / 16][4];
  const __nv_bfloat16* qw = qs + warp * 16 * kLd;
#pragma unroll
  for (int kk = 0; kk < kDMax / 16; ++kk) {
    qf[kk][0] = ld_pair(qw + g * kLd + kk * 16 + 2 * t);
    qf[kk][1] = ld_pair(qw + (g + 8) * kLd + kk * 16 + 2 * t);
    qf[kk][2] = ld_pair(qw + g * kLd + kk * 16 + 8 + 2 * t);
    qf[kk][3] = ld_pair(qw + (g + 8) * kLd + kk * 16 + 8 + 2 * t);
  }
  __syncthreads();  // every warp holds its q before stage 1 refills

  float o[kDMax / 8][4];
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running row max in log2 units (scores pre-scaled by log2 e)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float scale2 = scale * kLog2e;

  const long long kv_end =
      kv_limit(q0, kMmaBQ, sq_real, sk_real, causal, q_offset, k_offset);
  const int n_kv_blocks = static_cast<int>((kv_end + kMmaBK - 1) / kMmaBK);

  if (n_kv_blocks > 0) {
    load_tile(tiles, kb, 0, kMmaBK, sk, d, vec);
    load_tile(tiles + kTileElems, vb, 0, kMmaBK, sk, d, vec);
  }
  cp_async_commit();

  for (int kbi = 0; kbi < n_kv_blocks; ++kbi) {
    const int k0 = kbi * kMmaBK;
    // the next block's load flies while this one computes; its stage was
    // released by the barrier that ended the previous step
    if (kbi + 1 < n_kv_blocks) {
      __nv_bfloat16* next = tiles + ((kbi + 1) & 1) * 2 * kTileElems;
      load_tile(next, kb, k0 + kMmaBK, kMmaBK, sk, d, vec);
      load_tile(next + kTileElems, vb, k0 + kMmaBK, kMmaBK, sk, d, vec);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* ks = tiles + (kbi & 1) * 2 * kTileElems;
    const __nv_bfloat16* vs = ks + kTileElems;

    // scores: 16 rows x 64 keys per warp, as eight 16 x 8 accumulators
    float s[kMmaBK / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDMax / 16; ++kk) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // mask (only blocks crossing the diagonal or a ragged edge need it)
    // + online softmax; element e of a tile is row rows[e >> 1], column
    // k0 + n * 8 + 2t + (e & 1)
    const bool masked = k0 + kMmaBK > sk_real || q0 + kMmaBQ > sq_real ||
                        (causal && k_offset + k0 + kMmaBK - 1 > q_offset + q0);
    float m_blk[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = !masked || visible(rows[e >> 1], col, sq_real, sk_real, causal,
                                     q_offset, k_offset)
                      ? s[n][e] * scale2
                      : -INFINITY;
        m_blk[e >> 1] = fmaxf(m_blk[e >> 1], s[n][e]);
      }
    }
    float m_safe[2], corr[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four lanes sharing a row group hold its 64 columns
      m_blk[h] = fmaxf(m_blk[h], __shfl_xor_sync(0xffffffffu, m_blk[h], 1));
      m_blk[h] = fmaxf(m_blk[h], __shfl_xor_sync(0xffffffffu, m_blk[h], 2));
      const float m_new = fmaxf(m_run[h], m_blk[h]);
      m_safe[h] = isfinite(m_new) ? m_new : 0.f;
      corr[h] = isfinite(m_run[h]) ? exp2f(m_run[h] - m_safe[h]) : 0.f;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_safe[e >> 1]);  // masked: exp2(-inf) = 0
        row_sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
      l_run[h] = l_run[h] * corr[h] + row_sum[h];
    }
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // o += p v: the score accumulators of tiles 2j, 2j+1 are the A
    // fragment of key step j; v's B fragments come transposed by ldmatrix
#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      // lanes 0-15 address the 16 key rows of this step
      const __nv_bfloat16* vrow = vs + (j * 16 + (lane & 15)) * kLd;
#pragma unroll
      for (int n = 0; n < kDMax / 8; ++n) {
        uint32_t b0, b1;
        const uint32_t addr =
            static_cast<uint32_t>(__cvta_generic_to_shared(vrow + n * 8));
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(addr));
        mma_bf16(o[n], pa, b0, b1);
      }
    }
    __syncthreads();  // this stage is free for the load two steps on
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows[h];
    if (r >= sq) continue;
    const size_t row = static_cast<size_t>(bh) * sq + r;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < d) pv_out[row * d + c] = o[n][2 * h];
      if (c + 1 < d) pv_out[row * d + c + 1] = o[n][2 * h + 1];
    }
    if (t == 0) {
      m_out[row] = m_run[h] * kLn2;  // back to natural units (-inf stays)
      l_out[row] = l_run[h];
    }
  }
}

// ------------------------------------------------------------- f32 (FMA)

constexpr int kBQ = 64;  // q rows per thread block
constexpr int kBK = 32;  // k/v rows per inner step
constexpr int kThreads = 256;
constexpr int kKStride = kDMax + 1;  // pad: k rows read across lanes
constexpr int kPStride = kBK + 1;
constexpr size_t kSmemFloats =
    kBQ * kDMax + kBK * kKStride + kBK * kDMax + kBQ * kPStride;

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ pv_out,
                     float* __restrict__ m_out, float* __restrict__ l_out, int sq, int sk,
                     int d, float scale, int causal, long long q_offset, long long k_offset,
                     int sq_real, int sk_real) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBQ][kDMax], pre-scaled
  float* ks = qs + kBQ * kDMax;        // [kBK][kKStride]
  float* vs = ks + kBK * kKStride;     // [kBK][kDMax]
  float* ps = vs + kBK * kDMax;        // [kBQ][kPStride]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3 of the q block
  const int tx = tid & 15;  // score cols tx, tx+16; acc cols tx+16*j

  const float* qb = q + static_cast<size_t>(bh) * sq * d;
  const float* kb = k + static_cast<size_t>(bh) * sk * d;
  const float* vb = v + static_cast<size_t>(bh) * sk * d;

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - (idx / d) * d;
    const int gr = q0 + r;
    qs[r * kDMax + c] = gr < sq ? qb[static_cast<size_t>(gr) * d + c] * scale : 0.f;
  }

  float acc[4][8];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const long long kv_end = kv_limit(q0, kBQ, sq_real, sk_real, causal, q_offset, k_offset);
  const int n_kv_blocks = static_cast<int>((kv_end + kBK - 1) / kBK);

  for (int kbi = 0; kbi < n_kv_blocks; ++kbi) {
    const int k0 = kbi * kBK;
    __syncthreads();  // the previous step is done with ks/vs/ps
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      const int r = idx / d, c = idx - (idx / d) * d;
      const int gr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (gr < sk) {
        kv = kb[static_cast<size_t>(gr) * d + c];
        vv = vb[static_cast<size_t>(gr) * d + c];
      }
      ks[r * kKStride + c] = kv;
      vs[r * kDMax + c] = vv;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * kDMax + c];
      const float k_a = ks[tx * kKStride + c];
      const float k_b = ks[(tx + 16) * kKStride + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i], k_a, s[i][0]);
        s[i][1] = fmaf(qv[i], k_b, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      bool ok[2];
      float m_blk = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ok[j] = visible(r, k0 + tx + 16 * j, sq_real, sk_real, causal, q_offset, k_offset);
        if (!ok[j]) s[i][j] = -INFINITY;
        m_blk = fmaxf(m_blk, s[i][j]);
      }
      // the 16 lanes sharing a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, off));
      const float m_new = fmaxf(m_run[i], m_blk);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        ps[(ty * 4 + i) * kPStride + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float corr = isfinite(m_run[i]) ? expf(m_run[i] - m_safe) : 0.f;
      l_run[i] = l_run[i] * corr + row_sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // ps is complete

    for (int kk = 0; kk < kBK; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = vs[kk * kDMax + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const size_t row = static_cast<size_t>(bh) * sq + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < d) pv_out[row * d + c] = acc[i][j];
    }
    if (tx == 0) {
      m_out[row] = m_run[i];
      l_out[row] = l_run[i];
    }
  }
}

}  // namespace

extern "C" int tsnp_flash_fwd_max_head_dim() { return kDMax; }

// q: [bh, sq, d], k/v: [bh, sk, d], contiguous, bf16 (is_bf16 = 1) or
// f32; pv: f32 [bh, sq, d]; m, l: f32 [bh, sq].  Launches on ``stream``
// and returns cudaGetLastError() (0 when there is nothing to launch).
extern "C" int tsnp_flash_fwd(const void* q, const void* k, const void* v, void* pv,
                              void* m, void* l, int bh, int sq, int sk, int d,
                              float scale, int causal, long long q_offset,
                              long long k_offset, int sq_real, int sk_real, int is_bf16,
                              void* stream) {
  if (d < 1 || d > kDMax || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = allow_smem(flash_fwd_mma_kernel, kMmaSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_mma_kernel<<<dim3((sq + kMmaBQ - 1) / kMmaBQ, bh), kMmaThreads,
                           kMmaSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<float*>(pv),
        static_cast<float*>(m), static_cast<float*>(l), sq, sk, d, scale, causal,
        q_offset, k_offset, sq_real, sk_real);
  } else {
    const size_t smem = kSmemFloats * sizeof(float);
    err = allow_smem(flash_fwd_f32_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32_kernel<<<dim3((sq + kBQ - 1) / kBQ, bh), kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(pv), static_cast<float*>(m),
        static_cast<float*>(l), sq, sk, d, scale, causal, q_offset, k_offset, sq_real,
        sk_real);
  }
  return static_cast<int>(cudaGetLastError());
}
