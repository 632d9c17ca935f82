// K4, flash-attention backward, dq: for q [bh, sq, d] and k/v [bh, sk, d]
// (bf16 or f32, d <= 128), the forward's saved row max m [bh, sq] (f32,
// m_safe) and the cotangents gpv [bh, sq, d] (bf16 for bf16 q/k/v, f32
// for f32 ones) and gl [bh, sq] (f32):
//
//   p_ij  = exp(scale q_i.k_j - m_i) on visible (i, j), 0 elsewhere
//   ds_ij = p_ij (gpv_i.v_j + gl_i)
//   dq_i  = scale sum_j ds_ij k_j                               (f32 out)
//   amax_i = the first global column attaining the row max of the
//            recomputed scores, -1 when the row sees no column  (i32 out)
//
// with the causal mask on global positions and rows >= sq_real / columns
// >= sk_real masked, as the forward (K3) masks them.  The g_m term of
// the gradient is applied outside the kernel on ``amax``.
//
// Replaces: torchsnapshot_tpu/ops/flash_attention.py, ``_bwd_dq_kernel``
// (launched by ``_flash_bwd_jit`` through ``pl.pallas_call``).  The TPU
// kernel walks a sequential grid whose innermost axis is the kv block,
// carrying dq, the running max and its column in VMEM scratch.  Here the
// kv walk is a loop inside one thread block, with dq and the running
// (max, first column) pair in registers; the ragged edge is masked in
// the kernel with no padding copies.
//
// Bound on this card: at the ring-attention shape (bh = 32, s = 2048,
// d = 128, causal) the kernel recomputes the scores, gpv.v and the dq
// product, 6 d operations per causal pair: ~52 GFLOP against ~0.1 GB of
// operands, so it is bound by operations: ~0.052 ms at 989 TFLOP/s.
//
// - bf16 inputs (d % 8 == 0, 16-byte aligned q/k/v/gpv; the wrapper pads
//   the head dim otherwise): the three products on the tensor cores
//   through ``wgmma`` (bf16 in, f32 accumulate), warp-specialised.  A
//   block is two consumer warpgroups, each owning 64 q rows, and one
//   producer thread.  The producer loads the block's q and gpv tiles
//   once and then streams 64-row k/v blocks through a ring of stages by
//   TMA (128-byte swizzle, rows and columns past the arrays
//   zero-filled); ``mbarrier``s hand each stage to the consumers and
//   back.  A consumer computes s = q k^T and gv = gpv v^T with both
//   operands in shared memory, tracks the row max and its first column
//   in registers, and feeds ds from the accumulator registers as the A
//   operand of dq += ds k, which reads k transposed (MN-major) from the
//   same tile.  The two score products are separate commit groups, so
//   the argmax and exp over s run while gv is computed, with no branch
//   per element (a visible column prefix per row and block).  dq (64 x 128 f32 per warpgroup) stays in registers
//   under ``setmaxnreg``.  Blocks are launched highest q tile first:
//   under the causal mask those see the most kv rows.
// - f32 inputs: plain f32 FMAs on the CUDA cores, keeping f32 products
//   exact.
//
// Causal kv blocks entirely above a warpgroup's diagonal are skipped,
// and never loaded when above the block's.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace tsnp_flash;
using namespace tsnp_hopper;

// ---------------------------------------------------------- bf16 (wgmma)

constexpr int kTcBQ = 128;  // q rows per block: two consumer warpgroups x 64
constexpr int kTcBK = 64;   // kv rows per step
constexpr int kStages = 2;
constexpr int kConsumerThreads = 256;
constexpr int kTcThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr uint32_t kQPanel = kTcBQ * kRowBytes;     // one 64-column panel of q or gpv
constexpr uint32_t kQTile = 2 * kQPanel;
constexpr uint32_t kKvPanel = kTcBK * kRowBytes;
constexpr uint32_t kKvTile = 2 * kKvPanel;
// shared memory: the q tile, the gpv tile, the stages (k tile, v tile),
// the barriers
constexpr uint32_t kStageBytes = 2 * kKvTile;
constexpr uint32_t kStageOff = 2 * kQTile;
constexpr uint32_t kBarOff = kStageOff + kStages * kStageBytes;
constexpr size_t kTcSmemBytes = kBarOff + (1 + 2 * kStages) * sizeof(uint64_t) + kAtomBytes;

__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap g_map, const float* __restrict__ m,
                    const float* __restrict__ gl, float* __restrict__ dq_out,
                    int* __restrict__ amax_out, int sq, int sk, int d, float scale, int causal,
                    long long q_offset, long long k_offset, int sq_real, int sk_real) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* gs = smem + kQTile;
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const long long kv_end = kv_limit(q0, kTcBQ, sq_real, sk_real, causal, q_offset, k_offset);
  const int n_kv = static_cast<int>((kv_end + kTcBK - 1) / kTcBK);

  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer: one thread issues every load
    regs_dec<24>();
    if (threadIdx.x != kConsumerThreads) return;
    if (n_kv > 0) {
      mbar_arrive_expect_tx(qg_full, 2 * kQTile);
      tma_load_tile(qs, kQPanel, &q_map, qg_full, q0, bh);
      tma_load_tile(gs, kQPanel, &g_map, qg_full, q0, bh);
    }
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);  // round 0 passes at once
      unsigned char* stage = smem + kStageOff + s * kStageBytes;
      mbar_arrive_expect_tx(&full[s], kStageBytes);
      tma_load_tile(stage, kKvPanel, &k_map, &full[s], i * kTcBK, bh);
      tma_load_tile(stage + kKvTile, kKvPanel, &v_map, &full[s], i * kTcBK, bh);
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows q0w .. q0w + 63
    regs_inc<240>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q0w = q0 + wg * 64;
    const int rows[2] = {q0w + warp * 16 + g, q0w + warp * 16 + g + 8};
    float m2[2], glr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = rows[h] < sq;
      const size_t r = static_cast<size_t>(bh) * sq + rows[h];
      m2[h] = in ? m[r] * kLog2e : 0.f;
      glr[h] = in ? gl[r] : 0.f;
    }
    const float scale2 = scale * kLog2e;
    // kv blocks this warpgroup's rows see (the block's walk may be longer)
    const long long wg_end = kv_limit(q0w, 64, sq_real, sk_real, causal, q_offset, k_offset);
    const int wg_n = static_cast<int>((wg_end + kTcBK - 1) / kTcBK);
    const unsigned char* qw = qs + wg * 64 * kRowBytes;
    const unsigned char* gw = gs + wg * 64 * kRowBytes;

    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    // running max of the recomputed scores (log2 units) and its first column
    float run_max[2] = {-INFINITY, -INFINITY};
    int run_col[2] = {-1, -1};
    if (n_kv > 0) mbar_wait(qg_full, 0);

    for (int i = 0; i < n_kv; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      if (i < wg_n) {
        const int k0 = i * kTcBK;
        const unsigned char* kst = smem + kStageOff + s * kStageBytes;
        const unsigned char* vst = kst + kKvTile;

        // s = q k^T and gv = gpv v^T: 64 q rows x 64 keys each
        float st[32], gt[32];
        wgmma_score_pair(st, gt, qw, gw, kQPanel, kst, vst, kKvPanel);
        wgmma_wait<1>();  // s is done, gv may still run
        fence_regs(st);

        // p (written over st) and this thread's (max, first column) while
        // gv runs; element 4j + e is row rows[e >> 1], column
        // k0 + 8j + 2t + (e & 1), so a thread meets its columns in
        // increasing order.  A row sees the block's columns below lim[h].
        int lim[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          lim[h] = visible_prefix(rows[h], k0, kTcBK, sq_real, sk_real, causal, q_offset, k_offset);
        float blk_max[2] = {-INFINITY, -INFINITY};
        int blk_col[2] = {-1, -1};  // in the block
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int c = 8 * j + 2 * t + (e & 1);
            const bool vis = c < lim[h];
            const float raw = st[4 * j + e] * scale2;
            if (vis && raw > blk_max[h]) {
              blk_max[h] = raw;
              blk_col[h] = c;
            }
            st[4 * j + e] = vis ? exp2_approx(raw - m2[h]) : 0.f;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the four lanes sharing a row group hold its 64 columns: the
          // larger max wins, the smaller column breaks a tie
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, blk_max[h], off);
            const int oc = __shfl_xor_sync(0xffffffffu, blk_col[h], off);
            if (om > blk_max[h] ||
                (om == blk_max[h] && oc >= 0 && (blk_col[h] < 0 || oc < blk_col[h]))) {
              blk_max[h] = om;
              blk_col[h] = oc;
            }
          }
          // blocks come in increasing column order: a strictly larger max
          // moves the argmax, an equal one keeps the earlier column
          if (blk_col[h] >= 0 && blk_max[h] > run_max[h]) {
            run_max[h] = blk_max[h];
            run_col[h] = k0 + blk_col[h];
          }
        }

        wgmma_wait<0>();  // gv = gpv v^T is done
        fence_regs(gt);
#pragma unroll
        for (int x = 0; x < 32; ++x) st[x] *= gt[x] + glr[(x >> 1) & 1];  // ds
        // dq += ds k: ds from the accumulator registers, k read MN-major
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], &st[8 * kk], &st[8 * kk + 4]);
        wgmma_rows_product(dq, da, kst, kKvPanel);
        wgmma_wait<0>();
        fence_regs(dq);
      }
      mbar_arrive(&empty[s]);  // this thread is done with the stage
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rows[h];
      if (r >= sq) continue;
      const size_t row = static_cast<size_t>(bh) * sq + r;
      float* dqr = dq_out + row * d;
#pragma unroll
      for (int n = 0; n < kDMax / 8; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < d)
          *reinterpret_cast<float2*>(dqr + c) =
              make_float2(dq[4 * n + 2 * h] * scale, dq[4 * n + 2 * h + 1] * scale);
      }
      if (t == 0) amax_out[row] = run_col[h];
    }
  }
}

// ------------------------------------------------------------- f32 (FMA)

constexpr int kBQ = 16;  // q rows per thread block
constexpr int kBK = 32;  // k/v rows per inner step
constexpr int kThreads = 128;
constexpr int kKStride = kDMax + 1;  // pad: rows read across lanes
constexpr int kDsStride = kBK + 1;
constexpr size_t kSmemFloats = 2 * kBQ * kKStride + 2 * kBK * kKStride + kBQ * kDsStride;

__global__ void __launch_bounds__(kThreads)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ m,
                  const float* __restrict__ gpv, const float* __restrict__ gl,
                  float* __restrict__ dq_out, int* __restrict__ amax_out, int sq, int sk, int d,
                  float scale, int causal, long long q_offset, long long k_offset, int sq_real,
                  int sk_real) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][kKStride], pre-scaled
  float* gs = qs + kBQ * kKStride;    // [kBQ][kKStride]
  float* ks = gs + kBQ * kKStride;    // [kBK][kKStride]
  float* vs = ks + kBK * kKStride;    // [kBK][kKStride]
  float* ds_s = vs + kBK * kKStride;  // [kBQ][kDsStride]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 3;  // this thread's q row in the block
  const int cx = tid & 7;  // score cols cx + 8j; dq cols cx + 8j
  const int row = q0 + r;

  const float* qb = q + static_cast<size_t>(bh) * sq * d;
  const float* gb = gpv + static_cast<size_t>(bh) * sq * d;
  const float* kb = k + static_cast<size_t>(bh) * sk * d;
  const float* vb = v + static_cast<size_t>(bh) * sk * d;

  for (int idx = tid; idx < kBQ * kDMax; idx += kThreads) {
    const int rr = idx / kDMax, c = idx % kDMax;
    const bool in = q0 + rr < sq && c < d;
    const size_t off = static_cast<size_t>(q0 + rr) * d + c;
    qs[rr * kKStride + c] = in ? qb[off] * scale : 0.f;
    gs[rr * kKStride + c] = in ? gb[off] : 0.f;
  }
  const bool row_in = row < sq;
  const float m_row = row_in ? m[static_cast<size_t>(bh) * sq + row] : 0.f;
  const float gl_row = row_in ? gl[static_cast<size_t>(bh) * sq + row] : 0.f;

  float acc[kDMax / 8];
#pragma unroll
  for (int j = 0; j < kDMax / 8; ++j) acc[j] = 0.f;
  float run_max = -INFINITY;
  int run_col = -1;

  const long long kv_end = kv_limit(q0, kBQ, sq_real, sk_real, causal, q_offset, k_offset);
  const int n_kv_blocks = static_cast<int>((kv_end + kBK - 1) / kBK);

  for (int kbi = 0; kbi < n_kv_blocks; ++kbi) {
    const int k0 = kbi * kBK;
    __syncthreads();  // the previous step is done with ks/vs/ds_s
    for (int idx = tid; idx < kBK * kDMax; idx += kThreads) {
      const int rr = idx / kDMax, c = idx % kDMax;
      const bool in = k0 + rr < sk && c < d;
      const size_t off = static_cast<size_t>(k0 + rr) * d + c;
      ks[rr * kKStride + c] = in ? kb[off] : 0.f;
      vs[rr * kKStride + c] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[kBK / 8], gv[kBK / 8];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j] = gv[j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qv = qs[r * kKStride + c], gvv = gs[r * kKStride + c];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        s[j] = fmaf(qv, ks[(cx + 8 * j) * kKStride + c], s[j]);
        gv[j] = fmaf(gvv, vs[(cx + 8 * j) * kKStride + c], gv[j]);
      }
    }
    // this thread's columns k0 + cx + 8j, in increasing order
    float blk_max = -INFINITY;
    int blk_col = -1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const int col = k0 + cx + 8 * j;
      const bool vis = visible(row, col, sq_real, sk_real, causal, q_offset, k_offset);
      if (vis && s[j] > blk_max) {
        blk_max = s[j];
        blk_col = col;
      }
      const float p = vis ? expf(s[j] - m_row) : 0.f;
      ds_s[r * kDsStride + cx + 8 * j] = p * (gv[j] + gl_row);
    }
    // the 8 lanes sharing a row are consecutive
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, blk_max, off);
      const int oc = __shfl_xor_sync(0xffffffffu, blk_col, off);
      if (om > blk_max || (om == blk_max && oc >= 0 && (blk_col < 0 || oc < blk_col))) {
        blk_max = om;
        blk_col = oc;
      }
    }
    if (blk_col >= 0 && blk_max > run_max) {
      run_max = blk_max;
      run_col = blk_col;
    }
    __syncthreads();  // ds_s is complete

    for (int kk = 0; kk < kBK; ++kk) {
      const float dsv = ds_s[r * kDsStride + kk];
#pragma unroll
      for (int j = 0; j < kDMax / 8; ++j) acc[j] = fmaf(dsv, ks[kk * kKStride + cx + 8 * j], acc[j]);
    }
  }

  if (!row_in) return;
  const size_t out_row = static_cast<size_t>(bh) * sq + row;
#pragma unroll
  for (int j = 0; j < kDMax / 8; ++j) {
    const int c = cx + 8 * j;
    if (c < d) dq_out[out_row * d + c] = acc[j] * scale;
  }
  if (cx == 0) amax_out[out_row] = run_col;
}

}  // namespace

extern "C" int tsnp_flash_bwd_dq_max_head_dim() { return kDMax; }

// q: [bh, sq, d], k/v: [bh, sk, d], contiguous, bf16 (is_bf16 = 1) or
// f32; m, gl: f32 [bh, sq]; gpv: [bh, sq, d] in q's dtype; dq: f32
// [bh, sq, d]; amax: i32 [bh, sq].  The bf16 path takes d % 8 == 0 and
// 16-byte aligned q, k, v and gpv (what TMA reads).  Launches on
// ``stream`` and returns cudaGetLastError() (0 when there is nothing to
// launch).
extern "C" int tsnp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* m,
                                 const void* gpv, const void* gl, void* dq, void* amax, int bh,
                                 int sq, int sk, int d, float scale, int causal,
                                 long long q_offset, long long k_offset, int sq_real,
                                 int sk_real, int is_bf16, void* stream) {
  if (d < 1 || d > kDMax || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if (d % 8 != 0 || !aligned16(q, k, v, gpv)) return static_cast<int>(cudaErrorInvalidValue);
    if (sk <= 0) {  // no kv row: dq = 0, amax = -1 (all bytes 0xff)
      err = cudaMemsetAsync(dq, 0, static_cast<size_t>(bh) * sq * d * sizeof(float), s);
      if (err == cudaSuccess)
        err = cudaMemsetAsync(amax, 0xff, static_cast<size_t>(bh) * sq * sizeof(int), s);
      return static_cast<int>(err);
    }
    CUtensorMap q_map, k_map, v_map, g_map;
    if (!make_tile_map(&q_map, q, bh, sq, d, kTcBQ) || !make_tile_map(&k_map, k, bh, sk, d, kTcBK) ||
        !make_tile_map(&v_map, v, bh, sk, d, kTcBK) || !make_tile_map(&g_map, gpv, bh, sq, d, kTcBQ))
      return static_cast<int>(cudaErrorNotSupported);
    err = allow_smem(bwd_dq_wgmma_kernel, kTcSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_dq_wgmma_kernel<<<dim3(bh, (sq + kTcBQ - 1) / kTcBQ), kTcThreads, kTcSmemBytes, s>>>(
        q_map, k_map, v_map, g_map, static_cast<const float*>(m), static_cast<const float*>(gl),
        static_cast<float*>(dq), static_cast<int*>(amax), sq, sk, d, scale, causal, q_offset,
        k_offset, sq_real, sk_real);
  } else {
    const size_t smem = kSmemFloats * sizeof(float);
    err = allow_smem(bwd_dq_f32_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_dq_f32_kernel<<<dim3((sq + kBQ - 1) / kBQ, bh), kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(m), static_cast<const float*>(gpv),
        static_cast<const float*>(gl), static_cast<float*>(dq), static_cast<int*>(amax), sq, sk,
        d, scale, causal, q_offset, k_offset, sq_real, sk_real);
  }
  return static_cast<int>(cudaGetLastError());
}
