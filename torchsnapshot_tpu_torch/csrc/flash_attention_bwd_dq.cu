// K4, flash-attention backward, dq: for q [bh, sq, d] and k/v [bh, sk, d]
// (bf16 or f32, d <= 128), the forward's saved row max m [bh, sq] (f32,
// m_safe) and the cotangents gpv [bh, sq, d] and gl [bh, sq] (f32):
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
// product, 6 d operations per causal pair: ~52 GFLOP against ~0.12 GB of
// operands, so it is bound by operations: ~0.052 ms at 989 TFLOP/s.
//
// - bf16 inputs: the three products on the tensor cores through
//   ``mma.sync`` m16n8k16 (bf16 in, f32 accumulate).  One thread block
//   of four warps per (bh, 64-row q block); each warp owns 16 q rows and
//   keeps its dq accumulator (16 x 128) in registers.  The q and gpv
//   tiles (gpv rounded to bf16 on load) stay in shared memory for the
//   whole walk; k/v blocks of 64 rows are double-buffered by cp.async.
//   ds enters the dq product in bf16 straight from the accumulator
//   registers, as P does in K3.
// - f32 inputs: plain f32 FMAs on the CUDA cores, keeping f32 products
//   exact.
//
// Causal kv blocks entirely above the diagonal are never loaded.
#include "flash_common.cuh"

namespace {

using namespace tsnp_flash;

// ------------------------------------------------------------ bf16 (mma)

constexpr int kMmaBQ = 64;  // 4 warps x 16 rows
constexpr int kMmaBK = 64;
constexpr int kMmaThreads = 128;
constexpr int kTileElems = kMmaBK * kLd;
// q tile, gpv tile, two stages of (k tile, v tile)
constexpr size_t kMmaSmemBytes = 6 * kTileElems * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ m,
                  const float* __restrict__ gpv, const float* __restrict__ gl,
                  float* __restrict__ dq_out, int* __restrict__ amax_out, int sq, int sk, int d,
                  float scale, int causal, long long q_offset, long long k_offset, int sq_real,
                  int sk_real, int vec_loads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + kTileElems;
  __nv_bfloat16* tiles = gs + kTileElems;  // stage i: k at 2i, v at 2i + 1

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kMmaBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * d;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * sk * d;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * sk * d;
  const bool vec = vec_loads != 0;

  const long long kv_end = kv_limit(q0, kMmaBQ, sq_real, sk_real, causal, q_offset, k_offset);
  const int n_kv_blocks = static_cast<int>((kv_end + kMmaBK - 1) / kMmaBK);

  // group 0: the q tile and the first k/v block; the gpv tile converts
  // to bf16 through registers meanwhile
  load_tile(qs, qb, q0, kMmaBQ, sq, d, vec);
  if (n_kv_blocks > 0) {
    load_tile(tiles, kb, 0, kMmaBK, sk, d, vec);
    load_tile(tiles + kTileElems, vb, 0, kMmaBK, sk, d, vec);
  }
  cp_async_commit();
  load_tile_f32(gs, gpv + static_cast<size_t>(bh) * sq * d, q0, kMmaBQ, sq, d);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m2[2], glr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < sq;
    const size_t r = static_cast<size_t>(bh) * sq + rows[h];
    m2[h] = in ? m[r] * kLog2e : 0.f;
    glr[h] = in ? gl[r] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  float acc[kDMax / 8][4];
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max of the recomputed scores (log2 units) and its first column
  float run_max[2] = {-INFINITY, -INFINITY};
  int run_col[2] = {-1, -1};
  const __nv_bfloat16* qw = qs + warp * 16 * kLd;
  const __nv_bfloat16* gw = gs + warp * 16 * kLd;

  for (int kbi = 0; kbi < n_kv_blocks; ++kbi) {
    const int k0 = kbi * kMmaBK;
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

    // s = q k^T and gv = gpv v^T: 16 rows x 64 keys per warp each
    float s[kMmaBK / 8][4], gv[kMmaBK / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = gv[n][0] = gv[n][1] = gv[n][2] = gv[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDMax / 16; ++kk) {
      uint32_t qa[4], ga[4];
      load_a(qa, qw, kk * 16, g, t);
      load_a(ga, gw, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kMmaBK / 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[n], qa, ld_pair(kr), ld_pair(kr + 8));
        const __nv_bfloat16* vr = vs + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(gv[n], ga, ld_pair(vr), ld_pair(vr + 8));
      }
    }

    // mask, p, ds (written over s) and this thread's (max, first column);
    // element e of a tile is row rows[e >> 1], column k0 + n*8 + 2t + (e & 1),
    // so a thread meets its columns in increasing order
    const bool masked = k0 + kMmaBK > sk_real || q0 + kMmaBQ > sq_real ||
                        (causal && k_offset + k0 + kMmaBK - 1 > q_offset + q0);
    float blk_max[2] = {-INFINITY, -INFINITY};
    int blk_col[2] = {-1, -1};
#pragma unroll
    for (int n = 0; n < kMmaBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool vis =
            !masked || visible(rows[h], col, sq_real, sk_real, causal, q_offset, k_offset);
        const float raw = s[n][e] * scale2;
        if (vis && raw > blk_max[h]) {
          blk_max[h] = raw;
          blk_col[h] = col;
        }
        const float p = vis ? exp2f(raw - m2[h]) : 0.f;
        s[n][e] = p * (gv[n][e] + glr[h]);
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
        if (om > blk_max[h] || (om == blk_max[h] && oc >= 0 && (blk_col[h] < 0 || oc < blk_col[h]))) {
          blk_max[h] = om;
          blk_col[h] = oc;
        }
      }
      // blocks come in increasing column order: a strictly larger max
      // moves the argmax, an equal one keeps the earlier column
      if (blk_col[h] >= 0 && blk_max[h] > run_max[h]) {
        run_max[h] = blk_max[h];
        run_col[h] = blk_col[h];
      }
    }

    // dq += ds k: the ds accumulators are the A fragments, k's B
    // fragments come transposed by ldmatrix
#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
      uint32_t da[4];
      acc_to_a(da, s[2 * j], s[2 * j + 1]);
      mma_rows_times_tile(acc, da, ks, j * 16, lane);
    }
    __syncthreads();  // this stage is free for the load two steps on
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows[h];
    if (r >= sq) continue;
    const size_t row = static_cast<size_t>(bh) * sq + r;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < d) dq_out[row * d + c] = acc[n][2 * h] * scale;
      if (c + 1 < d) dq_out[row * d + c + 1] = acc[n][2 * h + 1] * scale;
    }
    if (t == 0) amax_out[row] = run_col[h];
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
// f32; m, gl: f32 [bh, sq]; gpv: f32 [bh, sq, d]; dq: f32 [bh, sq, d];
// amax: i32 [bh, sq].  Launches on ``stream`` and returns
// cudaGetLastError() (0 when there is nothing to launch).
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
    err = allow_smem(bwd_dq_mma_kernel, kMmaSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int vec = (d % 8 == 0) && aligned16(q, k, v);
    bwd_dq_mma_kernel<<<dim3((sq + kMmaBQ - 1) / kMmaBQ, bh), kMmaThreads, kMmaSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(m),
        static_cast<const float*>(gpv), static_cast<const float*>(gl), static_cast<float*>(dq),
        static_cast<int*>(amax), sq, sk, d, scale, causal, q_offset, k_offset, sq_real, sk_real,
        vec);
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
