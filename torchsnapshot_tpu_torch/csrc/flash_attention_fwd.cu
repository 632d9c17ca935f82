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
// = ~35 us.
//
// - bf16 inputs (d % 8 == 0, 16-byte aligned q/k/v; the wrapper pads the
//   head dim otherwise): both products on the tensor cores through
//   ``wgmma`` (bf16 in, f32 accumulate), warp-specialised as K4 is.  A
//   block is two consumer warpgroups, each owning 64 of the block's 128
//   q rows, and a producer warpgroup of which one thread issues every
//   load.  The producer loads the q tile once and then streams 64-row
//   k/v tiles through a ring of three stages by TMA (128-byte swizzle,
//   rows and columns past the arrays zero-filled); ``mbarrier``s hand
//   each stage to the consumers and back.  A consumer step computes
//   s = q k^T with both operands in shared memory, then the online
//   softmax in registers (base 2 on scores pre-scaled by log2 e, one
//   compare per element against the row's visible column range only on
//   tiles that cross the diagonal or a ragged edge, ``ex2.approx.ftz``,
//   no branch per element), rescales o, rounds p to bf16 in registers
//   and feeds it as the A operand of o += p v, which reads v MN-major
//   from its tile.  The steps overlap: step i's score product and step
//   i - 1's p v product are issued back to back as two commit groups,
//   so the softmax of step i runs while p v of step i - 1 is on the
//   tensor cores.  o (64 x 128 f32 per warpgroup) stays in registers
//   under ``setmaxnreg``; l is summed per thread and reduced across the
//   row's four lanes once, at the end.  Blocks are launched highest q
//   tile first: under the causal mask those see the most kv tiles.  P
//   enters the second product in bf16, l is summed from the f32 p.
// - f32 inputs: plain f32 FMAs on the CUDA cores (a 4 x 2 score tile and
//   a 4 x 8 accumulator tile per thread), keeping f32 products exact.
//
// Causal kv tiles entirely above a warpgroup's diagonal are skipped, and
// never loaded when above the block's.
#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace tsnp_flash;
using namespace tsnp_hopper;

// ---------------------------------------------------------- bf16 (wgmma)

constexpr int kTcBQ = 128;  // q rows per block: two consumer warpgroups x 64
constexpr int kTcBK = 64;   // kv rows per step
constexpr int kStages = 3;  // a stage's v tile is read one step after its k tile
constexpr int kConsumerThreads = 256;
constexpr int kTcThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr uint32_t kQPanel = kTcBQ * kRowBytes;     // one 64-column panel of q
constexpr uint32_t kQTile = 2 * kQPanel;
constexpr uint32_t kKvPanel = kTcBK * kRowBytes;
constexpr uint32_t kKvTile = 2 * kKvPanel;
// shared memory: the q tile, the stages (k tile, v tile), the barriers
constexpr uint32_t kStageBytes = 2 * kKvTile;
constexpr uint32_t kStageOff = kQTile;
constexpr uint32_t kBarOff = kStageOff + kStages * kStageBytes;
constexpr size_t kTcSmemBytes = kBarOff + (1 + 2 * kStages) * sizeof(uint64_t) + kAtomBytes;

__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, float* __restrict__ pv_out,
                       float* __restrict__ m_out, float* __restrict__ l_out, int sq, int d,
                       float scale, int causal, long long q_offset, long long k_offset,
                       int sq_real, int sk_real) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const long long kv_end = kv_limit(q0, kTcBQ, sq_real, sk_real, causal, q_offset, k_offset);
  const int n_kv = static_cast<int>((kv_end + kTcBK - 1) / kTcBK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_arrive_expect_tx(q_full, kQTile);
      tma_load_tile(qs, kQPanel, &q_map, q_full, q0, bh);
    }
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);  // round 0 passes at once
      unsigned char* stage = smem + kStageOff + s * kStageBytes;
      mbar_arrive_expect_tx(&full[s], kStageBytes);
      tma_load_tile(stage, kKvPanel, &k_map, &full[s], i * kTcBK, bh);
      tma_load_tile(stage + kKvTile, kKvPanel, &v_map, &full[s], i * kTcBK, bh);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0w .. q0w + 63
  regs_inc<240>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0w = q0 + wg * 64;
  const int rows[2] = {q0w + warp * 16 + g, q0w + warp * 16 + g + 8};
  const float scale2 = scale * kLog2e;
  // kv tiles this warpgroup's rows see (the block's walk may be longer)
  const long long wg_end = kv_limit(q0w, 64, sq_real, sk_real, causal, q_offset, k_offset);
  const int wg_n = static_cast<int>((wg_end + kTcBK - 1) / kTcBK);
  const unsigned char* qw = qs + wg * 64 * kRowBytes;
  auto stage_at = [&](int i) { return smem + kStageOff + (i % kStages) * kStageBytes; };

  float o[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) o[x] = 0.f;
  // running row max (scores x scale x log2 e) and this thread's share of
  // the row sum; accumulator element x is row rows[(x >> 1) & 1], column
  // 8 (x >> 2) + 2t + (x & 1) of the step's tile
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float st[kTcBK / 2], corr[2];
  uint32_t pa[kTcBK / 16][4];  // p of the previous step, bf16 A fragments

  // The online softmax of step i on st (p written over it), with corr
  // the factor that moves o and l to the new row max.  Only Masked
  // steps test the columns: one compare per element against the row's
  // visible prefix.  No branch depends on the data, so nothing diverges
  // while the previous step's p v product is in flight.
  auto softmax = [&](int i, auto masked) {
    if constexpr (decltype(masked)::value) {
      int lim[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lim[h] = visible_prefix(rows[h], i * kTcBK, kTcBK, sq_real, sk_real, causal, q_offset,
                                k_offset) - 2 * t;
#pragma unroll
      for (int x = 0; x < kTcBK / 2; ++x)
        st[x] = 8 * (x >> 2) + (x & 1) < lim[(x >> 1) & 1] ? st[x] : -INFINITY;
    }
    float mb[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < kTcBK / 2; ++x) mb[(x >> 1) & 1] = fmaxf(mb[(x >> 1) & 1], st[x]);
    float m_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four lanes sharing a row group hold the tile's columns
      mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 1));
      mb[h] = fmaxf(mb[h], __shfl_xor_sync(0xffffffffu, mb[h], 2));
      const float m_new = fmaxf(m2[h], mb[h] * scale2);
      m_safe[h] = m_new == -INFINITY ? 0.f : m_new;  // a row that saw nothing yet
      corr[h] = exp2_approx(m2[h] - m_safe[h]);     // 0 while m2 is -inf
      m2[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int x = 0; x < kTcBK / 2; ++x) {
      // masked: exp2(-inf) = 0
      st[x] = exp2_approx(fmaf(st[x], scale2, -m_safe[(x >> 1) & 1]));
      l[(x >> 1) & 1] += st[x];
    }
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) acc_to_a(pa[kk], &st[8 * kk], &st[8 * kk + 4]);
  };
  // Step i >= 1: its score product and step i - 1's p v product go out
  // back to back; the softmax runs while p v is on the tensor cores.
  auto step = [&](int i, auto masked) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    wgmma_scores(st, qw, kQPanel, stage_at(i), kKvPanel);
    wgmma_rows_product(o, pa, stage_at(i - 1) + kKvTile, kKvPanel);  // o += p v, step i - 1
    wgmma_wait<1>();  // s is done, p v may still run
    fence_regs(st);
    softmax(i, masked);
    wgmma_wait<0>();  // p v of step i - 1 is done: o and its stage are free
    fence_regs(o);
    fence_frags(pa);
    mbar_arrive(&empty[(i - 1) % kStages]);
#pragma unroll
    for (int x = 0; x < 64; ++x) o[x] *= corr[(x >> 1) & 1];
    pack_p();
  };

  if (wg_n > 0) {
    // the leading steps whose tile every row of the warpgroup sees whole
    // (below sk_real and, when causal, at or below the diagonal) need no
    // column test
    long long clear = q0w + 64 <= sq_real ? sk_real / kTcBK : 0;
    if (causal) {
      const long long diag = (q_offset + q0w - k_offset + 1) / kTcBK;
      clear = diag < clear ? diag : clear;
    }
    const int n_clear = clear <= 0 ? 0 : (clear < wg_n ? static_cast<int>(clear) : wg_n);
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    wgmma_scores(st, qw, kQPanel, stage_at(0), kKvPanel);
    wgmma_wait<0>();
    fence_regs(st);
    if (n_clear > 0) {
      softmax(0, std::false_type{});
    } else {
      softmax(0, std::true_type{});
    }
    pack_p();
    for (int i = 1; i < n_clear; ++i) step(i, std::false_type{});
    for (int i = n_clear > 1 ? n_clear : 1; i < wg_n; ++i) step(i, std::true_type{});
    wgmma_rows_product(o, pa, stage_at(wg_n - 1) + kKvTile, kKvPanel);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[(wg_n - 1) % kStages]);
  }
  // tiles the block loads for its other warpgroup only
  for (int i = wg_n; i < n_kv; ++i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    mbar_arrive(&empty[i % kStages]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = rows[h];
    if (r >= sq) continue;
    const size_t row = static_cast<size_t>(bh) * sq + r;
    float* pvr = pv_out + row * d;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < d)  // d % 8 == 0: c + 1 < d too
        *reinterpret_cast<float2*>(pvr + c) = make_float2(o[4 * n + 2 * h], o[4 * n + 2 * h + 1]);
    }
    if (t == 0) {
      m_out[row] = m2[h] * kLn2;  // back to natural units (-inf stays)
      l_out[row] = l[h];
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
// f32; pv: f32 [bh, sq, d]; m, l: f32 [bh, sq].  The bf16 path takes
// d % 8 == 0 and 16-byte aligned q, k and v (what TMA reads).  Launches
// on ``stream`` and returns cudaGetLastError() (0 when there is nothing
// to launch).
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
    if (d % 8 != 0 || !aligned16(q, k, v)) return static_cast<int>(cudaErrorInvalidValue);
    // no kv row: every row sees nothing; the k/v maps are then made over
    // q so that they are valid, and are never read (the walk is empty)
    if (sk <= 0) sk_real = 0;
    const int kv_rows = sk > 0 ? sk : sq;
    CUtensorMap q_map, k_map, v_map;
    if (!make_tile_map(&q_map, q, bh, sq, d, kTcBQ) ||
        !make_tile_map(&k_map, sk > 0 ? k : q, bh, kv_rows, d, kTcBK) ||
        !make_tile_map(&v_map, sk > 0 ? v : q, bh, kv_rows, d, kTcBK))
      return static_cast<int>(cudaErrorNotSupported);
    err = allow_smem(flash_fwd_wgmma_kernel, kTcSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_wgmma_kernel<<<dim3(bh, (sq + kTcBQ - 1) / kTcBQ), kTcThreads, kTcSmemBytes, s>>>(
        q_map, k_map, v_map, static_cast<float*>(pv), static_cast<float*>(m),
        static_cast<float*>(l), sq, d, scale, causal, q_offset, k_offset, sq_real, sk_real);
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
