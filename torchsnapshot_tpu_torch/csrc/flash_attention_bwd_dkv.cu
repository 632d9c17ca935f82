// K5, flash-attention backward, dk and dv: for q [bh, sq, d] and k/v
// [bh, sk, d] (bf16 or f32, d <= 128), the forward's saved row max m
// [bh, sq] (f32, m_safe) and the cotangents gpv [bh, sq, d] (bf16 for
// bf16 q/k/v, f32 for f32 ones) and gl [bh, sq] (f32):
//
//   p_ij  = exp(scale q_i.k_j - m_i) on visible (i, j), 0 elsewhere
//   dv_j  = sum_i p_ij gpv_i                                     (f32 out)
//   dk_j  = sum_i ds_ij (scale q_i),  ds_ij = p_ij (gpv_i.v_j + gl_i)
//
// with the causal mask on global positions and rows >= sq_real / columns
// >= sk_real masked, as the forward (K3) masks them.  The g_m term of
// the gradient is applied outside the kernel (see K4's ``amax``).
//
// Replaces: torchsnapshot_tpu/ops/flash_attention.py, ``_bwd_dkv_kernel``
// (launched by ``_flash_bwd_jit`` through ``pl.pallas_call``).  The TPU
// kernel runs a transposed grid whose innermost axis is the q block,
// accumulating dk/dv in VMEM scratch.  Here the design stays transposed:
// one thread block owns a 128-row kv tile and walks the q tiles in a
// loop, with dk and dv accumulated in registers, so no two blocks write
// one output row and there are no float atomics: the result is the same
// on every run.
//
// Bound on this card: at the ring-attention shape (bh = 32, s = 2048,
// d = 128, causal) the kernel recomputes the scores and gpv.v and runs
// the dv and dk products, 8 d operations per causal pair: ~69 GFLOP
// against ~0.1 GB of operands, so it is bound by operations: ~0.070 ms
// at 989 TFLOP/s.
//
// - bf16 inputs (d % 8 == 0, 16-byte aligned q/k/v/gpv; the wrapper pads
//   the head dim otherwise): the four products on the tensor cores
//   through ``wgmma`` (bf16 in, f32 accumulate), warp-specialised.  A
//   block is two consumer warpgroups, each owning 64 kv rows, and one
//   producer warp.  The producer loads the block's k and v tiles once
//   and then streams the 64-row q and gpv tiles of each q step through
//   a ring of stages by TMA (128-byte swizzle, rows and columns past the
//   arrays zero-filled), staging m (log2 units) and gl of the step's
//   rows beside them; ``mbarrier``s hand each stage to the consumers and
//   back.  A consumer computes s^T = k q^T and gv^T = v gpv^T with both
//   operands in shared memory, so p^T and ds^T come out in the
//   accumulator layout that ``wgmma`` takes as a register A operand:
//   dv += p^T gpv and dk += ds^T q read gpv and q transposed (MN-major)
//   from the same tiles.  The two score products are separate commit
//   groups, so exp over s^T runs while gv^T is computed; the softmax
//   code has no branch per element (a visible q range per kv row and
//   step, none tested on steps that see every pair).  dk and dv (64 x
//   128 f32 each per warpgroup) stay in registers under ``setmaxnreg``.  Blocks are launched lowest
//   kv tile first: under the causal mask those see the most q rows.
// - f32 inputs: plain f32 FMAs on the CUDA cores.
//
// Causal q steps entirely before a warpgroup's kv rows are skipped.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace tsnp_flash;
using namespace tsnp_hopper;

// ---------------------------------------------------------- bf16 (wgmma)

constexpr int kTcBK = 128;  // kv rows per block: two consumer warpgroups x 64
constexpr int kTcBQ = 64;   // q rows per step
constexpr int kStages = 2;
constexpr int kConsumerThreads = 256;
constexpr int kTcThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr uint32_t kKvPanel = kTcBK * kRowBytes;    // one 64-column panel of k or v
constexpr uint32_t kKvTile = 2 * kKvPanel;
constexpr uint32_t kQPanel = kTcBQ * kRowBytes;
constexpr uint32_t kQTile = 2 * kQPanel;
// shared memory: the k tile, the v tile, the stages (q tile, gpv tile),
// m (log2 units) and gl of each stage's rows, the barriers
constexpr uint32_t kStageBytes = 2 * kQTile;
constexpr uint32_t kStageOff = 2 * kKvTile;
constexpr uint32_t kRowVecOff = kStageOff + kStages * kStageBytes;
constexpr uint32_t kBarOff = kRowVecOff + kStages * 2 * kTcBQ * sizeof(float);
constexpr size_t kTcSmemBytes = kBarOff + (1 + 2 * kStages) * sizeof(uint64_t) + kAtomBytes;

__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap g_map, const float* __restrict__ m,
                     const float* __restrict__ gl, float* __restrict__ dk_out,
                     float* __restrict__ dv_out, int sq, int sk, int d, float scale, int causal,
                     long long q_offset, long long k_offset, int sq_real, int sk_real) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = smem + kKvTile;
  float* rowvec = reinterpret_cast<float*>(smem + kRowVecOff);  // stage s at 2s * kTcBQ
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTcBK;
  // q rows that can see this tile: from the causal diagonal to sq_real
  const int q_first = k0 < sk_real ? q_begin(k0, causal, q_offset, k_offset) : sq_real;
  const int q_lo = (q_first < sq_real ? q_first : sq_real) / kTcBQ * kTcBQ;
  const int n_steps = (sq_real - q_lo + kTcBQ - 1) / kTcBQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer: one warp; its lanes stage m and gl, lane 0 the tiles
    regs_dec<24>();
    if (threadIdx.x >= kConsumerThreads + 32) return;
    const int lane = threadIdx.x & 31;
    if (n_steps > 0 && lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * kKvTile);
      tma_load_tile(ks, kKvPanel, &k_map, kv_full, k0, bh);
      tma_load_tile(vs, kKvPanel, &v_map, kv_full, k0, bh);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);  // round 0 passes at once
      const int q0 = q_lo + i * kTcBQ;
      float* m2s = rowvec + s * 2 * kTcBQ;
      for (int r = lane; r < kTcBQ; r += 32) {
        const size_t at = static_cast<size_t>(bh) * sq + q0 + r;
        const bool in = q0 + r < sq;
        m2s[r] = in ? m[at] * kLog2e : 0.f;
        m2s[kTcBQ + r] = in ? gl[at] : 0.f;
      }
      if (lane == 0) {
        unsigned char* stage = smem + kStageOff + s * kStageBytes;
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        tma_load_tile(stage, kQPanel, &q_map, &full[s], q0, bh);
        tma_load_tile(stage + kQTile, kQPanel, &g_map, &full[s], q0, bh);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns kv rows r0 .. r0 + 63
    regs_inc<240>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = k0 + wg * 64;
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};  // this thread's kv rows
    // the first q row that sees any of them (none past sk_real)
    const int wq_first = r0 < sk_real ? q_begin(r0, causal, q_offset, k_offset) : 0x7fffffff;
    const float scale2 = scale * kLog2e;
    const unsigned char* kw = ks + wg * 64 * kRowBytes;
    const unsigned char* vw = vs + wg * 64 * kRowBytes;

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    if (n_steps > 0) mbar_wait(kv_full, 0);

    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const int q0 = q_lo + i * kTcBQ;
      if (q0 + kTcBQ > wq_first) {
        const unsigned char* qs = smem + kStageOff + s * kStageBytes;
        const unsigned char* gs = qs + kQTile;
        const float* m2s = rowvec + s * 2 * kTcBQ;
        const float* gls = m2s + kTcBQ;

        // s^T = k q^T and gv^T = v gpv^T: 64 kv rows x 64 q columns each
        float st[32], gt[32];
        wgmma_score_pair(st, gt, kw, vw, kKvPanel, qs, gs, kQPanel);
        wgmma_wait<1>();  // s^T is done, gv^T may still run
        fence_regs(st);

        // p^T while gv^T runs; element 4j + e: kv row rows[e >> 1], q row
        // q0 + 8j + 2t + (e & 1); kv row rows[h] is seen by the step's q
        // rows [lo[h], hi)
        const int hi = sq_real - q0 < kTcBQ ? sq_real - q0 : kTcBQ;
        int lo[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          lo[h] = first_visible_row(rows[h], q0, kTcBQ, sk_real, causal, q_offset, k_offset);
        if (lo[0] == 0 && lo[1] == 0 && hi == kTcBQ) {  // most steps: every pair seen
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 8 * j + 2 * t + (e & 1);
              st[4 * j + e] = exp2_approx(st[4 * j + e] * scale2 - m2s[c]);  // p^T
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 8 * j + 2 * t + (e & 1);
              const float p = exp2_approx(st[4 * j + e] * scale2 - m2s[c]);
              st[4 * j + e] = c >= lo[e >> 1] && c < hi ? p : 0.f;  // p^T
            }
          }
        }
        wgmma_wait<0>();  // gv^T = v gpv^T is done
        fence_regs(gt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            gt[4 * j + e] = st[4 * j + e] * (gt[4 * j + e] + gls[c]);  // ds^T
          }
        }

        // dv += p^T gpv and dk += ds^T q over the step's 64 q rows
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc_to_a(pa[kk], &st[8 * kk], &st[8 * kk + 4]);
          acc_to_a(da[kk], &gt[8 * kk], &gt[8 * kk + 4]);
        }
        wgmma_rows_product(dv, pa, gs, kQPanel);
        wgmma_rows_product(dk, da, qs, kQPanel);
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      mbar_arrive(&empty[s]);  // this thread is done with the stage
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rows[h];
      if (r >= sk) continue;
      float* dkr = dk_out + (static_cast<size_t>(bh) * sk + r) * d;
      float* dvr = dv_out + (static_cast<size_t>(bh) * sk + r) * d;
#pragma unroll
      for (int n = 0; n < kDMax / 8; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < d) {
          *reinterpret_cast<float2*>(dkr + c) =
              make_float2(dk[4 * n + 2 * h] * scale, dk[4 * n + 2 * h + 1] * scale);
          *reinterpret_cast<float2*>(dvr + c) = make_float2(dv[4 * n + 2 * h], dv[4 * n + 2 * h + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- f32 (FMA)

constexpr int kBK = 16;  // kv rows per thread block
constexpr int kBQ = 32;  // q rows per inner step
constexpr int kThreads = 128;
constexpr int kQStride = kDMax + 1;  // pad: rows read across lanes
constexpr int kPStride = kBQ + 1;
constexpr size_t kSmemFloats = 2 * kBK * kQStride + 2 * kBQ * kQStride + 2 * kBK * kPStride + 2 * kBQ;

__global__ void __launch_bounds__(kThreads)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ m,
                   const float* __restrict__ gpv, const float* __restrict__ gl,
                   float* __restrict__ dk_out, float* __restrict__ dv_out, int sq, int sk, int d,
                   float scale, int causal, long long q_offset, long long k_offset, int sq_real,
                   int sk_real) {
  extern __shared__ float smem[];
  float* ks = smem;                    // [kBK][kQStride]
  float* vs = ks + kBK * kQStride;     // [kBK][kQStride]
  float* qs = vs + kBK * kQStride;     // [kBQ][kQStride], pre-scaled
  float* gs = qs + kBQ * kQStride;     // [kBQ][kQStride]
  float* ps = gs + kBQ * kQStride;     // [kBK][kPStride]: p^T
  float* dss = ps + kBK * kPStride;    // [kBK][kPStride]: ds^T
  float* ms = dss + kBK * kPStride;    // [kBQ]
  float* gls = ms + kBQ;               // [kBQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int r = tid >> 3;  // this thread's kv row in the block
  const int cx = tid & 7;  // q cols cx + 8j; d cols cx + 8j
  const int col = k0 + r;

  const float* qb = q + static_cast<size_t>(bh) * sq * d;
  const float* gb = gpv + static_cast<size_t>(bh) * sq * d;
  const float* kb = k + static_cast<size_t>(bh) * sk * d;
  const float* vb = v + static_cast<size_t>(bh) * sk * d;

  for (int idx = tid; idx < kBK * kDMax; idx += kThreads) {
    const int rr = idx / kDMax, c = idx % kDMax;
    const bool in = k0 + rr < sk && c < d;
    const size_t off = static_cast<size_t>(k0 + rr) * d + c;
    ks[rr * kQStride + c] = in ? kb[off] : 0.f;
    vs[rr * kQStride + c] = in ? vb[off] : 0.f;
  }

  float dk[kDMax / 8], dv[kDMax / 8];
#pragma unroll
  for (int j = 0; j < kDMax / 8; ++j) dk[j] = dv[j] = 0.f;

  const int q_first = k0 < sk_real ? q_begin(k0, causal, q_offset, k_offset) : sq_real;
  const int q_lo = (q_first < sq_real ? q_first : sq_real) / kBQ * kBQ;
  for (int q0 = q_lo; q0 < sq_real; q0 += kBQ) {
    __syncthreads();  // the previous step is done with qs/gs/ps/dss
    for (int idx = tid; idx < kBQ * kDMax; idx += kThreads) {
      const int rr = idx / kDMax, c = idx % kDMax;
      const bool in = q0 + rr < sq && c < d;
      const size_t off = static_cast<size_t>(q0 + rr) * d + c;
      qs[rr * kQStride + c] = in ? qb[off] * scale : 0.f;
      gs[rr * kQStride + c] = in ? gb[off] : 0.f;
    }
    if (tid < kBQ) {
      const int i = q0 + tid;
      ms[tid] = i < sq ? m[static_cast<size_t>(bh) * sq + i] : 0.f;
      gls[tid] = i < sq ? gl[static_cast<size_t>(bh) * sq + i] : 0.f;
    }
    __syncthreads();

    float s[kBQ / 8], gv[kBQ / 8];
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) s[j] = gv[j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kv = ks[r * kQStride + c], vv = vs[r * kQStride + c];
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
        s[j] = fmaf(qs[(cx + 8 * j) * kQStride + c], kv, s[j]);
        gv[j] = fmaf(gs[(cx + 8 * j) * kQStride + c], vv, gv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const int i = cx + 8 * j;
      const bool vis = visible(q0 + i, col, sq_real, sk_real, causal, q_offset, k_offset);
      const float p = vis ? expf(s[j] - ms[i]) : 0.f;
      ps[r * kPStride + i] = p;
      dss[r * kPStride + i] = p * (gv[j] + gls[i]);
    }
    __syncthreads();  // ps/dss are complete

    for (int i = 0; i < kBQ; ++i) {
      const float p = ps[r * kPStride + i], ds = dss[r * kPStride + i];
#pragma unroll
      for (int j = 0; j < kDMax / 8; ++j) {
        dv[j] = fmaf(p, gs[i * kQStride + cx + 8 * j], dv[j]);
        dk[j] = fmaf(ds, qs[i * kQStride + cx + 8 * j], dk[j]);
      }
    }
  }

  if (col >= sk) return;
  const size_t out_row = static_cast<size_t>(bh) * sk + col;
#pragma unroll
  for (int j = 0; j < kDMax / 8; ++j) {
    const int c = cx + 8 * j;
    if (c < d) {
      dk_out[out_row * d + c] = dk[j];
      dv_out[out_row * d + c] = dv[j];
    }
  }
}

}  // namespace


// q: [bh, sq, d], k/v: [bh, sk, d], contiguous, bf16 (is_bf16 = 1) or
// f32; m, gl: f32 [bh, sq]; gpv: [bh, sq, d] in q's dtype; dk, dv: f32
// [bh, sk, d].  The bf16 path takes d % 8 == 0 and 16-byte aligned
// q, k, v and gpv (what TMA reads).  Launches on ``stream`` and returns
// cudaGetLastError() (0 when there is nothing to launch).
extern "C" int tsnp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* m,
                                  const void* gpv, const void* gl, void* dk, void* dv, int bh,
                                  int sq, int sk, int d, float scale, int causal,
                                  long long q_offset, long long k_offset, int sq_real,
                                  int sk_real, int is_bf16, void* stream) {
  if (d < 1 || d > kDMax || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || sk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if (d % 8 != 0 || !aligned16(q, k, v, gpv)) return static_cast<int>(cudaErrorInvalidValue);
    if (sq <= 0) {  // no q row: dk = dv = 0
      const size_t bytes = static_cast<size_t>(bh) * sk * d * sizeof(float);
      err = cudaMemsetAsync(dk, 0, bytes, s);
      if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, s);
      return static_cast<int>(err);
    }
    CUtensorMap q_map, k_map, v_map, g_map;
    if (!make_tile_map(&q_map, q, bh, sq, d, kTcBQ) || !make_tile_map(&k_map, k, bh, sk, d, kTcBK) ||
        !make_tile_map(&v_map, v, bh, sk, d, kTcBK) || !make_tile_map(&g_map, gpv, bh, sq, d, kTcBQ))
      return static_cast<int>(cudaErrorNotSupported);
    err = allow_smem(bwd_dkv_wgmma_kernel, kTcSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_dkv_wgmma_kernel<<<dim3(bh, (sk + kTcBK - 1) / kTcBK), kTcThreads, kTcSmemBytes, s>>>(
        q_map, k_map, v_map, g_map, static_cast<const float*>(m), static_cast<const float*>(gl),
        static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d, scale, causal, q_offset,
        k_offset, sq_real, sk_real);
  } else {
    const size_t smem = kSmemFloats * sizeof(float);
    err = allow_smem(bwd_dkv_f32_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_dkv_f32_kernel<<<dim3((sk + kBK - 1) / kBK, bh), kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(m), static_cast<const float*>(gpv),
        static_cast<const float*>(gl), static_cast<float*>(dk), static_cast<float*>(dv), sq, sk,
        d, scale, causal, q_offset, k_offset, sq_real, sk_real);
  }
  return static_cast<int>(cudaGetLastError());
}
