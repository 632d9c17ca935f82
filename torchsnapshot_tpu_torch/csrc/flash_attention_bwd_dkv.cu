// K5, flash-attention backward, dk and dv: for q [bh, sq, d] and k/v
// [bh, sk, d] (bf16 or f32, d <= 128), the forward's saved row max m
// [bh, sq] (f32, m_safe) and the cotangents gpv [bh, sq, d] and gl
// [bh, sq] (f32):
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
// one thread block owns a 64-row kv tile and walks the q tiles in a
// loop, with dk and dv accumulated in registers, so no two blocks write
// one output row and there are no float atomics: the result is the same
// on every run.
//
// Bound on this card: at the ring-attention shape (bh = 32, s = 2048,
// d = 128, causal) the kernel recomputes the scores and gpv.v and runs
// the dv and dk products, 8 d operations per causal pair: ~69 GFLOP
// against ~0.12 GB of operands, so it is bound by operations: ~0.070 ms
// at 989 TFLOP/s.
//
// - bf16 inputs: the four products on the tensor cores through
//   ``mma.sync`` m16n8k16 (bf16 in, f32 accumulate).  Four warps per
//   (bh, 64-row kv tile); each warp owns 16 kv rows and keeps its dk and
//   dv accumulators (2 x 16 x 128 f32) in registers, which is why a q
//   step is 32 rows.  The k and v tiles stay in shared memory for the
//   whole walk; the next q step's q tile and f32 gpv tile load by
//   cp.async (double-buffered) while this step computes, and m/gl
//   through registers; gpv is rounded to bf16 in shared memory at the
//   start of its step.  p^T and ds^T enter the dv and dk products in
//   bf16 straight from the accumulator registers.
// - f32 inputs: plain f32 FMAs on the CUDA cores.
//
// Causal q tiles entirely before the kv tile are never loaded.
#include "flash_common.cuh"

namespace {

using namespace tsnp_flash;

// ------------------------------------------------------------ bf16 (mma)

constexpr int kMmaBK = 64;  // kv rows per block: 4 warps x 16 rows
constexpr int kMmaBQ = 32;  // q rows per step
constexpr int kMmaThreads = 128;
constexpr int kKvElems = kMmaBK * kLd;
constexpr int kQElems = kMmaBQ * kLd;
// k tile, v tile, two q tiles, the bf16 gpv tile, then two f32 gpv
// staging tiles, m (log2 units) and gl per q row
constexpr size_t kMmaSmemBytes = (2 * kKvElems + 3 * kQElems) * sizeof(__nv_bfloat16) +
                                 (2 * kMmaBQ * kDMax + 2 * kMmaBQ) * sizeof(float);

__global__ void __launch_bounds__(kMmaThreads)
bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ m,
                   const float* __restrict__ gpv, const float* __restrict__ gl,
                   float* __restrict__ dk_out, float* __restrict__ dv_out, int sq, int sk, int d,
                   float scale, int causal, long long q_offset, long long k_offset, int sq_real,
                   int sk_real, int vec_loads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kKvElems;
  __nv_bfloat16* qbuf = vs + kKvElems;  // step i's q tile at (i & 1) * kQElems
  __nv_bfloat16* gs = qbuf + 2 * kQElems;
  float* gstage = reinterpret_cast<float*>(gs + kQElems);  // (i & 1) * kMmaBQ * kDMax
  float* m2s = gstage + 2 * kMmaBQ * kDMax;
  float* gls = m2s + kMmaBQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kMmaBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * d;
  const float* gb = gpv + static_cast<size_t>(bh) * sq * d;
  const float* mb = m + static_cast<size_t>(bh) * sq;
  const float* glb = gl + static_cast<size_t>(bh) * sq;
  const bool vec = vec_loads != 0;
  const float scale2 = scale * kLog2e;

  load_tile(ks, k + static_cast<size_t>(bh) * sk * d, k0, kMmaBK, sk, d, vec);
  load_tile(vs, v + static_cast<size_t>(bh) * sk * d, k0, kMmaBK, sk, d, vec);
  cp_async_commit();

  float dk[kDMax / 8][4], dv[kDMax / 8][4];
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  const int cols[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};  // this thread's kv rows
  const __nv_bfloat16* kw = ks + warp * 16 * kLd;
  const __nv_bfloat16* vw = vs + warp * 16 * kLd;

  // q rows that can see this tile: from the causal diagonal to sq_real
  const int q_first = k0 < sk_real ? q_begin(k0, causal, q_offset, k_offset) : sq_real;
  const int q_lo = (q_first < sq_real ? q_first : sq_real) / kMmaBQ * kMmaBQ;
  const int n_steps = (sq_real - q_lo + kMmaBQ - 1) / kMmaBQ;
  // step i's loads: q (and, with ``vec``, f32 gpv) by cp.async into
  // buffer i & 1, m and gl into registers
  float m_next = 0.f, gl_next = 0.f;
  auto issue = [&](int i) {
    const int q0 = q_lo + i * kMmaBQ;
    load_tile(qbuf + (i & 1) * kQElems, qb, q0, kMmaBQ, sq, d, vec);
    if (vec) load_tile_f32_async(gstage + (i & 1) * kMmaBQ * kDMax, gb, q0, kMmaBQ, sq, d);
    const int r = q0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < kMmaBQ && r < sq) {
      m_next = mb[r] * kLog2e;
      gl_next = glb[r];
    } else {
      m_next = gl_next = 0.f;
    }
  };
  if (n_steps > 0) issue(0);
  cp_async_commit();

  for (int step = 0; step < n_steps; ++step) {
    const int q0 = q_lo + step * kMmaBQ;
    const __nv_bfloat16* qs = qbuf + (step & 1) * kQElems;
    // the previous step's readers of m2s/gls passed its closing barrier
    if (threadIdx.x < kMmaBQ) {
      m2s[threadIdx.x] = m_next;
      gls[threadIdx.x] = gl_next;
    }
    if (step + 1 < n_steps) issue(step + 1);
    cp_async_commit();
    cp_async_wait_one();  // this step's group (and k/v) has landed
    __syncthreads();
    if (vec) {
      convert_tile_f32(gs, gstage + (step & 1) * kMmaBQ * kDMax, kMmaBQ);
    } else {
      load_tile_f32(gs, gb, q0, kMmaBQ, sq, d);
    }
    __syncthreads();

    // s^T = k q^T and gv^T = v gpv^T: 16 kv rows x 32 q cols per warp
    float s[kMmaBQ / 8][4], gv[kMmaBQ / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaBQ / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = gv[n][0] = gv[n][1] = gv[n][2] = gv[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDMax / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, kw, kk * 16, g, t);
      load_a(va, vw, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kMmaBQ / 8; ++n) {
        const __nv_bfloat16* qr = qs + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[n], ka, ld_pair(qr), ld_pair(qr + 8));
        const __nv_bfloat16* gr = gs + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(gv[n], va, ld_pair(gr), ld_pair(gr + 8));
      }
    }

    // element e of a tile is kv row cols[e >> 1], q row q0 + n*8 + 2t + (e & 1)
    const bool masked = k0 + kMmaBK > sk_real || q0 + kMmaBQ > sq_real ||
                        (causal && k_offset + k0 + kMmaBK - 1 > q_offset + q0);
#pragma unroll
    for (int n = 0; n < kMmaBQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = n * 8 + 2 * t + (e & 1);
        const bool vis = !masked || visible(q0 + i, cols[e >> 1], sq_real, sk_real, causal,
                                            q_offset, k_offset);
        const float p = vis ? exp2f(s[n][e] * scale2 - m2s[i]) : 0.f;
        s[n][e] = p;                       // p^T
        gv[n][e] = p * (gv[n][e] + gls[i]);  // ds^T
      }
    }

    // dv += p^T gpv and dk += ds^T q over the 32 q rows of this step
#pragma unroll
    for (int j = 0; j < kMmaBQ / 16; ++j) {
      uint32_t a[4];
      acc_to_a(a, s[2 * j], s[2 * j + 1]);
      mma_rows_times_tile(dv, a, gs, j * 16, lane);
      acc_to_a(a, gv[2 * j], gv[2 * j + 1]);
      mma_rows_times_tile(dk, a, qs, j * 16, lane);
    }
    __syncthreads();  // frees this step's q buffer, gs and m2s/gls
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = cols[h];
    if (r >= sk) continue;
    const size_t row = static_cast<size_t>(bh) * sk + r;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < d) {
        dk_out[row * d + c] = dk[n][2 * h] * scale;
        dv_out[row * d + c] = dv[n][2 * h];
      }
      if (c + 1 < d) {
        dk_out[row * d + c + 1] = dk[n][2 * h + 1] * scale;
        dv_out[row * d + c + 1] = dv[n][2 * h + 1];
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
// f32; m, gl: f32 [bh, sq]; gpv: f32 [bh, sq, d]; dk, dv: f32
// [bh, sk, d].  Launches on ``stream`` and returns cudaGetLastError()
// (0 when there is nothing to launch).
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
    err = allow_smem(bwd_dkv_mma_kernel, kMmaSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int vec = (d % 8 == 0) && aligned16(q, k, v, gpv);
    bwd_dkv_mma_kernel<<<dim3((sk + kMmaBK - 1) / kMmaBK, bh), kMmaThreads, kMmaSmemBytes,
                         s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(m),
        static_cast<const float*>(gpv), static_cast<const float*>(gl), static_cast<float*>(dk),
        static_cast<float*>(dv), sq, sk, d, scale, causal, q_offset, k_offset, sq_real, sk_real,
        vec);
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
