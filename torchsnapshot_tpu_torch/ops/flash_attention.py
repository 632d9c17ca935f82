"""Flash-attention forward partials (K3) for the ring-attention step.

Counterpart of ``torchsnapshot_tpu/ops/flash_attention.py``'s forward:
the Pallas ``_attend_kernel`` becomes the hand-written CUDA kernel in
``csrc/flash_attention_fwd.cu``.  The contract is the JAX one:

- ``attend_partials`` (``_flash_partials_jit``): q [bh, sq, d], k/v
  [bh, sk, d] → f32 (pv [bh, sq, d], raw row max m [bh, sq], row
  sum-exp l [bh, sq]), causal mask on global positions, rows ≥ sq_real
  and columns ≥ sk_real masked;
- ``flash_attention_partials`` ([b, s, h, d] layout, with
  ``_partials_impl``'s post-processing: pv cast to v's dtype, m_safe,
  valid = l > 0) and the normalised ``flash_attention``.

The backward kernels (dq, dk/dv) belong to the training slice.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from . import kernels

LAUNCHES = {"flash_fwd": 0}
_COUNT_LOCK = threading.Lock()


def attend_partials_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, k_offset: int, causal: bool, scale: float,
    sq_real: int, sk_real: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3: ``_block_attend`` of the ring module with the
    kernel's sq_real/sk_real masks, in f32 throughout as the kernel
    computes (q scaled in f32 before the product)."""
    sq, sk = q.shape[1], k.shape[1]
    scores = torch.matmul(q.float() * scale, k.float().transpose(1, 2))
    rows = torch.arange(sq, device=q.device)
    cols = torch.arange(sk, device=q.device)
    mask = (rows[:, None] < sq_real) & (cols[None, :] < sk_real)
    if causal:
        mask = mask & ((q_offset + rows)[:, None] >= (k_offset + cols)[None, :])
    scores = torch.where(mask, scores, float("-inf"))
    if sk:
        m = scores.amax(dim=-1)
    else:
        m = torch.full(scores.shape[:2], float("-inf"), device=q.device)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(scores - m_safe[..., None]), 0.0)
    return torch.matmul(p, v.float()), m, p.sum(dim=-1)


def attend_partials(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, k_offset: int, causal: bool, scale: float,
    sq_real: Optional[int] = None, sk_real: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward partials (pv f32, raw m, l) of q [bh, sq, d] against k/v
    [bh, sk, d]; ``sq_real``/``sk_real`` default to the full lengths."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sq_real = sq if sq_real is None else int(sq_real)
    sk_real = sk if sk_real is None else int(sk_real)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attend_partials_plain(
            q, k, v, q_offset, k_offset, causal, scale, sq_real, sk_real
        )
    device = q.device
    if (
        device.type != "cuda"
        or k.device != device
        or v.device != device
    ):
        raise ValueError("attend_partials: q, k and v must share one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
        q.dtype == k.dtype == v.dtype
    ):
        raise ValueError(
            f"attend_partials takes bf16 or f32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 3 or k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(
            f"attend_partials shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attend_partials takes contiguous q/k/v")
    lib = kernels.lib("flash_attention_fwd")
    if d > lib.tsnp_flash_fwd_max_head_dim():
        raise ValueError(f"head dim {d} above the kernel's maximum")
    pv = torch.empty((bh, sq, d), dtype=torch.float32, device=device)
    m = torch.empty((bh, sq), dtype=torch.float32, device=device)
    l = torch.empty((bh, sq), dtype=torch.float32, device=device)
    if bh and sq:
        rc = lib.tsnp_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            pv.data_ptr(), m.data_ptr(), l.data_ptr(),
            bh, sq, sk, d, float(scale), int(bool(causal)),
            int(q_offset), int(k_offset), sq_real, sk_real,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream,
        )
        kernels.check(rc, "flash_fwd")
        with _COUNT_LOCK:
            LAUNCHES["flash_fwd"] += 1
    return pv, m, l


def _to_bh(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def flash_attention_partials(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, k_offset: int, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """q: [b, sq, h, d]; k/v: [b, sk, h, d].  Returns (pv [b, sq, h, d]
    in v's dtype, m_safe [b, h, sq], l [b, h, sq], valid [b, h, sq])."""
    b, sq, h, d = q.shape
    pv, m, l = attend_partials(
        _to_bh(q), _to_bh(k), _to_bh(v), q_offset, k_offset, causal, scale
    )
    pv = pv.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(v.dtype)
    m = m.reshape(b, h, sq)
    l = l.reshape(b, h, sq)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    # a fully-masked row has every softmax term zeroed → l == 0
    return pv, m_safe, l, l > 0.0


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Normalised flash attention on one shard: [b, s, h, d] → same."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    pv, _, l, _ = flash_attention_partials(q, k, v, 0, 0, causal, scale)
    denom = torch.where(l == 0.0, 1.0, l)  # fully-masked rows → 0 output
    out = pv.float() / denom.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)
