"""Ring attention: exact attention over sequence shards.

Counterpart of ``torchsnapshot_tpu/parallel/ring_attention.py``.  Each
rank holds a ``[batch, seq_local, heads, head_dim]`` shard of q/k/v; the
k/v shards rotate around the ring while the softmax accumulates online,
so no rank materialises the full attention matrix.  Every step's block
attention is the flash-attention partials (K3 forward, K4/K5 backward
on CUDA tensors, their plain versions on CPU tensors; there is no knob
and no fallback), and the accumulator is torch ops, so the output is
differentiable in q, k and v end to end, as ``ring_attention_shard``
is in the JAX package.

The ring size comes from ``torch.distributed`` (1 when no process group
is initialised).  Each rank's k/v shard moves one rank on around the
ring after every step but the last, k and v in one exchange
(``collectives.ppermute``, the counterpart of ``lax.ppermute``, which
stages CUDA tensors through pinned host memory on gloo); the JAX scan's
last rotation feeds nothing and is skipped.  At step ``t`` rank ``i``
holds rank ``(i - t) % n``'s block, so its key offset is that rank's; a
block wholly above the causal diagonal is still computed, as in the JAX
package, and its partials enter the accumulator with weight zero.
Gradients take the rotations back (``ppermute``'s backward), in reverse
step order.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..ops.flash_attention import flash_attention_partials
from .collectives import ppermute


def _ring_position(group: Optional[Any]) -> tuple:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def ring_attention_shard(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Optional[Any] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Exact attention of this rank's q shard over every rank's k/v
    shard; returns the local output shard in q's dtype."""
    n, my_idx = _ring_position(group)
    s_local = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    b, _, h, d = q.shape
    acc = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, h, s_local), float("-inf"), device=q.device)
    l_run = torch.zeros((b, h, s_local), device=q.device)
    k_cur, v_cur = k, v
    for step_idx in range(n):
        src = (my_idx - step_idx) % n  # whose block we currently hold
        pv, m_blk, l_blk, valid = flash_attention_partials(
            q, k_cur, v_cur,
            q_offset=my_idx * s_local,
            k_offset=src * s_local,
            causal=causal,
            scale=scale,
        )
        m_blk = torch.where(valid, m_blk, float("-inf"))
        m_new = torch.maximum(m_run, m_blk)
        m_new_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        corr_run = torch.where(
            torch.isfinite(m_run), torch.exp(m_run - m_new_safe), 0.0
        )
        corr_blk = torch.where(
            torch.isfinite(m_blk), torch.exp(m_blk - m_new_safe), 0.0
        )
        l_run = l_run * corr_run + l_blk * corr_blk
        acc = (
            acc * corr_run.permute(0, 2, 1)[..., None]
            + pv.float() * corr_blk.permute(0, 2, 1)[..., None]
        )
        m_run = m_new
        if step_idx + 1 < n:
            # one exchange a step carries k and v together: each step's
            # backward exchange waits for the next step's, so every rank
            # runs them in the same (reverse) order
            k_cur, v_cur = ppermute(torch.stack((k_cur, v_cur)), group).unbind(0)
    denom = torch.where(l_run == 0.0, 1.0, l_run)
    out = acc / denom.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: Optional[Any] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Ring attention over the sequence shards held by ``group``'s ranks
    (each call passes its own shard)."""
    return ring_attention_shard(q, k, v, group=group, causal=causal)


def dense_attention(q, k, v, causal: bool = True):
    """Single-device reference implementation (the test oracle)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).float()
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (
            torch.arange(sq, device=q.device)[:, None]
            >= torch.arange(sk, device=q.device)[None, :]
        )
        scores = torch.where(mask[None, None], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
