"""Differentiable collectives shared by the pipeline and ring attention.

Counterparts of what the JAX package writes inline under ``shard_map``:

- ``ppermute(t, group, shift)``: ``lax.ppermute`` with the ring
  permutation ``i → (i + shift) % n`` (``parallel/ring_attention.py``
  rotates k/v with it, ``parallel/pipeline.py`` the in-flight
  activations).  Forward sends to ``(i + shift) % n`` and receives from
  ``(i - shift) % n`` as paired ``isend``/``irecv``, so two ranks that
  exchange with each other do not deadlock; backward is the same
  exchange with ``-shift``.
- ``broadcast_from(t, group, src)``: the pipeline's masked ``lax.psum``
  that hands every rank the last stage's outputs.  Its backward hands
  rank ``src`` the gradient its own replicated loss gives and every
  other rank zeros, with no communication.  That is the JAX transpose:
  ``shard_map(check_rep=False)`` divides an unmapped output's cotangent
  by the axis size and ``psum`` transposes to ``psum``, so the masked
  source receives the cotangent once.  An ``all_reduce`` of the
  gradients would count the n identical losses n times.

``all_reduce_sum`` is the in-place sum the row-sharded embedding lookup
of ``models/dlrm.py`` runs in its forward.  Every wait is bounded by the
process group's own timeout.  Gloo's
point-to-point ops take host tensors only, so a CUDA tensor is staged
through pinned host buffers here (and only here); both directions of a
staged exchange use one synchronous host copy each.
"""

from __future__ import annotations

import datetime
from typing import Any, Optional

import torch
import torch.distributed as dist


def group_timeout(group: Optional[Any] = None) -> datetime.timedelta:
    """The timeout ``group`` (the default group for None) was created
    with: every wait on its work is bounded by it."""
    pg = group if group is not None else dist.group.WORLD
    for device in ("cpu", "cuda"):
        try:
            return pg._get_backend(torch.device(device)).options._timeout
        except (AttributeError, RuntimeError):
            continue
    raise RuntimeError(f"cannot read the timeout of the {dist.get_backend(pg)} process group")


def _wait(works, group: Optional[Any]) -> None:
    timeout = group_timeout(group)
    for w in works:
        w.wait(timeout)


def all_reduce_sum(t: torch.Tensor, group: Optional[Any] = None) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, in place (not
    differentiable), within the group's timeout."""
    _wait([dist.all_reduce(t, group=group, async_op=True)], group)
    return t


def _host_staged(group: Optional[Any], t: torch.Tensor) -> bool:
    """Whether ``t`` must cross ``group`` through host memory (gloo
    moves host tensors only on its point-to-point ops)."""
    return t.device.type != "cpu" and dist.get_backend(group) == dist.Backend.GLOO


def _global(group: Optional[Any], rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def exchange(t: torch.Tensor, group: Optional[Any], shift: int) -> torch.Tensor:
    """Send ``t`` to the rank ``shift`` steps on around ``group``'s ring
    and return what the rank ``shift`` steps back sent (not
    differentiable; ``ppermute`` is)."""
    n = dist.get_world_size(group)
    if n == 1 or shift % n == 0:
        return t.clone()
    me = dist.get_rank(group)
    dst, src = (_global(group, (me + s) % n) for s in (shift, -shift))
    t = t.contiguous()
    if _host_staged(group, t):
        send = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        recv = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    else:
        send, recv = t, torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    _wait(dist.batch_isend_irecv(ops), group)
    return recv.to(t.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, shift):
        ctx.group, ctx.shift = group, shift
        return exchange(t, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return exchange(grad, ctx.group, -ctx.shift), None, None


def ppermute(t: torch.Tensor, group: Optional[Any] = None, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` over ``group``'s ring with ``perm = [(i, (i +
    shift) % n)]``: this rank's ``t`` goes ``shift`` ranks on, and the
    result is what came from ``shift`` ranks back.  Differentiable:
    the gradient takes the way back."""
    return _PPermute.apply(t, group, shift)


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, src):
        ctx.is_src = dist.get_rank(group) == src
        out = t.detach().clone(memory_format=torch.contiguous_format)
        work = dist.broadcast(out, _global(group, src), group=group, async_op=True)
        _wait([work], group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.is_src else torch.zeros_like(grad)), None, None


def broadcast_from(t: torch.Tensor, group: Optional[Any] = None, src: int = 0) -> torch.Tensor:
    """Every rank of ``group`` gets rank ``src``'s ``t`` (``src`` is a
    rank of the group).  Backward: the source takes this rank's
    gradient of its own replicated loss, the others zeros (see the
    module docstring for why not a sum)."""
    return _BroadcastFrom.apply(t, group, src)
