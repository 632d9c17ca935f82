"""Pipeline parallelism: GPipe-style microbatched stages over a mesh dim.

Counterpart of ``torchsnapshot_tpu/parallel/pipeline.py``.  Stage s
holds layer s's weights (``w`` [S, d, d] and ``b`` [S, d], DTensors
``Shard(0)`` over the ``"pp"`` dim of a ``DeviceMesh``); activations move
stage to stage with ``collectives.ppermute`` while a Python loop walks
the lockstep ``n_microbatches + n_stages - 1``-step schedule, and the
last stage's outputs reach every rank through ``broadcast_from`` (the
JAX package's masked ``psum``).  Each stage is one MLP block
``h = relu(h @ W + b)``.  The per-stage weights are the pp-sharded
tensors the checkpointer saves and restores onto another depth or a
replicated eval topology.

The data flow is the same on every rank, as under ``shard_map``: every
rank-dependent choice is a ``torch.where`` on a tensor condition, never
a Python branch on the rank.  So every rank's graph holds every
exchange, and the backward runs the same exchanges on every rank; a
branch that dropped stage 0's received activation would leave its
exchange's backward unrun there and the previous stage waiting out its
deadline.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from .collectives import broadcast_from, ppermute
from .mesh import distribute, placements_from_spec


def init_pipeline_params(
    n_stages: int, d_model: int, dtype: torch.dtype = torch.float32,
    seed: Union[int, torch.Generator] = 0, device: Any = "cuda",
) -> Dict[str, torch.Tensor]:
    """Per-stage MLP weights, leading dim = stage (shard it with
    ``shard_pipeline_params``): ``w`` normal / sqrt(d_model), ``b``
    zeros.  ``seed`` is an int or a CPU ``torch.Generator``; the draw is
    made on the host, so it is the same on every device."""
    g = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    w = torch.randn((n_stages, d_model, d_model), generator=g, dtype=dtype)
    w = w * torch.tensor(1.0 / d_model ** 0.5, dtype=dtype)
    b = torch.zeros((n_stages, d_model), dtype=dtype)
    return {"w": w.to(device), "b": b.to(device)}


def sequential_forward(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Oracle: apply the stages in order without any parallelism."""
    h = x
    for s in range(params["w"].shape[0]):
        h = torch.relu(h @ params["w"][s] + params["b"][s])
    return h


def _stage_local(p: Any) -> torch.Tensor:
    """This rank's stage of a stage-sharded parameter ([1, ...])."""
    from torch.distributed.tensor import DTensor

    local = p.to_local() if isinstance(p, DTensor) else p
    if local.shape[0] != 1:
        raise ValueError(f"a rank holds {local.shape[0]} stages; shard the stage dim one a rank")
    return local[0]


def pipeline_forward(
    params: Dict[str, Any], x: torch.Tensor, mesh: Any, axis_name: str = "pp",
    n_microbatches: int = 4,
) -> torch.Tensor:
    """Microbatched pipeline forward over ``mesh[axis_name]``.

    params: {"w": [S, d, d], "b": [S, d]} sharded ``Shard(0)`` over
    ``axis_name``; x: [B, d] (B divisible by n_microbatches), the same
    on every rank.  Returns [B, d] on every rank, the composition of the
    stages.  Differentiable in the stage weights."""
    from ..obs import span

    with span("pp/forward", axis=axis_name, n_microbatches=n_microbatches):
        return _pipeline_forward_impl(params, x, mesh, axis_name, n_microbatches)


def _pipeline_forward_impl(params, x, mesh, axis_name, n_microbatches):
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if params["w"].shape[0] != n_stages:
        # a user-facing precondition (weights restored onto a mesh of
        # another depth): a ValueError, so it holds under `python -O`
        raise ValueError(
            f"stage dim {params['w'].shape[0]} != pp axis size "
            f"{n_stages}; reshard the stage weights to the mesh depth"
        )
    batch, d = x.shape
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by {n_microbatches} microbatches")
    mb = batch // n_microbatches
    group = mesh.get_group(axis_name)
    idx = torch.tensor(mesh.get_local_rank(axis_name), device=x.device)
    w0, b0 = _stage_local(params["w"]), _stage_local(params["b"])
    micro = x.reshape(n_microbatches, mb, d)
    zeros = torch.zeros((mb, d), dtype=x.dtype, device=x.device)
    acts = zeros
    outs = [zeros] * n_microbatches
    n_steps = n_microbatches + n_stages - 1
    for t in range(n_steps):
        # stage 0 injects microbatch t (when in range); the others take
        # the activation the previous stage sent
        inject = micro[min(t, n_microbatches - 1)]
        h_in = torch.where(idx == 0, inject, acts)
        active = (t - idx >= 0) & (t - idx < n_microbatches)
        h_out = torch.where(active, torch.relu(h_in @ w0 + b0), zeros)
        # the LAST stage's output for microbatch t - S + 1 is final
        done = t - (n_stages - 1)
        if 0 <= done < n_microbatches:
            outs[done] = torch.where(idx == n_stages - 1, h_out, outs[done])
        if t + 1 < n_steps:
            # the last step's rotation feeds nothing and is skipped.  Each
            # step's h_out feeds the next step's exchange, so the backward
            # exchanges run in reverse step order on every rank
            acts = ppermute(h_out, group)
    out = torch.stack(outs).reshape(batch, d)
    return broadcast_from(out, group, n_stages - 1)


def pipeline_train_step(
    params: Dict[str, Any], x: torch.Tensor, y: torch.Tensor, mesh: Any,
    axis_name: str = "pp", n_microbatches: int = 4, lr: float = 0.1,
) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One SGD step of the mean squared error through the pipelined
    forward (gradients flow back through the exchanges); returns the new
    params and the step's loss.  There is no compiler here, so nothing
    is cached between calls (the JAX package caches a compiled step per
    mesh and schedule)."""
    from ..obs import span

    with span("pp/train_step", axis=axis_name, n_microbatches=n_microbatches):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        out = pipeline_forward(p, x, mesh, axis_name=axis_name, n_microbatches=n_microbatches)
        loss = torch.mean((out - y) ** 2)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            new = {k: (v - lr * g).detach() for (k, v), g in zip(p.items(), grads)}
        return new, loss.detach()


def shard_pipeline_params(
    params: Dict[str, torch.Tensor], mesh: Any, axis_name: str = "pp"
) -> Dict[str, Any]:
    """Place per-stage params with the stage dim sharded over
    ``axis_name`` (no collective: every rank holds the full params)."""
    names, shape = mesh.mesh_dim_names, mesh.shape
    return {
        "w": distribute(params["w"], mesh, placements_from_spec(names, shape, (axis_name, None, None))),
        "b": distribute(params["b"], mesh, placements_from_spec(names, shape, (axis_name, None))),
    }
