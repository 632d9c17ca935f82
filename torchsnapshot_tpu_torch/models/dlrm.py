"""DLRM-style recommendation model: the embedding-parallel workload family.

Counterpart of ``torchsnapshot_tpu/models/dlrm.py``: embedding tables
row-sharded over every dim of a ``DeviceMesh`` (torchrec's ROW_WISE
layout, ``Shard(0)``), the bottom and top MLPs replicated, and a
dot-product feature interaction over the bottom MLP's output and the
looked-up embeddings.  The checkpointer sees the layout torchrec
produces, per-table row shards, and restores it at another world size.

Every rank feeds the same batch, as the JAX package's replicated batch
does.  A table lookup is ``_RowShardedLookup`` over the rank's own rows:
the ids outside them look up zeros, and a sum over the mesh gives each
row exactly (one term is the row, the others zero).  Its backward needs
no communication: the batch is replicated, so every rank holds the same
gradient of the embeddings and scatter-adds it into its own rows; the
replicated MLPs' gradients agree on every rank the same way.

Training is the JAX module's: ``make_train_state`` builds the model and
``torch.optim.Adagrad(lr=1e-2, initial_accumulator_value=0.1,
eps=1e-7)``, optax ``adagrad(1e-2)``'s defaults.  The one difference is
where ``eps`` sits: optax scales by ``rsqrt(sum + eps)``, torch divides
by ``sqrt(sum) + eps``; with every sum at least 0.1 the two differ by
about 2e-7 relative.  ``params_from_jax`` and ``adagrad_state_from_jax``
carry a flax parameter tree and its optax state into this module's
``state_dict`` and the optimizer's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum

LEARNING_RATE = 1e-2
INITIAL_ACCUMULATOR = 0.1
EPS = 1e-7


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    # one entry per sparse feature: number of embedding rows
    table_rows: Tuple[int, ...] = (1 << 16,) * 8
    embed_dim: int = 128
    dense_in: int = 13
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny() -> "DLRMConfig":
        return DLRMConfig(
            table_rows=(64, 32, 16),
            embed_dim=8,
            dense_in=4,
            bottom_mlp=(16, 8),
            top_mlp=(16, 1),
        )


def _local(p: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return p.to_local() if isinstance(p, DTensor) else p


def _mlp(layers: Sequence[nn.Linear], x: torch.Tensor) -> torch.Tensor:
    """The flax ``_MLP``: ReLU between layers, not after the last.  The
    replicated weights enter as this rank's local tensors."""
    for i, layer in enumerate(layers):
        x = F.linear(x, _local(layer.weight), _local(layer.bias))
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class _RowShardedLookup(torch.autograd.Function):
    """Rows ``ids`` of a table of which this rank holds rows [row0, row0
    + local.shape[0]); ``groups`` are the process groups whose sum covers
    every shard once."""

    @staticmethod
    def forward(ctx, local, ids, row0, groups):
        rel = ids - row0
        mine = (rel >= 0) & (rel < local.shape[0])
        safe = torch.where(mine, rel, 0)
        if local.shape[0]:
            out = torch.where(mine[:, None], local.index_select(0, safe), 0.0)
        else:
            out = torch.zeros((ids.shape[0], local.shape[1]), dtype=local.dtype, device=local.device)
        for g in groups:
            all_reduce_sum(out, g)
        ctx.save_for_backward(safe, mine)
        ctx.local_shape = local.shape
        return out

    @staticmethod
    def backward(ctx, grad):
        safe, mine = ctx.saved_tensors
        g_local = torch.zeros(ctx.local_shape, dtype=grad.dtype, device=grad.device)
        if ctx.local_shape[0]:
            g_local.index_add_(0, safe, torch.where(mine[:, None], grad, 0.0))
        return g_local, None, None, None


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)`` of a plain or DTensor table."""
    from torch.distributed.tensor import DTensor

    if not isinstance(table, DTensor):
        return table.index_select(0, ids)
    local = table.to_local()
    mesh = table.device_mesh
    sharded = [m for m, p in enumerate(table.placements) if p.is_shard()]
    if not sharded:
        return local.index_select(0, ids)
    if any(table.placements[m].dim != 0 for m in sharded):
        raise ValueError(f"a table is looked up row-sharded only, not {table.placements}")
    from ..preparers.sharded import box_at

    offsets, _ = box_at(tuple(table.shape), mesh.shape, mesh.get_coordinate(), table.placements)
    groups = [mesh.get_group(m) for m in sharded]
    return _RowShardedLookup.apply(local, ids, offsets[0], groups)


class DLRM(nn.Module):
    """Parameters: ``bottom_mlp.{i}.weight``/``.bias``, ``table_{t}``
    [rows, embed_dim], ``top_mlp.{i}.weight``/``.bias``; the flax tree's
    ``bottom_mlp/Dense_i/kernel`` is ``bottom_mlp.i.weight`` transposed."""

    def __init__(self, cfg: DLRMConfig, device: Any = "cuda") -> None:
        super().__init__()
        self.cfg = cfg

        def mlp(d_in: int, dims: Sequence[int]) -> nn.ModuleList:
            layers = []
            for d in dims:
                layer = nn.Linear(d_in, d, dtype=cfg.dtype, device=device)
                # flax Dense defaults: lecun normal kernel, zero bias
                nn.init.normal_(layer.weight, std=d_in ** -0.5)
                nn.init.zeros_(layer.bias)
                layers.append(layer)
                d_in = d
            return nn.ModuleList(layers)

        self.bottom_mlp = mlp(cfg.dense_in, cfg.bottom_mlp)
        for t, rows in enumerate(cfg.table_rows):
            table = torch.empty((rows, cfg.embed_dim), dtype=cfg.dtype, device=device)
            self.register_parameter(f"table_{t}", nn.Parameter(nn.init.normal_(table, std=1.0 / cfg.embed_dim)))
        n = len(cfg.table_rows) + 1
        self.top_mlp = mlp(cfg.bottom_mlp[-1] + n * (n - 1) // 2, cfg.top_mlp)

    def forward(self, dense: torch.Tensor, sparse_ids: torch.Tensor) -> torch.Tensor:
        """dense: [b, dense_in] float; sparse_ids: [b, n_tables] int →
        logits [b]."""
        cfg = self.cfg
        bottom = _mlp(self.bottom_mlp, dense)
        embs = [_lookup(getattr(self, f"table_{t}"), sparse_ids[:, t]) for t in range(len(cfg.table_rows))]
        # dot-product interaction over [bottom] + embeddings
        feats = torch.stack([bottom[..., : cfg.embed_dim]] + embs, dim=1)
        inter = torch.bmm(feats, feats.transpose(1, 2))
        n = feats.shape[1]
        iu = torch.triu_indices(n, n, offset=1, device=feats.device)  # jnp.triu_indices(n, k=1)'s order
        top_in = torch.cat([bottom, inter[:, iu[0], iu[1]]], dim=-1)
        return _mlp(self.top_mlp, top_in)[..., 0]


def embedding_sharding_rules(mesh: Any, path: str, shape: Sequence[int]) -> Tuple[Any, ...]:
    """Row-shard embedding tables over every mesh dim; replicate the MLPs
    (torchrec's ROW_WISE layout as a spec, ``parallel/mesh.py``'s form)."""
    if "table_" in path and len(shape) == 2:
        return (tuple(mesh.mesh_dim_names), None)
    return ()


def _adagrad(model: nn.Module) -> torch.optim.Adagrad:
    return torch.optim.Adagrad(
        model.parameters(), lr=LEARNING_RATE, initial_accumulator_value=INITIAL_ACCUMULATOR, eps=EPS
    )


def make_train_state(
    cfg: DLRMConfig, seed: int = 0, mesh: Any = None, device: Any = "cuda"
) -> Tuple[DLRM, torch.optim.Adagrad]:
    """A model with weights drawn from ``seed`` (the caller's RNG streams
    are left as they were) and its Adagrad; with ``mesh``, the tables are
    ``Shard(0)`` DTensors over every mesh dim, the rest ``Replicate()``,
    and the optimizer's sums follow their parameters."""
    from ..parallel.mesh import shard_train_state

    device = torch.device(device)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        model = DLRM(cfg, device=device)
    opt = _adagrad(model)
    if mesh is not None:
        model, opt = shard_train_state(
            model, opt, mesh, rules=lambda path, shape: embedding_sharding_rules(mesh, path, shape)
        )
    return model, opt


def loss_fn(model: DLRM, dense: torch.Tensor, sparse_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = model(dense, sparse_ids)
    # binary cross-entropy with logits
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def train_step(
    model: DLRM, opt: torch.optim.Optimizer, dense: torch.Tensor, sparse_ids: torch.Tensor,
    labels: torch.Tensor,
) -> torch.Tensor:
    """One training step, in place on ``model`` and ``opt``; returns the
    step's loss (computed before the update)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, dense, sparse_ids, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameters (nested dict of numpy arrays, with or without the
    top-level ``"params"`` key) → a ``DLRM`` state dict of CPU tensors:
    ``bottom_mlp/Dense_i/kernel`` [in, out] → ``bottom_mlp.i.weight``
    [out, in], ``bias`` as it is, ``table_t`` as it is."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        if not isinstance(value, dict):
            out[name] = torch.from_numpy(np.array(value))
            continue
        for dense, leaves in value.items():
            i = int(dense.rsplit("_", 1)[1])
            out[f"{name}.{i}.weight"] = torch.from_numpy(np.array(leaves["kernel"])).T.contiguous()
            out[f"{name}.{i}.bias"] = torch.from_numpy(np.array(leaves["bias"]))
    return out


def _find_rss_state(node: Any) -> Any:
    """optax's ScaleByRssState (sum_of_squares) inside an opt_state chain."""
    if hasattr(node, "sum_of_squares"):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_rss_state(child)
            if found is not None:
                return found
    return None


def adagrad_state_from_jax(opt_state: Any, model: DLRM) -> Dict[str, Any]:
    """An optax ``adagrad`` state (numpy leaves) → a ``state_dict`` for
    this model's Adagrad (``make_train_state``): ``sum_of_squares`` →
    ``sum``, mapped onto the parameters by name as ``params_from_jax``
    maps the weights.  optax keeps no step count; torch's ``step`` is
    written as 0, which changes no update at ``lr_decay`` 0."""
    rss = _find_rss_state(opt_state)
    if rss is None:
        raise ValueError("no ScaleByRssState (sum_of_squares) in the optax state")
    sums = params_from_jax(rss.sum_of_squares)
    state = {
        i: {"step": torch.tensor(0.0), "sum": sums[name]}
        for i, (name, _) in enumerate(model.named_parameters())
    }
    return {"state": state, "param_groups": _adagrad(model).state_dict()["param_groups"]}
