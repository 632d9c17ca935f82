"""Parameter layouts as DTensor placements, and the carry-across between
DTensor placements and the JAX package's ``PartitionSpec`` form.

Counterpart of ``torchsnapshot_tpu/parallel/mesh.py:78-126``: the same
Megatron-style rules (``param_sharding_rules``) over a ``("dp", "tp")``
``DeviceMesh``, applied without collectives (``distribute``: every rank
cuts its own local tensor out of the full one it holds).  A snapshot
stores a sharded leaf's layout as the JAX package does, as
``mesh_axis_names``, ``mesh_shape`` and a ``spec`` with one element per
tensor dim (None, an axis name, or a list of axis names splitting that
dim in order); ``spec_from_placements`` and ``placements_from_spec``
convert between the two.  DTensor splits a tensor dim over several mesh
dims in mesh-dim order only, so a spec naming them in another order
(``P(("b", "a"), None)`` on an ``("a", "b")`` mesh) raises.
"""

from __future__ import annotations

import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

# (param-path regex, spec) — column-parallel in, row-parallel out,
# replicated norms
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r".*embed.*", (None, "tp")),
    (r".*(wq|wk|wv|w1|gate).*", (None, "tp")),
    (r".*(wo|w2|proj_out).*", ("tp", None)),
    (r".*lm_head.*", (None, "tp")),
    (r".*(norm|scale|bias).*", (None,)),
)


def param_sharding_rules(path: str, shape: Sequence[int]) -> Tuple[Any, ...]:
    """A parameter path and shape → its spec (one element per leading dim
    the rule names; dims past it are replicated)."""
    for pattern, spec in _RULES:
        if re.fullmatch(pattern, path, flags=re.IGNORECASE):
            return tuple(spec[: len(shape)])
    return (None,) * len(shape)


def placements_from_spec(
    mesh_axis_names: Sequence[str], mesh_shape: Sequence[int], spec: Sequence[Any]
) -> Tuple[Any, ...]:
    """The DTensor placements, one per mesh dim, of ``spec`` on a mesh
    with these axis names and shape."""
    from torch.distributed.tensor import Replicate, Shard

    names = [str(n) for n in mesh_axis_names]
    if len(names) != len(mesh_shape):
        raise ValueError(f"mesh axis names {names} do not match mesh shape {list(mesh_shape)}")
    placements: List[Any] = [Replicate()] * len(names)
    seen = set()
    for dim, elem in enumerate(spec):
        if elem is None:
            continue
        axes = [elem] if isinstance(elem, str) else list(elem)
        order = []
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {list(spec)} names axis {ax!r}, not on the mesh {names}")
            if ax in seen:
                raise ValueError(f"spec {list(spec)} uses mesh axis {ax!r} twice")
            seen.add(ax)
            order.append(names.index(ax))
        if order != sorted(order):
            raise ValueError(
                f"spec {list(spec)} splits dim {dim} over mesh axes {axes} out of "
                f"the mesh's axis order {names}; DTensor shards in mesh-dim order only"
            )
        for m in order:
            placements[m] = Shard(dim)
    return tuple(placements)


def spec_from_placements(mesh: Any, placements: Sequence[Any], ndim: int) -> Optional[List[Any]]:
    """The spec of ``placements`` on ``mesh`` (None for a mesh without
    dim names)."""
    names = mesh.mesh_dim_names
    if names is None:
        return None
    spec: List[List[str]] = [[] for _ in range(ndim)]
    for m, p in enumerate(placements):
        if p.is_replicate():
            continue
        if not p.is_shard() or type(p).__name__ == "_StridedShard":
            raise ValueError(f"placement {p!r} has no spec")
        spec[p.dim % ndim].append(str(names[m]))
    return [None if not axes else axes[0] if len(axes) == 1 else axes for axes in spec]


def distribute(full: torch.Tensor, mesh: Any, placements: Sequence[Any]) -> Any:
    """The DTensor of ``placements`` on ``mesh`` whose value is ``full``,
    which this rank holds whole: it keeps a copy of its own box, on the
    mesh's device type.  No collective runs."""
    from torch.distributed.tensor import DTensor

    from ..preparers.sharded import box_at

    coord = mesh.get_coordinate()
    shape = tuple(full.shape)
    if coord is None:
        local = torch.empty((0,) * len(shape), dtype=full.dtype, device=mesh.device_type)
    else:
        offsets, sizes = box_at(shape, mesh.shape, coord, placements)
        index = tuple(slice(o, o + s) for o, s in zip(offsets, sizes))
        with torch.no_grad():
            local = full.detach()[index].to(mesh.device_type).clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(
        local, mesh, list(placements), run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride(),
    )


Rules = Callable[[str, Sequence[int]], Tuple[Any, ...]]


def shard_module(module: torch.nn.Module, mesh: Any, rules: Rules = param_sharding_rules) -> torch.nn.Module:
    """Replace every parameter of ``module`` by a DTensor parameter laid
    out by ``rules`` (a parameter path and shape → its spec), in place;
    returns ``module``."""
    for name, p in list(module.named_parameters()):
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        spec = rules(name, tuple(p.shape))
        dt = distribute(p, mesh, placements_from_spec(mesh.mesh_dim_names, mesh.shape, spec))
        setattr(owner, attr, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return module


def shard_train_state(
    model: torch.nn.Module, opt: torch.optim.Optimizer, mesh: Any, rules: Rules = param_sharding_rules
):
    """``model`` with DTensor parameters (``shard_module`` by ``rules``)
    and an optimizer of ``opt``'s type and groups over them, whose
    per-parameter state holds ``opt``'s, each moment laid out as its
    parameter."""
    params = list(model.parameters())
    state = [opt.state.get(p, {}) for p in params]
    index = {id(p): i for i, p in enumerate(params)}
    shard_module(model, mesh, rules)
    new_params = list(model.parameters())
    groups = [
        {**{k: v for k, v in g.items() if k != "params"}, "params": [new_params[index[id(p)]] for p in g["params"]]}
        for g in opt.param_groups
    ]
    new_opt = type(opt)(groups)
    for p, st in zip(new_params, state):
        if st:
            new_opt.state[p] = {
                k: distribute(v, mesh, p.placements)
                if isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(p.shape) and v.dim() > 0
                else v
                for k, v in st.items()
            }
    return model, new_opt
