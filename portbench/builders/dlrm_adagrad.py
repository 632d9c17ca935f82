"""A DLRM training state, one rank's share of a row-sharded deployment:
the port's ``models/dlrm.py`` with this rank's rows of every table as
``Shard(0)`` DTensors on a one-rank mesh, the MLPs ``Replicate()``, and
torch Adagrad's sums laid out as their parameters.

The mesh needs a process group: one rank over a FileStore in a fresh
temporary directory, removed at ``close``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict

import torch

from ..state import BenchState, leaf_specs


def build(cfg: Dict[str, Any], seed: int, device: Any) -> BenchState:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.models import dlrm

    store_dir = tempfile.mkdtemp(prefix="portbench-store-")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(store_dir, 'store')}", rank=0, world_size=1
    )

    def close() -> None:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)

    try:
        mesh = DeviceMesh(torch.device(device).type, [0], mesh_dim_names=("ep",))
        dcfg = dlrm.DLRMConfig(
            table_rows=tuple(cfg["table_rows"]), embed_dim=cfg["embedding_dim"],
            dense_in=cfg["dense_features"], bottom_mlp=tuple(cfg["bottom_mlp"][1:]),
            top_mlp=tuple(cfg["top_mlp"]), dtype=getattr(torch, cfg["dtype"]),
        )
        if cfg["bottom_mlp"][0] != cfg["dense_features"]:
            raise ValueError("the bottom MLP starts at the dense features")
        model, opt = dlrm.make_train_state(dcfg, seed=0, mesh=mesh, device=device)
        named = []
        # the local tensors share the DTensors' storage: filled in place
        with torch.no_grad():
            locals_ = [(name, p.to_local()) for name, p in model.named_parameters()]
            sums = [opt.state[p]["sum"].to_local() for p in model.parameters()]
        for name, p in locals_:
            named.append((f"0/model/{name}", p, "normal"))
        for i, s in enumerate(sums):
            named.append((f"0/optim/state/{i}/sum", s, "nonneg"))
        progress = tts.StateDict(step=-1)
        app_state = {"model": model, "optim": opt, "rng": tts.RNGState(), "progress": progress}
        n_params = len(locals_)
        state = BenchState(
            app_state, progress, leaf_specs(named), [t for _, t, _ in named], range(n_params),
            seed, close,
        )
    except BaseException:
        close()
        raise
    state.refill(0)
    return state
