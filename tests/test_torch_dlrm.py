"""The port's DLRM (``torchsnapshot_tpu_torch/models/dlrm.py``) against the
JAX package's (``torchsnapshot_tpu/models/dlrm.py``), ``tiny()`` in f32.

In one process: the forward, the loss and one Adagrad step against the
JAX ``train_step`` on the same weights and accumulators (carried by
``params_from_jax`` and ``adagrad_state_from_jax``): losses within rtol
1e-5, parameters and accumulators after the step within 1e-6.  Then two
ranks, subprocesses over a gloo process group on the CPU
(``run_workers(kind="gloo")`` from ``test_torch_distributed.py``, with
its timeout), tables row-sharded over a 1-D ``"ep"`` mesh: the loss and
the step against world 1; a world-2 take restored at world 1 bitwise with
the next loss equal (``tests/test_dlrm.py:50-79``); that snapshot read
bitwise by the JAX package's ``read_object``, each table whole; and a
JAX-written row-sharded snapshot restored by the two ranks bitwise.
Batches come from seeded numpy generators, drawn as
``tests/test_dlrm.py:23-33`` draws them."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu.models import dlrm as jdlrm
from torchsnapshot_tpu_torch.models import dlrm as tdlrm
from test_torch_distributed import run_workers


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = 8
    dense = rng.standard_normal((b, cfg.dense_in)).astype(np.float32)
    # per-table high: every table's full row range gets lookups/updates
    ids = rng.integers(0, cfg.table_rows, size=(b, len(cfg.table_rows))).astype(np.int32)
    labels = rng.integers(0, 2, size=(b,)).astype(np.float32)
    return dense, ids, labels


def _torch_batch(batch):
    dense, ids, labels = batch
    return torch.from_numpy(dense), torch.from_numpy(ids).long(), torch.from_numpy(labels)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_state_from_jax(ts):
    model, opt = tdlrm.make_train_state(tdlrm.DLRMConfig.tiny(), seed=1, device="cpu")
    model.load_state_dict(tdlrm.params_from_jax(_np(ts.params)))
    opt.load_state_dict(tdlrm.adagrad_state_from_jax(_np(ts.opt_state), model))
    return model, opt


def test_config_and_layout_match_jax():
    """Defaults and ``tiny()`` field for field; the full-width parameter
    count; the rules' layout of a table and of an MLP weight."""
    for t, j in ((tdlrm.DLRMConfig(), jdlrm.DLRMConfig()), (tdlrm.DLRMConfig.tiny(), jdlrm.DLRMConfig.tiny())):
        for f in ("table_rows", "embed_dim", "dense_in", "bottom_mlp", "top_mlp"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.dtype == torch.float32
    with torch.device("meta"):
        full = tdlrm.DLRM(tdlrm.DLRMConfig(), device="meta")
    n_dense = sum(p.numel() for n, p in full.named_parameters() if "table_" not in n)
    assert n_dense == 2_046_337
    assert sum(p.numel() for n, p in full.named_parameters() if "table_" in n) * 4 == 268_435_456

    class _Mesh:
        mesh_dim_names = ("ep",)

    assert tdlrm.embedding_sharding_rules(_Mesh, "table_3", (64, 8)) == (("ep",), None)
    assert tdlrm.embedding_sharding_rules(_Mesh, "bottom_mlp.0.weight", (16, 4)) == ()


def test_forward_loss_and_one_adagrad_step_match_jax():
    cfg = jdlrm.DLRMConfig.tiny()
    ts = jdlrm.make_train_state(cfg, seed=0)
    batch = _batch(cfg)
    model, opt = _port_state_from_jax(ts)
    logits = ts.apply_fn(ts.params, *batch[:2])
    with torch.no_grad():
        got = model(*_torch_batch(batch)[:2])
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=1e-5, atol=1e-6)
    ts2, jloss = jax.jit(jdlrm.train_step)(ts, *batch)
    loss = tdlrm.train_step(model, opt, *_torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = tdlrm.params_from_jax(_np(ts2.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
    sums = tdlrm.adagrad_state_from_jax(_np(ts2.opt_state), model)["state"]
    for i, p in enumerate(model.parameters()):
        np.testing.assert_allclose(opt.state[p]["sum"].numpy(), sums[i]["sum"].numpy(), rtol=0, atol=1e-6)
    # the next step's loss carries on equal
    _, jloss2 = jax.jit(jdlrm.train_step)(ts2, *_batch(cfg, seed=7))
    loss2 = tdlrm.train_step(model, opt, *_torch_batch(_batch(cfg, seed=7)))
    np.testing.assert_allclose(float(loss2), float(jloss2), rtol=1e-5)


_BODY = """
    from torch.distributed.device_mesh import DeviceMesh
    from torchsnapshot_tpu_torch.models import dlrm

    cfg = dlrm.DLRMConfig.tiny()
    mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("ep",))
    batches = np.load(BATCHES)
    batch = lambda s: (torch.from_numpy(batches[f"dense{s}"]), torch.from_numpy(batches[f"ids{s}"]).long(),
                       torch.from_numpy(batches[f"labels{s}"]))  # noqa: E731
    model, opt = dlrm.make_train_state(cfg, seed=0, mesh=mesh, device="cpu")
    assert model.table_0.placements[0].is_shard(0) and model.bottom_mlp[0].weight.placements[0].is_replicate()
    loss0 = dlrm.train_step(model, opt, *batch(0))
    tts.Snapshot.take(snap_dir, {"model": model, "optim": opt}, coordinator=coord)
    out = {"loss0": np.array(float(loss0))}
    for step in (0, 7):
        if step:
            out["loss7"] = np.array(float(dlrm.train_step(model, opt, *batch(7))))
        for n, p in model.named_parameters():
            out[f"after{step}/{n}"] = p.to_local().detach().numpy().copy()
            out[f"after{step}/sum/{n}"] = opt.state[p]["sum"].to_local().numpy().copy()
    # a JAX-written row-sharded snapshot, restored in place
    dest, _ = dlrm.make_train_state(cfg, seed=5, mesh=mesh, device="cpu")
    tts.Snapshot(JAX_SNAP, coordinator=coord).restore({"model": dest})
    for n, p in dest.named_parameters():
        out["jax/" + n] = p.to_local().detach().numpy()
    np.savez(f"{OUT}{rank}.npz", **out)
"""


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Two ranks: a step, a take, the next step, and a restore of a JAX
    snapshot, from ``make_train_state(seed=0)`` on an ``"ep"`` mesh."""
    tmp = tmp_path_factory.mktemp("dlrm")
    cfg = tdlrm.DLRMConfig.tiny()
    batches = {}
    for s in (0, 7):
        for k, a in zip(("dense", "ids", "labels"), _batch(cfg, seed=s)):
            batches[f"{k}{s}"] = a
    np.savez(tmp / "batches.npz", **batches)
    # the JAX package row-shards a state laid out as the port's model over 8 devices
    ref, _ = tdlrm.make_train_state(cfg, seed=3, device="cpu")
    ref_sd = {n: p.detach().numpy() for n, p in ref.named_parameters()}
    mesh = Mesh(np.array(jax.devices()[:8]), ("ep",))
    jax_state = jts.StateDict({
        n: jax.device_put(a, NamedSharding(mesh, P(("ep",), None) if "table_" in n else P())) for n, a in ref_sd.items()
    })
    jts.Snapshot.take(str(tmp / "jax_snap"), {"model": jax_state})
    head = f"""
    BATCHES = {str(tmp / 'batches.npz')!r}
    JAX_SNAP = {str(tmp / 'jax_snap')!r}
    OUT = {str(tmp / 'rank')!r}"""
    run_workers(tmp, 2, head + _BODY, kind="gloo")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return {"tmp": tmp, "batches": batches, "ranks": ranks, "jax_ref": ref_sd}


def _gathered(ranks, name):
    """A parameter as one array: table shards stacked, replicas equal."""
    parts = [r[name] for r in ranks]
    if "table_" in name.split("/")[-1]:
        return np.concatenate(parts)
    assert all(p.tobytes() == parts[0].tobytes() for p in parts), name
    return parts[0]


def test_two_ranks_row_sharded_match_world_1(world2):
    """The loss and the step at world 2 (tables looked up over the row
    shards, gradients scatter-added into each rank's own rows) against
    one process holding the same seeded state."""
    cfg = tdlrm.DLRMConfig.tiny()
    model, opt = tdlrm.make_train_state(cfg, seed=0, device="cpu")
    b = world2["batches"]
    loss0 = tdlrm.train_step(model, opt, *(torch.from_numpy(b[f"{k}0"]) for k in ("dense", "ids", "labels")))
    for r in world2["ranks"]:
        np.testing.assert_allclose(float(r["loss0"]), float(loss0), rtol=1e-5)
    for n, p in model.named_parameters():
        for key, want in ((n, p.detach()), ("sum/" + n, opt.state[p]["sum"])):
            np.testing.assert_allclose(
                _gathered(world2["ranks"], "after0/" + key), want.numpy(), rtol=0, atol=1e-6, err_msg=key
            )


def test_world_2_take_restores_at_world_1_with_the_next_loss_equal(world2):
    """Every table and accumulator restored into a differently seeded
    model at world 1 is the gathered shards bitwise; the next step's loss
    equals the world-2 run's."""
    cfg = tdlrm.DLRMConfig.tiny()
    model, opt = tdlrm.make_train_state(cfg, seed=99, device="cpu")
    tts.Snapshot(str(world2["tmp"] / "snap")).restore({"model": model, "optim": opt})
    ranks = world2["ranks"]
    for n, p in model.named_parameters():
        assert p.detach().numpy().tobytes() == _gathered(ranks, f"after0/{n}").tobytes(), n
        assert opt.state[p]["sum"].numpy().tobytes() == _gathered(ranks, f"after0/sum/{n}").tobytes(), n
    b = world2["batches"]
    loss7 = tdlrm.train_step(model, opt, *(torch.from_numpy(b[f"{k}7"]) for k in ("dense", "ids", "labels")))
    np.testing.assert_allclose(float(loss7), float(ranks[0]["loss7"]), rtol=1e-5)


def test_port_snapshot_read_whole_by_the_jax_package(world2):
    """Each row-sharded table and its accumulator of the world-2 take
    read whole through the JAX package's ``read_object``, bitwise equal
    to the ranks' gathered shards."""
    cfg = tdlrm.DLRMConfig.tiny()
    ranks = world2["ranks"]
    jsnap = jts.Snapshot(str(world2["tmp"] / "snap"))
    manifest = jsnap.metadata.manifest
    model, _ = tdlrm.make_train_state(cfg, seed=0, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    for t in range(len(cfg.table_rows)):
        name = f"table_{t}"
        assert type(manifest[f"0/model/{name}"]).__name__ == "ShardedArrayEntry"
        got = np.asarray(jsnap.read_object(f"0/model/{name}"))
        assert got.shape == (cfg.table_rows[t], cfg.embed_dim)
        assert got.tobytes() == _gathered(ranks, f"after0/{name}").tobytes(), name
        i = names.index(name)
        got = np.asarray(jsnap.read_object(f"0/optim/state/{i}/sum"))
        assert got.tobytes() == _gathered(ranks, f"after0/sum/{name}").tobytes(), name


def test_jax_row_sharded_snapshot_restored_at_world_2(world2):
    """A snapshot the JAX package wrote with each table row-sharded over
    8 devices restores into the two ranks' ``"ep"``-sharded model, in
    place and bitwise."""
    for n, want in world2["jax_ref"].items():
        assert _gathered(world2["ranks"], "jax/" + n).tobytes() == want.tobytes(), n
