"""Sharded (DTensor) state across two ranks, in the port, against the JAX
package: ranks are subprocesses over a gloo process group (its store is
the snapshots' coordinator; the takes and restores run no collective of
the mesh), DTensors on a CPU ``DeviceMesh``.  Covers a port snapshot
restored by the port at world 2 into the transposed layout and at world
1, and by the JAX package into every layout of its resharding matrix; a
JAX snapshot of every layout restored by the port at world 2; and the
locations, shard records and mesh metadata the port writes against the
JAX package's.  Every comparison of data is bitwise."""

import os
import textwrap

import jax
import numpy as np
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from test_torch_distributed import run_workers
from test_torch_sharded import SPECS, _bytes, _jax_array

# the leaves every rank builds alike (seeded), and their layouts on a
# 1-D "tp" mesh of 2: even, transposable, replicated, uneven (4 + 3
# rows) and one with an empty trailing box (1 + 0 rows)
_LEAVES = """
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import Replicate, Shard
        from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, make_train_state
        from torchsnapshot_tpu_torch.parallel.mesh import distribute, shard_train_state

        def full_leaves():
            g = torch.Generator().manual_seed(5)
            return {
                "w0": torch.randn(16, 8, generator=g),
                "w1": torch.randn(16, 8, generator=g).to(torch.bfloat16),
                "rep": torch.randn(16, 8, generator=g),
                "odd": torch.randn(7, 6, generator=g),
                "tail": torch.randn(1, 6, generator=g),
            }

        LAYOUT = {"w0": Shard(0), "w1": Shard(1), "rep": Replicate(), "odd": Shard(0), "tail": Shard(0)}

        def train_state(seed, mesh):
            model, opt = make_train_state(TransformerConfig.tiny(), seed=seed, device="cpu")
            g = torch.Generator().manual_seed(seed + 100)
            for p in model.parameters():
                p.grad = torch.randn(p.shape, generator=g).to(p.dtype)
            opt.step()
            return (model, opt) if mesh is None else shard_train_state(model, opt, mesh)
"""


def _helpers():
    """``_LEAVES``'s functions, in this process."""
    ns = {"torch": torch}
    exec(textwrap.dedent(_LEAVES), ns)
    return ns


def test_port_two_rank_dtensors_restore_in_both_packages(tmp_path):
    """Two ranks take DTensor leaves (f32 and bf16, sharded over either
    dim, replicated, uneven, with an empty box) and a tiny transformer
    with its AdamW laid out by the rules on a (1, 2) ("dp", "tp") mesh;
    each replicated box is written once.  The ranks restore at world 2
    into the transposed layout and into a fresh sharded model and
    optimizer, in place, read every leaf whole and in budgeted tiles, and
    an ``async_take`` holds the state at the call.  Then the port restores
    at world 1 into plain tensors and into DTensors on a 1-rank mesh, and
    the JAX package restores the leaves into every layout of its
    matrix."""
    outs = run_workers(tmp_path, 2, _LEAVES + """
        mesh = DeviceMesh("cpu", [0, 1], mesh_dim_names=("tp",))
        mesh2 = DeviceMesh("cpu", [[0, 1]], mesh_dim_names=("dp", "tp"))
        full = full_leaves()
        state = tts.StateDict({k: distribute(v, mesh, [LAYOUT[k]]) for k, v in full.items()}, step=3)
        model, opt = train_state(0, mesh2)
        written = lambda: tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0)
        w0 = written()
        tts.Snapshot.take(snap_dir, {"app": state, "model": model, "optim": opt}, coordinator=coord)
        print("wrote", written() - w0)

        swap = lambda p: Shard(1 - p.dim) if p.is_shard() else p
        dest = tts.StateDict({k: distribute(torch.zeros_like(v), mesh, [swap(LAYOUT[k])]) for k, v in full.items()}, step=0)
        ptrs = {k: v.to_local().data_ptr() for k, v in dest.items() if k != "step"}
        m2, o2 = train_state(1, mesh2)
        tts.Snapshot(snap_dir, coordinator=coord).restore({"app": dest, "model": m2, "optim": o2})
        for k, v in full.items():
            want = distribute(v, mesh, [swap(LAYOUT[k])]).to_local()
            got = dest[k].to_local()
            assert got.data_ptr() == ptrs[k] and got.dtype == v.dtype and torch.equal(got, want), k
            for budget in (None, 40):
                r = tts.Snapshot(snap_dir).read_object(f"{rank}/app/{k}", memory_budget_bytes=budget, device="cpu")
                assert torch.equal(r, v), (k, budget)
        assert dest["step"] == 3
        for (n, a), b in zip(model.named_parameters(), m2.parameters()):
            assert torch.equal(a.to_local(), b.to_local()), n
        for p, q in zip(model.parameters(), m2.parameters()):
            assert torch.equal(opt.state[p]["exp_avg_sq"].to_local(), o2.state[q]["exp_avg_sq"].to_local())

        pending = tts.Snapshot.async_take(snap_dir + "_async", {"app": state}, coordinator=coord)
        with torch.no_grad():
            state["w0"].to_local().add_(1)  # after the return: not in the snapshot
        pending.wait()
        again = tts.StateDict({k: distribute(torch.zeros_like(v), mesh, [LAYOUT[k]]) for k, v in full.items()}, step=0)
        tts.Snapshot(snap_dir + "_async", coordinator=coord).restore({"app": again})
        assert torch.equal(again["w0"].to_local(), distribute(full["w0"], mesh, [Shard(0)]).to_local())
        print("rank", rank, "ok")
        """, kind="gloo")
    assert all("ok" in o for o in outs)
    helpers = _helpers()
    full, train_state = helpers["full_leaves"](), helpers["train_state"]
    wrote = [int(line.split()[1]) for o in outs for line in o.splitlines() if line.startswith("wrote")]
    model, opt = train_state(0, None)
    unique = sum(v.numel() * v.element_size() for v in full.values())
    unique += 3 * sum(p.numel() * p.element_size() for p in model.parameters())
    # each box once; every rank also writes its own AdamW steps (4 bytes each)
    assert min(wrote) > 0 and sum(wrote) == unique + 2 * 4 * len(opt.state), wrote

    snap_dir = str(tmp_path / "snap")
    dest = tts.StateDict({k: torch.zeros_like(v) for k, v in full.items()}, step=0)
    plain, _ = train_state(2, None)
    tts.Snapshot(snap_dir).restore({"app": dest, "model": plain}, strict=False)
    for k, v in full.items():
        assert torch.equal(dest[k], v), k
    for (n, a), b in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(a, b), n
    run_workers(tmp_path, 1, _LEAVES + """
        mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("dp", "tp"))
        full = full_leaves()
        dest = tts.StateDict({k: distribute(torch.zeros_like(v), mesh, [Replicate(), LAYOUT[k]]) for k, v in full.items()}, step=0)
        tts.Snapshot(snap_dir, coordinator=coord).restore({"app": dest})
        for k, v in full.items():
            assert torch.equal(dest[k].to_local(), v), k
        """, kind="gloo", kv="kv1")

    for spec_def in SPECS:
        templates = {k: _jax_array(spec_def, np.zeros((16, 8), np.float32)) for k in ("w0", "rep")}
        templates["w1"] = _jax_array(spec_def, np.zeros((16, 8), jax.numpy.bfloat16))
        jdest = jts.StateDict(**templates, odd=np.zeros((7, 6), np.float32), tail=np.zeros((1, 6), np.float32), step=0)
        jts.Snapshot(snap_dir).restore({"app": jdest})
        for k, v in full.items():
            assert np.asarray(jdest[k]).tobytes() == _bytes(v), (spec_def, k)


def test_jax_sharded_snapshots_restore_at_world_2(tmp_path):
    """The JAX package takes every layout of its matrix (one of them with
    its boxes subdivided) and one replicated dense chunked array; two port ranks
    restore each into DTensors sharded over dim 0, over dim 1 (and
    replicated), and read the sharded ones in budgeted tiles with the
    tiles' crc32s folded, bitwise."""
    for si, spec_def in enumerate(SPECS):
        value = np.random.default_rng(si).standard_normal((16, 8)).astype(np.float32)
        with jknobs.override_max_shard_size_bytes(64 if si == 5 else 1 << 20):
            jts.Snapshot.take(str(tmp_path / f"snap{si}"), {"app": jts.StateDict(w=_jax_array(spec_def, value))})
    dense = np.random.default_rng(99).standard_normal((16, 8)).astype(np.float32)
    with jknobs.override_max_chunk_size_bytes(160):
        # replicated: every rank of a larger world sees it
        jts.Snapshot.take(str(tmp_path / "dense"), {"app": jts.StateDict(w=dense)}, replicated=["**"])
    run_workers(tmp_path, 2, f"""
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import Replicate, Shard
        from torchsnapshot_tpu_torch.parallel.mesh import distribute
        mesh = DeviceMesh("cpu", [0, 1], mesh_dim_names=("tp",))
        for si in range({len(SPECS)}):
            value = torch.from_numpy(np.random.default_rng(si).standard_normal((16, 8)).astype(np.float32))
            path = {str(tmp_path)!r} + f"/snap{{si}}"
            for pl in (Shard(0), Shard(1), Replicate()):
                dest = tts.StateDict(w=distribute(torch.zeros(16, 8), mesh, [pl]))
                tts.Snapshot(path, coordinator=coord).restore({{"app": dest}})
                assert torch.equal(dest["w"].to_local(), distribute(value, mesh, [pl]).to_local()), (si, pl)
            with tts.knobs.override_verify_on_restore(True):
                r = tts.Snapshot(path).read_object("0/app/w", memory_budget_bytes=64, device="cpu")
            assert torch.equal(r, value), si
        dense = torch.from_numpy(np.random.default_rng(99).standard_normal((16, 8)).astype(np.float32))
        for pl in (Shard(0), Shard(1)):
            dest = tts.StateDict(w=distribute(torch.zeros(16, 8), mesh, [pl]))
            tts.Snapshot({str(tmp_path / "dense")!r}, coordinator=coord).restore({{"app": dest}})
            assert torch.equal(dest["w"].to_local(), distribute(dense, mesh, [pl]).to_local()), pl
        print("rank", rank, "ok")
        """, kind="gloo")


def test_port_writes_the_jax_locations_records_and_mesh_metadata(tmp_path):
    """The same leaves laid out alike (dim 0, dim 1, replicated on a "tp"
    axis of 2, boxes subdivided at 128 bytes, no slabs): the port's two
    ranks and the JAX package's two devices write the same locations,
    holding the same bytes, with the same shard records (offsets, sizes,
    crc32) and mesh metadata."""
    rng = np.random.default_rng(9)
    values = {k: rng.standard_normal((16, 8)).astype(np.float32) for k in ("w0", "w1", "rep")}
    specs = {"w0": ("tp", None), "w1": (None, "tp"), "rep": (None, None)}
    np.savez(tmp_path / "values.npz", **values)
    with jknobs.override_max_shard_size_bytes(128), jknobs.override_disable_batching(True):
        jts.Snapshot.take(str(tmp_path / "jax"), {"app": jts.StateDict(
            {k: _jax_array(((2,), ("tp",), specs[k]), v) for k, v in values.items()})})
    run_workers(tmp_path, 2, f"""
        from torch.distributed.device_mesh import DeviceMesh
        from torchsnapshot_tpu_torch.parallel.mesh import distribute, placements_from_spec
        mesh = DeviceMesh("cpu", [0, 1], mesh_dim_names=("tp",))
        values = np.load({str(tmp_path / "values.npz")!r})
        specs = {specs!r}
        state = tts.StateDict({{k: distribute(torch.from_numpy(values[k]), mesh,
                                              placements_from_spec(["tp"], [2], specs[k])) for k in specs}})
        with tts.knobs.override_max_shard_size_bytes(128), tts.knobs.override_disable_batching(True):
            tts.Snapshot.take(snap_dir, {{"app": state}}, coordinator=coord)
        """, kind="gloo")
    jman = jts.Snapshot(str(tmp_path / "jax")).get_manifest()
    tmeta = tts.Snapshot(str(tmp_path / "snap")).metadata
    for k in values:
        want = jman[f"0/app/{k}"]
        mine = [e for p, e in tmeta.manifest.items() if p.endswith(f"/app/{k}")]
        assert len(mine) == 2  # one record per rank, each with the boxes it wrote
        shards = sorted((s for e in mine for s in e.shards), key=lambda s: s.location)
        assert [(s.offsets, s.sizes, s.location, s.crc32) for s in shards] == sorted(
            ((s.offsets, s.sizes, s.location, s.crc32) for s in want.shards), key=lambda t: t[2])
        assert len(shards) > 2 and all(e.shards for e in mine) or k == "rep"
        for e in mine:
            assert (e.dtype, e.shape, e.mesh_axis_names, e.mesh_shape, e.spec) == (
                want.dtype, want.shape, want.mesh_axis_names, want.mesh_shape, want.spec)
        for s in shards:
            with open(os.path.join(tmp_path, "snap", s.location), "rb") as a, \
                    open(os.path.join(tmp_path, "jax", s.location), "rb") as b:
                assert a.read() == b.read(), s.location
