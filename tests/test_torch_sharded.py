"""Sharded (DTensor) state in the port against the JAX package, in one
process: the layout's boxes and writers, the spec carry-across and the
parameter rules, refusals, and JAX sharded snapshots restored at world 1
(plain tensors, numpy, and DTensors on a 1-rank gloo ``DeviceMesh``),
whole and in budgeted tiles.  Every comparison of data is bitwise; inputs
come from seeded numpy generators.  Two-rank cases are in
``test_torch_sharded_ranks.py``."""

import os
import socket
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.parallel import mesh as jmesh
from torchsnapshot_tpu.preparers import sharded as jsharded
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.manifest import ShardedArrayEntry
from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, TransformerLM, make_train_state
from torchsnapshot_tpu_torch.parallel import mesh as tmesh
from torchsnapshot_tpu_torch.preparers import sharded as tsharded
from torchsnapshot_tpu_torch.preparers.overlap import box_intersect, box_nelems

# the layouts of the JAX package's resharding matrix (tests/test_resharding.py:29-37)
SPECS = [
    ((2, 4), ("a", "b"), ("a", "b")),
    ((2, 4), ("a", "b"), ("b", "a")),
    ((2, 4), ("a", "b"), (("a", "b"), None)),
    ((2, 4), ("a", "b"), (None, "b")),
    ((2, 4), ("a", "b"), (None, None)),
    ((8,), ("x",), ("x", None)),
    ((8,), ("x",), (None, "x")),
    ((4,), ("x",), ("x", None)),
]


def _jax_array(spec_def, value):
    shape, names, spec = spec_def
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return jax.device_put(value, NamedSharding(Mesh(devs, names), P(*spec)))


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh11():
    """A 1-rank gloo process group and a ("dp", "tp") CPU mesh of (1, 1),
    torn down after the module so no later test sees torch.distributed
    initialized."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", [[0]], mesh_dim_names=("dp", "tp"))
    finally:
        dist.destroy_process_group()


class _Rank1View(tts.LocalCoordinator):
    @property
    def rank(self):
        return 1


def _chunks(n, k):
    """torch.chunk's split of n over k: (offset, size) each, empties kept."""
    size = -(-n // k)
    return [(min(i * size, n), max(0, min(size, n - i * size))) for i in range(k)]


def test_boxes_and_writers_match_jax():
    """For every layout of the matrix, the port's boxes per mesh
    coordinate (``placements_from_spec`` on a mesh shape, no process
    group) are the JAX package's ``_unique_boxes``, the ranks holding each
    box its devices; ``assign_box_writers`` and ``_subdivide`` agree with
    the JAX ones for the same loads.  Uneven layouts (which no
    ``NamedSharding`` expresses) follow ``torch.chunk``, skip empty
    boxes, and tile the array exactly."""
    shape = (16, 8)
    for mesh_shape, names, spec in SPECS:
        placements = tmesh.placements_from_spec(names, mesh_shape, spec)
        ranks = np.arange(int(np.prod(mesh_shape))).reshape(mesh_shape)
        got = tsharded.layout_boxes(shape, ranks, placements)
        jarr = _jax_array((mesh_shape, names, spec), np.zeros(shape, np.float32))
        want = jsharded._unique_boxes(jarr.sharding, shape)
        assert got == {b: sorted(d.id for d in devs) for b, devs in want.items()}, spec
        jboxes = {b: [types.SimpleNamespace(process_index=d.id) for d in devs] for b, devs in want.items()}
        for preloads in ([0] * 8, [512, 0, 64, 0, 7, 300, 0, 1], list(range(8, 0, -1))):
            assert tsharded.assign_box_writers(got, 4, 8, list(preloads)) == \
                jsharded.assign_box_writers(jboxes, 4, 8, list(preloads)), (spec, preloads)
        for box in got:
            for max_bytes in (16, 100, 1 << 20):
                assert tsharded._subdivide(box, 4, max_bytes) == jsharded._subdivide(box, 4, max_bytes)
    for shape, mesh_shape, placements in [
        ((10, 6), (4,), (Shard(0),)),
        ((10, 6), (2, 4), (Shard(1), Shard(0))),
        ((6, 10), (4,), (Shard(0),)),          # a trailing box is empty
        ((10, 6), (2, 4), (Shard(0), Shard(0))),
    ]:
        ranks = np.arange(int(np.prod(mesh_shape))).reshape(mesh_shape)
        boxes = tsharded.layout_boxes(shape, ranks, placements)
        for coord in np.ndindex(*mesh_shape):
            offsets, sizes = [0] * len(shape), list(shape)
            for m, p in enumerate(placements):  # mesh-dim order, nested
                o, sz = _chunks(sizes[p.dim], mesh_shape[m])[coord[m]]
                offsets[p.dim] += o
                sizes[p.dim] = sz
            box = (tuple(offsets), tuple(sizes))
            if 0 in sizes:
                assert box not in boxes
            else:
                assert int(ranks[coord]) in boxes[box], (shape, placements, coord)
        listed = list(boxes)
        assert sum(box_nelems(b) for b in listed) == shape[0] * shape[1]
        assert not any(box_intersect(a, b) for i, a in enumerate(listed) for b in listed[i + 1:])


def test_spec_carry_across_and_parameter_rules_match_jax():
    """``placements_from_spec`` and ``spec_from_placements`` invert each
    other on every layout of the matrix; a spec splitting one dim over
    mesh axes out of mesh order, or naming an axis twice or one not on
    the mesh, raises.  The parameter rules give every path of the port's
    transformer the spec the JAX package's rules give its flax path."""
    for mesh_shape, names, spec in SPECS:
        placements = tmesh.placements_from_spec(names, mesh_shape, spec)
        back = tmesh.spec_from_placements(types.SimpleNamespace(mesh_dim_names=names), placements, 2)
        assert back == [list(e) if isinstance(e, tuple) else e for e in spec]
    assert tmesh.placements_from_spec(("a", "b"), (2, 4), (("a", "b"), None)) == (Shard(0), Shard(0))
    assert tmesh.placements_from_spec(("a", "b"), (2, 4), ("b", "a")) == (Shard(1), Shard(0))
    for bad, what in [((("b", "a"), None), "out of"), (("a", "a"), "twice"), (("c", None), "not on the mesh")]:
        with pytest.raises(ValueError, match=what):
            tmesh.placements_from_spec(("a", "b"), (2, 4), bad)

    model = TransformerLM(TransformerConfig.tiny(), device="meta")
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[-1] == "weight":
            leaf = "embedding" if parts[0] == "embed" else "kernel"
            shape = tuple(p.shape) if leaf == "embedding" else tuple(p.shape)[::-1]
            parts[-1] = leaf
        else:
            shape = tuple(p.shape)
        want = tuple(jmesh.param_sharding_rules("/".join(parts), shape))
        assert tmesh.param_sharding_rules(name, tuple(p.shape)) == want, name


def test_layouts_the_format_cannot_hold_are_refused_by_name(mesh11, tmp_path):
    """A ``Partial`` or ``_StridedShard`` placement raises ``ValueError``
    naming the leaf and the placement, any other tensor subclass a
    ``TypeError`` naming its type, and a DTensor under a coordinator whose
    rank is not torch.distributed's raises, at take and at restore; none
    of these writes metadata."""
    from torch.distributed.tensor.placement_types import _StridedShard

    full = torch.arange(24.0).reshape(4, 6)
    partial = DTensor.from_local(full.clone(), mesh11, [Partial(), Replicate()], run_check=False)
    strided = DTensor.from_local(full.clone(), mesh11, [Replicate(), _StridedShard(0, split_factor=2)], run_check=False)

    class Tagged(torch.Tensor):
        pass

    tagged = torch.Tensor._make_subclass(Tagged, full.clone())
    for i, (leaf, err, what) in enumerate([
        (partial, ValueError, r"'app/w'.*Partial"),
        (strided, ValueError, r"'app/w'.*_StridedShard"),
        (tagged, TypeError, r"'app/w'.*Tagged"),
    ]):
        with pytest.raises(err, match=what):
            tts.Snapshot.take(str(tmp_path / f"bad{i}"), {"app": tts.StateDict(w=leaf)})
        assert not os.path.exists(tmp_path / f"bad{i}" / ".snapshot_metadata")
    good = tmesh.distribute(full, mesh11, (Replicate(), Shard(1)))
    with pytest.raises(ValueError, match="coordinator is rank 1"):
        tts.Snapshot.take(str(tmp_path / "r1"), {"app": tts.StateDict(w=good)}, coordinator=_Rank1View())
    tts.Snapshot.take(str(tmp_path / "ok"), {"app": tts.StateDict(w=good)})
    with pytest.raises(ValueError, match="coordinator is rank 1"):
        tts.Snapshot(str(tmp_path / "ok"), coordinator=_Rank1View()).restore({"app": tts.StateDict(w=good)})


def test_jax_sharded_snapshots_restore_at_world_1(mesh11, tmp_path):
    """The JAX package takes each layout of the matrix (f32 and bf16, with
    and without slabs); the port restores it at world 1 into a plain
    tensor, a numpy array, DTensors of three placements on the 1-rank
    mesh and no template, and reads it whole and in budgeted tiles (the
    tiles' crc32s folded under VERIFY_ON_RESTORE), bitwise; a dense JAX
    snapshot (whole and chunked) restores into a DTensor; a corrupted
    payload then fails the budgeted read."""
    rng = np.random.default_rng(11)
    for si, spec_def in enumerate(SPECS):
        for dtype in (np.float32, ml_dtypes.bfloat16):
            value = rng.standard_normal((16, 8)).astype(dtype)
            path = str(tmp_path / f"s{si}_{np.dtype(dtype).name}")
            with jknobs.override_disable_batching(si % 2 == 1):
                jts.Snapshot.take(path, {"app": jts.StateDict(w=_jax_array(spec_def, value))})
            want = value.tobytes()
            tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
            snap = tts.Snapshot(path)
            assert isinstance(snap.metadata.manifest["0/app/w"], ShardedArrayEntry)
            plain = torch.zeros(16, 8, dtype=tdtype)
            arr = np.zeros((16, 8), value.dtype)
            dts = [tmesh.distribute(torch.zeros(16, 8, dtype=tdtype), mesh11, pl)
                   for pl in ((Replicate(), Shard(0)), (Shard(1), Replicate()), (Replicate(), Replicate()))]
            templates = {"plain": plain, "numpy": arr, "none": None, **{f"dtensor{i}": d for i, d in enumerate(dts)}}
            for k, tmpl in templates.items():
                ptr = tmpl.to_local().data_ptr() if isinstance(tmpl, DTensor) else None
                one = tts.StateDict(w=tmpl)
                snap.restore({"app": one}, device="cpu")
                got = one["w"]
                if isinstance(got, DTensor):
                    assert got is tmpl and got.to_local().data_ptr() == ptr  # in place
                    got = got.to_local()
                assert _bytes(got) == want, (spec_def, k)
            assert _bytes(snap.read_object("0/app/w", device="cpu")) == want
            with tknobs.override_verify_on_restore(True):
                for budget in (64, 200):
                    assert _bytes(snap.read_object("0/app/w", memory_budget_bytes=budget, device="cpu")) == want
    # a dense JAX snapshot, whole and chunked, into DTensor templates
    value = rng.standard_normal((16, 8)).astype(np.float32)
    for chunk in (1 << 20, 128):
        with jknobs.override_max_chunk_size_bytes(chunk):
            jts.Snapshot.take(str(tmp_path / f"dense{chunk}"), {"app": jts.StateDict(w=value)})
        dest = tts.StateDict(w=tmesh.distribute(torch.zeros(16, 8), mesh11, (Shard(1), Replicate())))
        tts.Snapshot(str(tmp_path / f"dense{chunk}")).restore({"app": dest})
        assert _bytes(dest["w"].to_local()) == value.tobytes()
    # corrupt one shard payload of the last sharded snapshot: the tiled read fails
    entry = tts.Snapshot(path).metadata.manifest["0/app/w"]
    shard = entry.shards[0]
    with open(os.path.join(path, shard.location), "r+b") as f:
        f.seek(shard.byte_range[0] if shard.byte_range else 0)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with tknobs.override_verify_on_restore(True), pytest.raises(RuntimeError, match="crc32 mismatch"):
        tts.Snapshot(path).read_object("0/app/w", memory_budget_bytes=16, device="cpu")


def test_row_split_boxes_land_in_place_and_strided_ones_assemble(monkeypatch, tmp_path):
    """A sharded entry whose stored boxes span every dim but dim 0 lands
    its rows in place, tile by tile, with no box-sized assembly buffer:
    the host memory of a budgeted read is that of its tiles.  Column
    boxes (strided in the result) are assembled in one buffer of the
    whole result, as the JAX package does.  Both bitwise, whole and
    under a 64-byte budget, into a CPU template and into none."""
    assembled = []
    host = tsharded._BoxTarget.host
    monkeypatch.setattr(tsharded._BoxTarget, "host", lambda self: assembled.append(self.box) or host(self))
    landed = []
    write = tsharded.HostTileTarget.write
    monkeypatch.setattr(tsharded.HostTileTarget, "write",
                        lambda self, s, e, buf, *a: landed.append(memoryview(buf).nbytes) or write(self, s, e, buf, *a))
    value = np.random.default_rng(12).standard_normal((16, 8)).astype(np.float32)
    for spec_def, strided in ((((8,), ("x",), ("x", None)), False), (((8,), ("x",), (None, "x")), True)):
        path = str(tmp_path / ("cols" if strided else "rows"))
        jts.Snapshot.take(path, {"app": jts.StateDict(w=_jax_array(spec_def, value))})
        snap = tts.Snapshot(path)
        for budget in (None, 64):
            for tmpl in (torch.zeros(16, 8), None):
                assembled.clear()
                landed.clear()
                got = snap.read_object("0/app/w", obj_out=tmpl, memory_budget_bytes=budget, device="cpu")
                assert _bytes(got) == value.tobytes(), (spec_def, budget)
                assert set(assembled) == ({((0, 0), (16, 8))} if strided else set()), (spec_def, budget)
                assert bool(landed) != strided
                if budget is not None:
                    assert max(landed, default=0) <= budget


def test_module_and_optimizer_state_restore_in_place(mesh11, tmp_path):
    """A tiny transformer and its AdamW, laid out by the rules
    (``shard_train_state``), round-trip through sync and async takes into
    a differently seeded sharded pair, in place (every local tensor keeps
    its storage), and into a plain model; a box written by ``async_take``
    is the state at the call, not after a later in-place change.  The
    manifest carries the rules' specs, small boxes ride slabs."""
    cfg = TransformerConfig.tiny()

    def state(seed):
        model, opt = make_train_state(cfg, seed=seed, device="cpu")
        g = torch.Generator().manual_seed(seed + 100)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g).to(p.dtype)
        opt.step()
        return tmesh.shard_train_state(model, opt, mesh11)

    model, opt = state(0)
    with tknobs.override_max_shard_size_bytes(4096):
        tts.Snapshot.take(str(tmp_path / "s"), {"model": model, "optim": opt})
        pending = tts.Snapshot.async_take(str(tmp_path / "a"), {"model": model, "optim": opt})
    before = {n: p.to_local().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        model.embed.weight.to_local().add_(1)  # after the return: not in the snapshot
    pending.wait()
    manifest = tts.Snapshot(str(tmp_path / "s")).metadata.manifest
    e = manifest["0/model/embed.weight"]
    assert isinstance(e, ShardedArrayEntry) and e.spec == [None, "tp"] and e.mesh_shape == [1, 1]
    assert len(e.shards) > 1  # subdivided under the 4096-byte knob
    assert manifest["0/model/layer0.attn.wo.weight"].spec == ["tp", None]
    assert any(s.location.endswith("batched.0") for s in manifest["0/model/layer0.norm1.scale"].shards)
    for snap_dir in ("s", "a"):
        m2, o2 = state(1)
        ptrs = [p.to_local().data_ptr() for p in m2.parameters()]
        tts.Snapshot(str(tmp_path / snap_dir)).restore({"model": m2, "optim": o2})
        assert ptrs == [p.to_local().data_ptr() for p in m2.parameters()]
        for (n, _), b in zip(model.named_parameters(), m2.parameters()):
            assert torch.equal(before[n], b.to_local()), n
        for p, q in zip(model.parameters(), m2.parameters()):
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt.state[p][k].to_local(), o2.state[q][k].to_local())
            assert torch.equal(opt.state[p]["step"], o2.state[q]["step"])
    plain, _ = make_train_state(cfg, seed=2, device="cpu")
    tts.Snapshot(str(tmp_path / "s")).restore({"model": plain})
    for (n, a), b in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(before[n], b), n
