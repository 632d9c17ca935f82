"""The rest of the port's Snapshot API held against the JAX package's on
the same seeded state: ``restore(paths=)``, ``restore(priority=)``,
``materialize``, ``get_manifest``, ``take(leaf_transform=)`` and
``storage_options``.  Snapshots are taken by either package; every
comparison is exact (tolerance 0: no arithmetic on this path, and the
one cast, f32 → bf16 in a leaf transform, rounds alike in both).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu import snapshot as jsnapshot
from torchsnapshot_tpu.storage.fs import FSStoragePlugin as JaxFS
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import snapshot as tsnapshot
from torchsnapshot_tpu_torch.serialization import tensor_from_buffer
from torchsnapshot_tpu_torch.storage import fs as tfs


def _t(a):
    name = "bfloat16" if a.dtype == ml_dtypes.bfloat16 else str(a.dtype)
    return tensor_from_buffer(bytearray(a.tobytes()), name, a.shape)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((64, 8)).astype(np.float32),
        "layer0.w": rng.standard_normal((8, 8)).astype(ml_dtypes.bfloat16),
        "layer1.w": rng.standard_normal((8, 8)).astype(np.float32),
        "head": rng.integers(-1000, 1000, (16,)).astype(np.int64),
    }


def _take(pkg, path, seed, **kw):
    """model (named arrays), optim (a list of moments and a step) and a
    plain StateDict, taken by ``pkg``."""
    arrays = _arrays(seed)
    moments = [a.astype(np.float32) * 0.5 for a in arrays.values() if a.dtype != np.int64]
    if pkg == "port":
        state = {
            "model": tts.StateDict({k: _t(v) for k, v in arrays.items()}),
            "optim": tts.StateDict(moments=[_t(m) for m in moments], step=seed),
            "meta": tts.StateDict(tags={"run": "a", "betas": (0.9, 0.99)}),
        }
        return tts.Snapshot.take(path, state, **kw)
    state = {
        "model": jts.StateDict(arrays),
        "optim": jts.StateDict(moments=moments, step=seed),
        "meta": jts.StateDict(tags={"run": "a", "betas": (0.9, 0.99)}),
    }
    return jts.Snapshot.take(path, state, **kw)


def _templates(pkg, seed):
    """Templates filled from another seed, so restored and untouched
    leaves are told apart."""
    arrays = _arrays(seed)
    moments = [a.astype(np.float32) * 0.5 for a in arrays.values() if a.dtype != np.int64]
    if pkg == "port":
        return {
            "model": tts.StateDict({k: _t(v) for k, v in arrays.items()}),
            "optim": tts.StateDict(moments=[_t(m) for m in moments], step=seed),
            "meta": tts.StateDict(tags=None),
        }
    return {
        "model": jts.StateDict(arrays),
        "optim": jts.StateDict(moments=moments, step=seed),
        "meta": jts.StateDict(tags=None),
    }


def _flat_bytes(state):
    out = {}
    for key, sd in state.items():
        for name, v in sd.items():
            if isinstance(v, list):
                for i, x in enumerate(v):
                    out[f"{key}/{name}/{i}"] = _bytes(x)
            elif isinstance(v, (torch.Tensor, np.ndarray)):
                out[f"{key}/{name}"] = _bytes(v)
            else:
                out[f"{key}/{name}"] = repr(v)
    return out


@pytest.mark.parametrize("taker", ["port", "jax"])
@pytest.mark.parametrize(
    "paths",
    [["model/**"], ["model/layer*", "optim/moments/1"], ["optim/step"], ["nothing/*"]],
    ids=["model", "layers_and_one_moment", "primitive", "no_match"],
)
def test_restore_paths_leaves_the_same_leaves_untouched(tmp_path, taker, paths):
    _take(taker, str(tmp_path), seed=1)
    got = {}
    for pkg in ("port", "jax"):
        state = _templates(pkg, seed=2)
        if pkg == "port":
            tts.Snapshot(str(tmp_path)).restore(state, paths=paths, device="cpu")
        else:
            jts.Snapshot(str(tmp_path)).restore(state, paths=paths)
        got[pkg] = _flat_bytes(state)
    assert got["port"] == got["jax"]
    # and the filter did something where it matched
    untouched = _flat_bytes(_templates("port", seed=2))
    assert (got["port"] == untouched) == (paths == ["nothing/*"])


class _Recorder:
    """The order in which a storage plugin class is asked for objects
    (the metadata excluded)."""

    def __init__(self, monkeypatch, cls):
        self.paths = []
        orig = cls.read

        async def read(plugin, read_io):
            if not read_io.path.startswith("."):
                self.paths.append((read_io.path, tuple(read_io.byte_range or ())))
            return await orig(plugin, read_io)

        monkeypatch.setattr(cls, "read", read)


@pytest.mark.parametrize("batching", [True, False], ids=["slabs", "no_slabs"])
def test_priority_submits_reads_in_the_jax_order(tmp_path, monkeypatch, batching):
    """One read in flight in both packages, so the storage sees the
    admission order; the JAX package's mmap reads are off so its reads
    reach the plugin too."""
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_TORCH_MAX_PER_RANK_IO_CONCURRENCY", "1")
    priority = ["optim/*", "model/layer1*", "model/embed"]
    with jknobs.override_disable_batching(not batching), tknobs.override_disable_batching(not batching), \
            jknobs.override_slab_size_threshold_bytes(600), tknobs.override_slab_size_threshold_bytes(600):
        _take("jax", str(tmp_path), seed=3)
        orders = {}
        for pkg, cls in (("port", tfs.FSStoragePlugin), ("jax", JaxFS)):
            with monkeypatch.context() as m:
                rec = _Recorder(m, cls)
                state = _templates(pkg, seed=4)
                if pkg == "port":
                    tts.Snapshot(str(tmp_path)).restore(state, priority=priority, device="cpu")
                else:
                    with jknobs.override_max_per_rank_io_concurrency(1), jknobs.override_mmap(False):
                        jts.Snapshot(str(tmp_path)).restore(state, priority=priority)
                orders[pkg] = rec.paths
    assert orders["port"] == orders["jax"] and len(orders["port"]) > 2
    for lpath in ("optim/moments/0", "model/layer1.w", "model/embed", "model/head", "meta/x"):
        assert tsnapshot._read_priority_for(lpath, priority) == jsnapshot._read_priority_for(lpath, priority)


@pytest.mark.parametrize("taker", ["port", "jax"])
def test_materialize_equals_jax_leaf_for_leaf(tmp_path, taker):
    _take(taker, str(tmp_path), seed=5)
    with jknobs.override_mmap(False):
        want = jts.Snapshot(str(tmp_path)).materialize()
    got = tts.Snapshot(str(tmp_path)).materialize(device="cpu", priority=["model/*"])

    def walk(a, b, path):
        if isinstance(b, np.ndarray):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu", path
            assert tuple(a.shape) == b.shape and _bytes(a) == _bytes(b), path
        elif isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a == b, path

    walk(got, want, "")
    with pytest.raises(ValueError, match="out of range"):
        tts.Snapshot(str(tmp_path)).materialize(rank=1)


@pytest.mark.parametrize("taker", ["port", "jax"])
def test_get_manifest_equals_jax(tmp_path, taker):
    _take(taker, str(tmp_path), seed=6)
    got = {k: v.to_dict() for k, v in tts.Snapshot(str(tmp_path)).get_manifest().items()}
    want = {k: v.to_dict() for k, v in jts.Snapshot(str(tmp_path)).get_manifest().items()}
    assert got == want


def test_leaf_transform_writes_what_the_jax_transform_writes(tmp_path):
    """f32 leaves cast to bf16 for the checkpoint: the same manifest and
    the same stored bytes as the JAX package's transform; restored into
    f32 templates they are the bf16-rounded originals."""
    def port_cast(path, v):
        return v.to(torch.bfloat16) if isinstance(v, torch.Tensor) and v.dtype == torch.float32 else v

    def jax_cast(path, v):
        return v.astype(ml_dtypes.bfloat16) if isinstance(v, np.ndarray) and v.dtype == np.float32 else v

    _take("port", str(tmp_path / "port"), seed=7, leaf_transform=port_cast)
    _take("jax", str(tmp_path / "jax"), seed=7, leaf_transform=jax_cast)
    port_man = {k: v.to_dict() for k, v in jts.Snapshot(str(tmp_path / "port")).get_manifest().items()}
    jax_man = {k: v.to_dict() for k, v in jts.Snapshot(str(tmp_path / "jax")).get_manifest().items()}
    assert port_man == jax_man
    assert port_man["0/model/embed"]["dtype"] == "bfloat16"
    for lpath in ("0/model/embed", "0/optim/moments/2"):
        assert _bytes(tts.Snapshot(str(tmp_path / "port")).read_object(lpath, device="cpu")) == _bytes(
            jts.Snapshot(str(tmp_path / "jax")).read_object(lpath)
        )
    state = _templates("port", seed=8)
    tts.Snapshot(str(tmp_path / "port")).restore(state, device="cpu")
    want = torch.from_numpy(_arrays(7)["embed"]).to(torch.bfloat16).to(torch.float32)
    assert state["model"]["embed"].dtype == torch.float32
    assert torch.equal(state["model"]["embed"], want)


def test_storage_options_are_forwarded_and_unported_ones_refused(tmp_path, monkeypatch):
    seen = []

    class Recording(tfs.FSStoragePlugin):
        def __init__(self, root, **opts):
            seen.append(opts)
            super().__init__(root)

    monkeypatch.setattr(tfs, "FSStoragePlugin", Recording)
    opts = {"probe": 7, "host_cache": False}
    snap = _take("port", str(tmp_path / "s"), seed=9, storage_options=opts)
    snap.restore(_templates("port", seed=9), device="cpu")
    tts.Snapshot(str(tmp_path / "s"), storage_options=opts).verify()
    assert len(seen) >= 4 and all(o == {"probe": 7} for o in seen)
    monkeypatch.undo()
    # an option the plugin does not take fails in its constructor, as in
    # the JAX package
    for pkg in ("port", "jax"):
        with pytest.raises(TypeError, match="bogus"):
            _take(pkg, str(tmp_path / f"bad_{pkg}"), seed=9, storage_options={"bogus": 1})
    # the reserved "tier" option builds a fast tier over the durable url:
    # both tiers hold the committed write-through take
    tier_opts = {"tier": {"fast_url": str(tmp_path / "tier_fast"), "policy": "write_through"}}
    _take("port", str(tmp_path / "tier"), seed=9, storage_options=tier_opts)
    for root in ("tier", "tier_fast"):
        assert (tmp_path / root / ".snapshot_metadata").exists(), root
    # the chunk store: the port's take and async_take restore in the JAX package
    for i, cas in enumerate((True, str(tmp_path / "pool"))):
        _take("port", str(tmp_path / f"cas_take{i}"), seed=9, cas=cas)
        tts.Snapshot.async_take(str(tmp_path / f"cas_async{i}"), _templates("port", 9), cas=cas).wait()
        for name in (f"cas_take{i}", f"cas_async{i}"):
            assert tts.Snapshot(str(tmp_path / name)).metadata.cas["chunks"]
            got = _templates("jax", seed=1)
            jts.Snapshot(str(tmp_path / name)).restore(got)
            want = _arrays(9)
            for k, v in want.items():
                assert _bytes(got["model"][k]) == _bytes(v), (name, k)
    # publish_to publishes the committed snapshot; the JAX package reads
    # the record
    from torchsnapshot_tpu.publish import PublishStore as JaxPublishStore
    from torchsnapshot_tpu_torch.publish import Publisher

    pub = Publisher(str(tmp_path / "pub"))
    rec_path = snap.publish_to(pub, 1)
    pub.close()
    jstore = JaxPublishStore(str(tmp_path / "pub"))
    rec = jstore.read_record(rec_path)
    jstore.sync_close()
    assert rec["source"] == "snapshot" and rec["bases"] == [snap.path.rstrip("/")]
    assert {p.split("/")[0] for p in rec["leaves"]} == {"model", "optim", "meta"}
    # repair is ported: a complete snapshot has nothing to heal
    assert snap.repair_degraded([str(tmp_path)]) == []
