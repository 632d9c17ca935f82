"""The port's take/restore/read_object against the JAX package: a
snapshot written by either package restores bitwise in the other, slab
batching and chunking included; RNG streams round-trip; and the port's
transformer, loaded from flax weights, reproduces the flax logits.
Inputs come from a seeded numpy generator."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu_torch import batcher as tbatcher
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.serialization import tensor_from_buffer


def _host_state(seed):
    """name → numpy/ml_dtypes array: every dtype family, a 0-d array, an
    empty one and one over the (lowered) chunk size."""
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((4, 5)).astype(np.float32),
        "bf16": rng.standard_normal((3, 7)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-(2**40), 2**40, (6,)).astype(np.int64),
        "flag": rng.random(9) > 0.5,
        "c64": (rng.standard_normal(3) + 1j * rng.standard_normal(3)).astype(np.complex64),
        "scalar": np.array(rng.standard_normal(), np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "big": rng.standard_normal((64, 8)).astype(np.float32),
    }


OBJECTS = {"step": 7, "name": "run", "tags": {3, 1}, "sched": {"betas": (0.9, 0.99)}}


def _to_torch(a):
    name = "bool" if a.dtype == np.bool_ else str(a.dtype)
    return tensor_from_buffer(bytearray(a.tobytes()), name, a.shape)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


@pytest.fixture(params=[True, False], ids=["slabs", "no_slabs"])
def small_knobs(request):
    """Chunk size and slab threshold set low on both packages, so a small
    state exercises chunking and (when on) slab batching."""
    batching = request.param
    with jknobs.override_max_chunk_size_bytes(1024), \
            tknobs.override_max_chunk_size_bytes(1024), \
            jknobs.override_slab_size_threshold_bytes(300), \
            tknobs.override_slab_size_threshold_bytes(300), \
            jknobs.override_disable_batching(not batching), \
            tknobs.override_disable_batching(not batching):
        yield batching


def test_port_snapshot_restores_bitwise_in_jax(tmp_path, small_knobs):
    host = _host_state(1)
    tts.Snapshot.take(
        str(tmp_path), {"app": tts.StateDict({**{k: _to_torch(v) for k, v in host.items()}, **OBJECTS})}
    )
    manifest = jts.Snapshot(str(tmp_path)).metadata.manifest
    assert any("batched" in getattr(e, "location", "") for e in manifest.values()) == small_knobs
    assert any(type(e).__name__ == "ChunkedArrayEntry" for e in manifest.values())
    templates = jts.StateDict(
        {**{k: np.zeros_like(v) for k, v in host.items()}, **{k: None for k in OBJECTS}}
    )
    jts.Snapshot(str(tmp_path)).restore({"app": templates})
    for k, v in host.items():
        assert templates[k].dtype == v.dtype and _bytes(templates[k]) == _bytes(v), k
    for k, v in OBJECTS.items():
        assert templates[k] == v
    for k, v in host.items():
        assert _bytes(jts.Snapshot(str(tmp_path)).read_object(f"0/app/{k}")) == _bytes(v), k


def test_jax_snapshot_restores_bitwise_in_port(tmp_path, small_knobs):
    host = _host_state(2)
    jts.Snapshot.take(str(tmp_path), {"app": jts.StateDict({**host, **OBJECTS})})
    templates = tts.StateDict(
        {**{k: torch.zeros_like(_to_torch(v)) for k, v in host.items()}, **{k: None for k in OBJECTS}}
    )
    before = {k: templates[k] for k in host}
    tts.Snapshot(str(tmp_path)).restore({"app": templates})
    for k, v in host.items():
        assert templates[k] is before[k], "restore must update the template in place"
        assert _bytes(templates[k]) == _bytes(v), k
    for k, v in OBJECTS.items():
        assert templates[k] == v
    snap = tts.Snapshot(str(tmp_path))
    for k, v in host.items():
        got = snap.read_object(f"0/app/{k}", device="cpu")
        assert isinstance(got, torch.Tensor) and _bytes(got) == _bytes(v), k
    assert snap.read_object("0/app/step") == 7
    assert snap.read_object("0/app/tags") == {1, 3}
    with pytest.raises(KeyError):
        snap.read_object("0/app/missing")
    # a template-less tensor leaf comes back on the device asked for
    loose = tts.StateDict({k: None for k in host})
    snap.restore({"app": loose}, strict=False, device="cpu")
    for k, v in host.items():
        assert loose[k].device.type == "cpu" and _bytes(loose[k]) == _bytes(v), k


def test_restore_casts_into_template_dtype(tmp_path):
    """A bf16 leaf restored into an f32 template is cast, in place, on the
    host path (the device path's cast is K2's, tested on the card)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 6)).astype(ml_dtypes.bfloat16)
    b = rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16)
    with tknobs.override_slab_size_threshold_bytes(1 << 20):
        tts.Snapshot.take(str(tmp_path), {"m": tts.StateDict(a=_to_torch(a), b=_to_torch(b))})
        misses = dict(tbatcher.DEVICE_UNPACK_MISSES)
        into = tts.StateDict(a=torch.zeros(5, 6), b=torch.zeros(2, 3, dtype=torch.bfloat16))
        tts.Snapshot(str(tmp_path)).restore({"m": into})
    np.testing.assert_array_equal(into["a"].numpy(), a.astype(np.float32))
    assert _bytes(into["b"]) == _bytes(b)
    # both members were in one slab; their CPU templates routed them to
    # the host path, counted before any launch
    assert tbatcher.DEVICE_UNPACK_MISSES["host_template"] == misses["host_template"] + 2


def test_module_and_optimizer_round_trip(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.randn(3, 4)).sum().backward()
    opt.step()
    tts.Snapshot.take(str(tmp_path), {"model": model, "optim": opt, "meta": tts.StateDict(step=1)})
    torch.manual_seed(1)
    model2 = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))
    opt2 = torch.optim.AdamW(model2.parameters(), lr=5e-3)
    model2(torch.randn(3, 4)).sum().backward()
    opt2.step()
    meta = tts.StateDict(step=0)
    tts.Snapshot(str(tmp_path)).restore({"model": model2, "optim": opt2, "meta": meta})
    for (n, p), p2 in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(p, p2), n
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i, st in s1["state"].items():
        for k, v in st.items():
            assert torch.equal(v, s2["state"][i][k]), (i, k)
    assert meta["step"] == 1


def test_pytree_state_matches_jax_manifest(tmp_path):
    rng = np.random.default_rng(4)
    tree = {"b": [rng.standard_normal(3).astype(np.float32), None],
            "a": {"w": rng.standard_normal((2, 2)).astype(np.float32)}}
    ttree = {"b": [_to_torch(tree["b"][0]), None], "a": {"w": _to_torch(tree["a"]["w"])}}
    jts.Snapshot.take(str(tmp_path / "j"), {"p": jts.PyTreeState(tree)})
    tts.Snapshot.take(str(tmp_path / "t"), {"p": tts.PyTreeState(ttree)})
    assert (tts.Snapshot(str(tmp_path / "t")).metadata.to_json()
            == jts.Snapshot(str(tmp_path / "j")).metadata.to_json())
    restored = tts.PyTreeState({"b": [torch.zeros(3), None], "a": {"w": torch.zeros(2, 2)}})
    tts.Snapshot(str(tmp_path / "j")).restore({"p": restored})
    assert _bytes(restored.tree["b"][0]) == _bytes(tree["b"][0])
    assert restored.tree["b"][1] is None
    assert _bytes(restored.tree["a"]["w"]) == _bytes(tree["a"]["w"])


def _draw():
    return (random.random(), np.random.standard_normal(3).tolist(), torch.rand(3).tolist())


def test_rng_state_round_trip_and_take_does_not_perturb(tmp_path):
    random.seed(5)
    np.random.seed(5)
    torch.manual_seed(5)
    rng = tts.RNGState()
    tts.Snapshot.take(str(tmp_path), {"rng": rng})
    first = _draw()
    _draw()  # advance every stream
    tts.Snapshot(str(tmp_path)).restore({"rng": tts.RNGState()})
    assert _draw() == first
    manifest = tts.Snapshot(str(tmp_path)).metadata.manifest
    keys = {p.split("/")[2] for p in manifest if p.count("/") >= 2}
    assert {"python", "numpy", "torch"} <= keys


def test_jax_rng_snapshot_restores_in_port(tmp_path):
    """The JAX package's RNGState keys (python, numpy) restore through
    the port's RNGState."""
    random.seed(9)
    np.random.seed(9)
    jts.Snapshot.take(str(tmp_path), {"rng": jts.RNGState()})
    want = (random.random(), np.random.standard_normal(2).tolist())
    tts.Snapshot(str(tmp_path)).restore({"rng": tts.RNGState()})
    assert (random.random(), np.random.standard_normal(2).tolist()) == want


def test_params_from_jax_reproduces_flax_logits():
    from torchsnapshot_tpu.models.transformer import (
        TransformerConfig as JaxConfig,
        TransformerLM as JaxLM,
    )
    from torchsnapshot_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        params_from_jax,
    )

    jcfg = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32)
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    model = JaxLM(jcfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    want = np.asarray(model.apply(params, jnp.asarray(tokens)))
    cfg = dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float32)
    tmodel = TransformerLM(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_transformer_state_round_trips_through_both_packages(tmp_path):
    """The slice as a whole at a tiny width: the port's model state taken
    by the port restores into the JAX package (as numpy) and back."""
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    torch.manual_seed(0)
    cfg = TransformerConfig.tiny()
    model = TransformerLM(cfg, device="cpu")
    with tknobs.override_slab_size_threshold_bytes(4096):
        tts.Snapshot.take(str(tmp_path), {"model": model})
    sd = model.state_dict()
    jsnap = jts.Snapshot(str(tmp_path))
    for name, t in sd.items():
        assert _bytes(jsnap.read_object(f"0/model/{name}")) == _bytes(t), name
    fresh = TransformerLM(cfg, device="cpu")
    tts.Snapshot(str(tmp_path)).restore({"model": fresh})
    tokens = torch.randint(0, cfg.vocab, (1, 8))
    with torch.no_grad():
        assert torch.equal(fresh(tokens), model(tokens))


def test_legacy_leaf_list_loads_positionally():
    """A ``{"leaves": [...]}`` state dict loads into the tree in its
    flattening order (the JAX package's
    ``test_legacy_leaf_list_loads_positionally``), unless the tree itself
    is named that way (``test_tree_actually_named_leaves_is_not_legacy``)."""
    ts = tts.PyTreeState({"a": torch.zeros(2), "b": {"c": torch.zeros(3)}})
    ts.load_state_dict({"leaves": [torch.ones(2), torch.full((3,), 2.0)]})
    assert torch.equal(ts.tree["a"], torch.ones(2))
    assert torch.equal(ts.tree["b"]["c"], torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="cannot load 1 leaves"):
        ts.load_state_dict({"leaves": [torch.ones(2)]})
    named = tts.PyTreeState({"leaves": [torch.zeros(2), torch.zeros(3)]})
    named.load_state_dict({"leaves": [torch.ones(2), torch.full((3,), 5.0)]})
    assert torch.equal(named.tree["leaves"][1], torch.full((3,), 5.0))


def test_legacy_jax_snapshot_restores_into_the_templates(tmp_path, monkeypatch):
    """A JAX snapshot in the leaf-list layout (``ts/leaves/<i>``) restores
    into a named ``PyTreeState`` positionally, in place: the tree keeps
    its own tensors (the port's counterpart of the JAX package's
    ``test_legacy_snapshot_restore_keeps_sharding``)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    monkeypatch.setattr(
        jts.PyTreeState, "state_dict",
        lambda self: {"leaves": jax.tree_util.tree_leaves(self.tree)},
    )
    jts.Snapshot.take(str(tmp_path / "s"), {"ts": jts.PyTreeState({"w": jnp.asarray(w), "b": jnp.asarray(b)})})
    monkeypatch.undo()
    assert any("ts/leaves/" in p for p in jts.Snapshot(str(tmp_path / "s")).get_manifest())
    tw, tb = torch.zeros(16), torch.zeros(4)
    dest = tts.PyTreeState({"w": tw, "b": tb})
    tts.Snapshot(str(tmp_path / "s")).restore({"ts": dest})
    # b sorts before w: the positional mapping still lands each leaf
    assert dest.tree["w"] is tw and dest.tree["b"] is tb
    assert _bytes(tw) == w.tobytes() and _bytes(tb) == b.tobytes()
