"""Budgeted reads (``read_object(..., memory_budget_bytes=...)``), restore-
time integrity (VERIFY_ON_RESTORE) and WRITE_CHECKSUMS in the port, held
against the JAX package on the same files.

Every comparison is bitwise: identity reads, and casts the two packages
make the same way (bf16 → f32, f32 → f64 are exact).  Inputs come from a
seeded numpy generator.  K6's plain version is held against the JAX
package's in ``test_torch_tile_update.py``.
"""

import glob
import os
import pathlib

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.storage.fs import FSStoragePlugin as JaxFS
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.preparers import array as tarray
from torchsnapshot_tpu_torch.serialization import tensor_from_buffer
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin as TorchFS


def _np(rng, dtype, n):
    if dtype == "bf16":
        return rng.standard_normal(n).astype(ml_dtypes.bfloat16)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(n).astype(dtype)
    return rng.integers(-1000, 1000, n).astype(dtype)


def _t(a):
    """numpy (ml_dtypes included) → torch, bitwise."""
    name = "bfloat16" if a.dtype == ml_dtypes.bfloat16 else str(a.dtype)
    return tensor_from_buffer(bytearray(a.tobytes()), name, a.shape)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


class _RangeSpy:
    """Records the length of every ranged read a storage plugin class
    serves."""

    def __init__(self, monkeypatch, cls):
        self.ranges = []
        orig = cls.read

        async def spy(plugin, read_io):
            if read_io.byte_range is not None:
                self.ranges.append(read_io.byte_range[1] - read_io.byte_range[0])
            return await orig(plugin, read_io)

        monkeypatch.setattr(cls, "read", spy)


def _take(package, path, state, chunk=None):
    """Take ``{"app": StateDict(state)}`` with ``package`` ("port" or
    "jax"), chunked at ``chunk`` bytes when given."""
    if package == "port":
        ctx = tknobs.override_max_chunk_size_bytes(chunk or (1 << 30))
        with ctx:
            tts.Snapshot.take(path, {"app": tts.StateDict({k: _t(v) for k, v in state.items()})})
    else:
        with jknobs.override_max_chunk_size_bytes(chunk or (1 << 30)):
            jts.Snapshot.take(path, {"app": jts.StateDict(state)})


_TAKERS = ("port", "jax")  # which package takes the snapshot a test reads


@pytest.mark.parametrize("chunk", [None, 1 << 18], ids=["whole", "chunked"])
def test_tiled_read_bounded_buffers_matches_jax(tmp_path, monkeypatch, chunk):
    """A 1 MiB array read under a 64 KiB budget issues ranged sub-reads no
    larger than the budget, in both packages, on a snapshot either took;
    the results are bitwise equal."""
    src = _np(np.random.default_rng(0), np.float32, 1 << 18)
    for taker in _TAKERS:
        path = str(tmp_path / taker)
        _take(taker, path, {"w": src}, chunk)
        spy = _RangeSpy(monkeypatch, TorchFS)
        got = tts.Snapshot(path).read_object("0/app/w", memory_budget_bytes=1 << 16, device="cpu")
        jspy = _RangeSpy(monkeypatch, JaxFS)
        want = jts.Snapshot(path).read_object("0/app/w", memory_budget_bytes=1 << 16)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert _bytes(got) == _bytes(want) == src.tobytes(), taker
        assert spy.ranges and max(spy.ranges) <= 1 << 16
        assert len(spy.ranges) == len(jspy.ranges) == 16
        monkeypatch.undo()


@pytest.mark.parametrize("template", ["numpy", "tensor"])
def test_chunked_tiled_read_into_templates(tmp_path, monkeypatch, template):
    """A chunked entry read with a budget into a numpy and a CPU tensor
    template (filled in place, returned) tiles every chunk larger than
    the budget, and matches the JAX package's read into a numpy
    template, on a snapshot either package took."""
    src = _np(np.random.default_rng(1), np.float32, 1 << 18)
    for taker in _TAKERS:
        path = str(tmp_path / taker)
        _take(taker, path, {"w": src}, chunk=1 << 18)
        manifest = jts.Snapshot(path).get_manifest()
        assert type(manifest["0/app/w"]).__name__ == "ChunkedArrayEntry"
        tmpl = np.zeros(1 << 18, np.float32) if template == "numpy" else torch.zeros(1 << 18)
        spy = _RangeSpy(monkeypatch, TorchFS)
        out = tts.Snapshot(path).read_object("0/app/w", obj_out=tmpl, memory_budget_bytes=1 << 15)
        assert out is tmpl
        assert spy.ranges and max(spy.ranges) <= 1 << 15
        monkeypatch.undo()
        jt = np.zeros(1 << 18, np.float32)
        jts.Snapshot(path).read_object("0/app/w", obj_out=jt, memory_budget_bytes=1 << 15)
        assert _bytes(tmpl) == _bytes(jt) == src.tobytes(), taker


@pytest.mark.parametrize("pair", [("bf16", np.float32), (np.float32, np.float64), (np.int32, np.int64)],
                         ids=["bf16-f32", "f32-f64", "i32-i64"])
def test_tiled_read_into_casting_template_verifies_raw_bytes(tmp_path, pair):
    """A budgeted read into a wider template under VERIFY_ON_RESTORE: the
    fold checks the stored bytes, not the cast ones, and the cast result
    equals the JAX package's bitwise, on a snapshot either package took."""
    stored, wide = pair
    src = _np(np.random.default_rng(2), stored, (1 << 16) + 3)
    for taker in _TAKERS:
        path = str(tmp_path / taker)
        _take(taker, path, {"w": src})
        tmpl = torch.zeros(src.size, dtype=_t(np.zeros(1, wide)).dtype)
        jt = np.zeros(src.size, wide)
        with tknobs.override_verify_on_restore(True), jknobs.override_verify_on_restore(True):
            out = tts.Snapshot(path).read_object("0/app/w", obj_out=tmpl, memory_budget_bytes=1 << 12)
            jts.Snapshot(path).read_object("0/app/w", obj_out=jt, memory_budget_bytes=1 << 12)
        assert out is tmpl
        assert _bytes(tmpl) == jt.tobytes() == src.astype(wide).tobytes(), taker


def _flip_byte_of_largest_object(root, where=0.5):
    target = max(
        (p for p in pathlib.Path(root).rglob("*") if p.is_file() and "metadata" not in p.name),
        key=lambda p: p.stat().st_size,
    )
    good = target.read_bytes()
    bad = bytearray(good)
    bad[int(len(bad) * where)] ^= 0x40
    target.write_bytes(bytes(bad))
    return target, good


@pytest.mark.parametrize("template", ["numpy", "tensor", "none"])
def test_tiled_read_detects_corruption_and_the_template_stays_usable(tmp_path, template):
    """A flipped payload byte fails a budgeted read under VERIFY_ON_RESTORE
    (the folded crc32 of the tiles), as it fails the JAX package's; the
    same template then takes a retry once the payload is repaired.
    Without the knob the corrupted payload reads back.  For a whole and a
    chunked array."""
    src = _np(np.random.default_rng(3), np.float32, 1 << 18)
    for name, chunk in (("whole", None), ("chunked", 1 << 18)):
        path = str(tmp_path / name)
        _take("port", path, {"w": src}, chunk)
        target, good = _flip_byte_of_largest_object(path)
        snap = tts.Snapshot(path)
        tmpl = {"numpy": np.zeros(1 << 18, np.float32), "tensor": torch.zeros(1 << 18), "none": None}[template]
        with tknobs.override_verify_on_restore(True), jknobs.override_verify_on_restore(True):
            with pytest.raises(RuntimeError, match="crc32"):
                snap.read_object("0/app/w", obj_out=tmpl, memory_budget_bytes=1 << 14, device="cpu")
            with pytest.raises(Exception, match="crc32"):
                jts.Snapshot(path).read_object("0/app/w", memory_budget_bytes=1 << 14)
        out = snap.read_object("0/app/w", memory_budget_bytes=1 << 14, device="cpu")
        assert _bytes(out) != src.tobytes()
        target.write_bytes(good)
        with tknobs.override_verify_on_restore(True):
            out = snap.read_object("0/app/w", obj_out=tmpl, memory_budget_bytes=1 << 14, device="cpu")
        assert (tmpl is None or out is tmpl) and _bytes(out) == src.tobytes(), name


def test_unbudgeted_verify_leaves_templates_untouched(tmp_path):
    """Without a budget the whole payload is checked before any copy: a
    corrupted read raises and the template keeps its bytes — for a
    single array, a chunked one, and slab members restored together."""
    rng = np.random.default_rng(4)
    state = {"a": _np(rng, np.float32, 4096), "b": _np(rng, np.float32, 4096)}
    _take("port", str(tmp_path / "s"), state)  # a and b share a slab
    _take("port", str(tmp_path / "c"), {"w": _np(rng, np.float32, 1 << 16)}, chunk=1 << 14)
    _flip_byte_of_largest_object(tmp_path / "s", where=0.75)
    _flip_byte_of_largest_object(tmp_path / "c", where=0.9)
    with tknobs.override_verify_on_restore(True):
        dest = tts.StateDict(a=torch.full((4096,), 7.0), b=torch.full((4096,), 7.0))
        with pytest.raises(RuntimeError, match="checksum mismatch"):
            tts.Snapshot(str(tmp_path / "s")).restore({"app": dest})
        assert bool((dest["a"] == 7).all()) and bool((dest["b"] == 7).all())
        tmpl = torch.full((1 << 16,), 7.0)
        with pytest.raises(RuntimeError, match="checksum mismatch"):
            tts.Snapshot(str(tmp_path / "c")).read_object("0/app/w", obj_out=tmpl)
        assert bool((tmpl == 7).all())


def test_tiled_read_of_a_slab_member(tmp_path, monkeypatch):
    """An array that sits in a slab (a byte range of a shared object) is
    tiled inside its range."""
    rng = np.random.default_rng(5)
    state = {"a": _np(rng, np.int64, 8192), "b": _np(rng, "bf16", 3001)}
    _take("port", str(tmp_path / "s"), state)
    snap = tts.Snapshot(str(tmp_path / "s"))
    assert snap.metadata.manifest["0/app/b"].byte_range is not None
    spy = _RangeSpy(monkeypatch, TorchFS)
    with tknobs.override_verify_on_restore(True):
        for name, src in state.items():
            out = snap.read_object(f"0/app/{name}", memory_budget_bytes=1000, device="cpu")
            assert _bytes(out) == src.tobytes()
            want = jts.Snapshot(str(tmp_path / "s")).read_object(f"0/app/{name}")
            assert _bytes(want) == src.tobytes()
    assert spy.ranges and max(spy.ranges) <= 1000


def test_budget_misses_are_counted_and_read_whole(tmp_path):
    """A template the tiles cannot land in (non-contiguous) is decided at
    plan time: read whole, counted in TILE_MISSES."""
    src = _np(np.random.default_rng(6), np.float32, 64 * 64)
    _take("port", str(tmp_path / "s"), {"w": src.reshape(64, 64)})
    before = dict(tarray.TILE_MISSES)
    tmpl = torch.zeros(64, 64).t()
    out = tts.Snapshot(str(tmp_path / "s")).read_object("0/app/w", obj_out=tmpl, memory_budget_bytes=1024)
    assert out is tmpl and _bytes(tmpl.contiguous()) == src.tobytes()
    assert tarray.TILE_MISSES["layout"] == before["layout"] + 1


def test_write_checksums_off_restores_in_both_packages(tmp_path):
    """WRITE_CHECKSUMS=0 (in the package that takes) writes no digests;
    both packages restore the snapshot bitwise, VERIFY_ON_RESTORE on
    (nothing to check) and with a budget."""
    rng = np.random.default_rng(8)
    state = {"w": _np(rng, np.float32, 1 << 14), "small": _np(rng, np.int64, 33)}
    for taker in _TAKERS:
        path = str(tmp_path / taker)
        knob = tknobs if taker == "port" else jknobs
        with knob.override_write_checksums(False):
            _take(taker, path, state)
        meta = tts.Snapshot(path).metadata
        assert not meta.objects
        assert all(getattr(e, "crc32", None) is None for e in meta.manifest.values())
        with tknobs.override_verify_on_restore(True), jknobs.override_verify_on_restore(True):
            dest = tts.StateDict(w=torch.zeros(1 << 14), small=torch.zeros(33, dtype=torch.int64))
            tts.Snapshot(path).restore({"app": dest})
            jdest = jts.StateDict(w=np.zeros(1 << 14, np.float32), small=np.zeros(33, np.int64))
            jts.Snapshot(path).restore({"app": jdest})
            tiled = tts.Snapshot(path).read_object("0/app/w", memory_budget_bytes=1 << 12, device="cpu")
        for k, v in state.items():
            assert _bytes(dest[k]) == _bytes(jdest[k]) == v.tobytes(), (taker, k)
        assert _bytes(tiled) == state["w"].tobytes()


def test_write_checksums_on_records_what_the_jax_package_records(tmp_path):
    """With checksums on (the default) the port records the same crc32 per
    payload and the same object digests as the JAX package."""
    state = {"w": _np(np.random.default_rng(9), np.float32, 1 << 12)}
    _take("port", str(tmp_path / "p"), state)
    _take("jax", str(tmp_path / "j"), state)
    pm, jm = tts.Snapshot(str(tmp_path / "p")).metadata, jts.Snapshot(str(tmp_path / "j")).metadata
    assert pm.manifest["0/app/w"].crc32 == jm.manifest["0/app/w"].crc32 is not None
    assert pm.objects == jm.objects and pm.objects


def test_read_object_budget_caps_the_scheduler(tmp_path, monkeypatch):
    """The budget also caps the read scheduler: the sum of the tiles in
    flight never exceeds it."""
    import asyncio

    src = _np(np.random.default_rng(10), np.float32, 1 << 16)
    _take("port", str(tmp_path / "s"), {"w": src})
    state = {"in_flight": 0, "peak": 0}
    orig = TorchFS.read

    async def spy(plugin, read_io):
        n = read_io.byte_range[1] - read_io.byte_range[0] if read_io.byte_range else 0
        state["in_flight"] += n
        state["peak"] = max(state["peak"], state["in_flight"])
        await asyncio.sleep(0.001)
        try:
            return await orig(plugin, read_io)
        finally:
            state["in_flight"] -= n

    monkeypatch.setattr(TorchFS, "read", spy)
    budget = 3 * (1 << 12)
    out = tts.Snapshot(str(tmp_path / "s")).read_object("0/app/w", memory_budget_bytes=budget, device="cpu")
    assert _bytes(out) == src.tobytes()
    assert 0 < state["peak"] <= budget


def test_no_template_cpu_read_returns_a_tensor_of_the_stored_shape(tmp_path):
    src = _np(np.random.default_rng(11), "bf16", 96 * 40).reshape(96, 40)
    _take("port", str(tmp_path / "s"), {"w": src}, chunk=1 << 12)
    out = tts.Snapshot(str(tmp_path / "s")).read_object("0/app/w", memory_budget_bytes=1 << 10, device="cpu")
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (96, 40)
    assert _bytes(out) == src.tobytes()
    assert glob.glob(str(tmp_path / "s" / "0" / "*"))
    assert os.path.exists(tmp_path / "s" / ".snapshot_metadata")


@pytest.mark.parametrize("encoding", ["codec", "cas"])
def test_encoded_objects_raise_a_typed_error_before_any_byte_lands(tmp_path, encoding):
    """A JAX snapshot whose object is stored compressed (zlib frames,
    striped) or as CAS chunk references: every read path of the port
    raises ``EncodedPayloadError`` naming the location and its table,
    and the template is never written (it stays all zeros)."""
    w = np.random.default_rng(7).standard_normal(1 << 22).astype(np.float32)  # 16 MiB
    path = str(tmp_path / "run" / "s")
    if encoding == "codec":
        with jknobs.override_codec("zlib"), jknobs.override_stripe_min_object_size_bytes(4 << 20):
            jts.Snapshot.take(path, {"m": jts.StateDict(w=w)})
        table = "codec frame table"
    else:
        jts.Snapshot.take(path, {"m": jts.StateDict(w=w)}, cas=True)
        table = "CAS chunk table"
    # the JAX package reads its own snapshot back bitwise
    np.testing.assert_array_equal(jts.Snapshot(path).read_object("0/m/w"), w)
    snap = tts.Snapshot(path)
    tmpl = torch.zeros(w.size)
    for budget in (1 << 20, None):
        with pytest.raises(tts.EncodedPayloadError, match=table) as e:
            snap.read_object("0/m/w", obj_out=tmpl, memory_budget_bytes=budget, device="cpu")
        assert e.value.location == "0/m/w"
        with pytest.raises(tts.EncodedPayloadError, match=table):
            snap.read_object("0/m/w", memory_budget_bytes=budget, device="cpu")
    dest = tts.StateDict(w=tmpl)
    with pytest.raises(tts.EncodedPayloadError, match=table):
        snap.restore({"m": dest})
    assert not tmpl.any()



def test_encoded_object_under_a_later_key_refuses_the_whole_restore(tmp_path):
    """A restore refuses an encoded object before any key restores: an
    earlier key's template stays untouched when a later key holds it."""
    path = str(tmp_path / "s")
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(64).astype(np.float32))
    with tts.knobs.override_disable_batching(True):  # an object of its own each
        tts.Snapshot.take(path, {"a": tts.StateDict(v=w.clone()), "m": tts.StateDict(w=w.clone())})
    snap = tts.Snapshot(path)
    location = snap.metadata.manifest["0/m/w"].location
    assert location != snap.metadata.manifest["0/a/v"].location
    snap.metadata.codecs = {location: [[0, 64]]}  # the table's contents are not read
    first, later = torch.zeros(64), torch.zeros(64)
    with pytest.raises(tts.EncodedPayloadError, match="codec frame table") as e:
        snap.restore({"a": tts.StateDict(v=first), "m": tts.StateDict(w=later)}, device="cpu")
    assert e.value.location == location
    assert not first.any() and not later.any()