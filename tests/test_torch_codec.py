"""The port's codec layer (``codec.py``) against the JAX package's, and
compressed snapshots across the two packages.

Units: frame headers, shuffle/unshuffle (native and numpy), zlib and
huff frames byte-identical for the same part, store-raw under
``CODEC_MIN_RATIO`` and the backend part floor, typed errors on bad
frames, ``CodecUnavailableError`` with ``zstandard`` hidden, codec
tables, ``framed_read`` over ranges that cross frames.  Interop (fs,
striping at a 128 KiB threshold and 64 KiB parts, ``CODEC=zlib`` and
``huff``): either package takes and the other restores bitwise,
including budgeted ``read_object`` with tiles across frames,
``materialize`` and deep ``verify``; the manifests' ``codecs`` tables
are equal; an incremental port take over a JAX-encoded base links it
and carries its table.  Comparisons are exact (lossless codecs).
"""

import asyncio
import contextlib
import filecmp
import logging
import os
import sys

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import codec as jcodec
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.storage.fs import FSStoragePlugin as JFS
from torchsnapshot_tpu_torch import codec as tcodec
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import obs as tobs
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin as TFS

PART = 64 << 10
MIN = 128 << 10


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _floats(n, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _spec(mod, name, level=0, min_ratio=1.05):
    return mod.WriteSpec(name, level, min_ratio)


def test_shuffle_and_frame_headers_match_jax():
    rng = np.random.default_rng(1)
    for stride in (2, 4, 8):
        for n in (0, 1, stride, 4099, 65536 + 3):
            data = rng.integers(0, 256, n, dtype=np.uint8)
            sh = tcodec.shuffle(memoryview(data), stride)
            assert bytes(sh) == bytes(jcodec.shuffle(memoryview(data), stride))
            assert bytes(tcodec.unshuffle(memoryview(sh), stride)) == data.tobytes()
            with tknobs.override_enable_native_ext(False):
                assert bytes(tcodec.shuffle(memoryview(data), stride)) == bytes(sh)
                assert bytes(tcodec.unshuffle(memoryview(sh), stride)) == data.tobytes()
    for dt in ("float16", "bfloat16", "float32", "float64", "int64", "uint8", "bool", None, ""):
        assert tcodec.filter_for_dtype(dt) == jcodec.filter_for_dtype(dt)
    assert (tcodec.FRAME_MAGIC, tcodec.FRAME_VERSION, tcodec.FRAME_HEADER_BYTES, tcodec.CODEC_IDS) == (
        jcodec.FRAME_MAGIC, jcodec.FRAME_VERSION, jcodec.FRAME_HEADER_BYTES, jcodec.CODEC_IDS)
    frame = jcodec.encode_frame(memoryview(_floats(5000).view(np.uint8)), _spec(jcodec, "zlib"), 4)
    assert tcodec.parse_frame_header(memoryview(frame)) == jcodec.parse_frame_header(memoryview(frame))


def test_zlib_and_huff_frames_are_byte_identical_to_jax():
    parts = [
        _floats(30000, 1).view(np.uint8),  # f32 noise: compresses after shuffle
        _floats(40001, 2, np.float16).view(np.uint8),  # odd length: a tail past the elements
        np.zeros(70000, np.uint8),
        np.random.default_rng(3).integers(0, 256, 20000, dtype=np.uint8),  # incompressible
        np.zeros(0, np.uint8),
    ]
    c0 = dict(tobs.counters())
    for data in parts:
        for name in ("zlib", "huff"):
            for stride in (0, 2, 4):
                for level in (0, 1, 6):
                    if name == "huff" and level:
                        continue
                    got = tcodec.encode_frame(memoryview(data), _spec(tcodec, name, level), stride)
                    want = jcodec.encode_frame(memoryview(data), _spec(jcodec, name, level), stride)
                    assert bytes(got) == bytes(want), (name, stride, level, data.nbytes)
                    raw, n = tcodec.decode_frame(memoryview(want))
                    assert bytes(raw) == data.tobytes() and n == len(want)
    c1 = tobs.counters()
    assert c1["storage.codec.parts_encoded"] > c0.get("storage.codec.parts_encoded", 0)
    assert c1["storage.codec.parts_raw_fallback"] > c0.get("storage.codec.parts_raw_fallback", 0)


def test_store_raw_below_the_min_ratio_and_the_part_floor():
    noise = np.random.default_rng(4).integers(0, 256, 8192, dtype=np.uint8)
    frame = tcodec.encode_frame(memoryview(noise), _spec(tcodec, "zlib"), 0)
    assert frame[5] == 0 and len(frame) == 8192 + 24 and bytes(frame[24:]) == noise.tobytes()
    zeros = np.zeros(8192, np.uint8)
    assert tcodec.encode_frame(memoryview(zeros), _spec(tcodec, "zlib"), 0)[5] == 1
    # a ratio no frame can meet stores raw; the same in both packages
    for ratio in (1.0, 1.05, 2.0, 1000.0):
        for data in (zeros, _floats(2048).view(np.uint8)):
            got = tcodec.encode_frame(memoryview(data), _spec(tcodec, "zlib", min_ratio=ratio), 4)
            want = jcodec.encode_frame(memoryview(data), _spec(jcodec, "zlib", min_ratio=ratio), 4)
            assert bytes(got) == bytes(want)
    assert tcodec.encode_frame(memoryview(zeros), _spec(tcodec, "zlib", min_ratio=1000.0), 0)[5] == 0
    # under a backend's non-final part floor the raw frame is kept
    floored = tcodec.encode_frame(memoryview(zeros), _spec(tcodec, "zlib"), 0, min_frame_bytes=4096)
    assert floored[5] == 0
    assert bytes(floored) == bytes(jcodec.encode_frame(memoryview(zeros), _spec(jcodec, "zlib"), 0, min_frame_bytes=4096))
    with tknobs.override_codec_min_ratio(0.5):
        assert tknobs.get_codec_min_ratio() == 1.0


def test_bad_frames_raise_codec_frame_error():
    data = _floats(4096).view(np.uint8)
    for name in ("zlib", "huff"):
        frame = np.array(tcodec.encode_frame(memoryview(data), _spec(tcodec, name), 4), dtype=np.uint8)
        bad = frame.copy()
        bad[:4] = np.frombuffer(b"XXXX", np.uint8)
        cases = [bad, frame[:10], frame[:-5]]
        bad = frame.copy()
        bad[4] = 9  # version
        cases.append(bad)
        bad = frame.copy()
        bad[5] = 77  # codec id
        cases.append(bad)
        bad = frame.copy()
        bad[24:64] = 0xFF  # a corrupt payload
        cases.append(bad)
        for c in cases:
            with pytest.raises(tcodec.CodecFrameError):
                tcodec.decode_frame(memoryview(c))
            with pytest.raises(jcodec.CodecFrameError):
                jcodec.decode_frame(memoryview(c))
        assert issubclass(tcodec.CodecFrameError, IOError)


def test_codec_unavailable_with_zstandard_hidden(monkeypatch, caplog):
    data = np.zeros(1 << 14, np.uint8)
    frame = jcodec.encode_frame(memoryview(data), _spec(jcodec, "zstd"), 0)
    assert frame[5] == tcodec.CODEC_IDS["zstd"]
    assert bytes(tcodec.decode_frame(memoryview(frame))[0]) == data.tobytes()
    raw_frame = jcodec.encode_frame(memoryview(np.arange(256, dtype=np.uint8)), _spec(jcodec, "zstd"), 0)
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(tcodec.CodecUnavailableError, match="zstd") as e:
        tcodec.decode_frame(memoryview(frame))
    assert e.value.codec == "zstd"
    assert bytes(tcodec.decode_frame(memoryview(raw_frame))[0]) == bytes(range(256))
    # the write side degrades to raw with one warning
    tcodec._warned_unavailable.discard("zstd")
    with caplog.at_level(logging.WARNING), tknobs.override_codec("zstd"):
        assert tcodec.resolve_write_spec() is None
        assert tcodec.resolve_codec() == "raw"
    assert sum("not installed" in r.getMessage() for r in caplog.records) == 1
    assert "zstd" not in tcodec.available_codecs()
    with tknobs.override_codec("no-such-codec"):
        assert tcodec.resolve_write_spec() is None


def test_tables_and_framed_reads_across_frames_match_jax(tmp_path):
    data = _floats(50000, 5).view(np.uint8)  # 200 KB
    part = 48 << 10
    frames = [jcodec.encode_frame(memoryview(data[lo : lo + part]), _spec(jcodec, "huff"), 4)
              for lo in range(0, data.nbytes, part)]
    stored = b"".join(bytes(f) for f in frames)
    table = tcodec.make_table("huff", part, data.nbytes, [len(f) for f in frames], [1, 2, len(stored)])
    assert table == jcodec.make_table("huff", part, data.nbytes, [len(f) for f in frames], [1, 2, len(stored)])
    assert tcodec.validate_table(table) and tcodec.table_stored_size(table) == len(stored)
    for bad in ({}, {"codec": "zlib"}, {"codec": 1, "part_size": 1, "raw_size": 1, "parts": [1]},
                {"codec": "zlib", "part_size": 0, "raw_size": 1, "parts": [1]},
                {"codec": "zlib", "part_size": 4, "raw_size": 1, "parts": [0]}):
        assert not tcodec.validate_table(bad) and not jcodec.validate_table(bad)
    assert not tcodec.validate_table([[0, 64]])  # not a dict (the JAX check raises on it)
    os.makedirs(tmp_path / "fs")
    (tmp_path / "fs" / "obj").write_bytes(stored)
    tp, jp = TFS(str(tmp_path / "fs")), JFS(str(tmp_path / "fs"))
    rng = np.random.default_rng(6)
    ranges = [None, [0, data.nbytes], [part - 1, part + 1], [0, 0], [7, 3 * part + 9]]
    ranges += [sorted(rng.integers(0, data.nbytes + 1, 2).tolist()) for _ in range(10)]
    for rr in ranges:
        got = _run(tcodec.framed_read(tp, "obj", table, byte_range=rr))
        want = _run(jcodec.framed_read(jp, "obj", table, byte_range=rr))
        lo, hi = rr or (0, data.nbytes)
        assert bytes(got) == bytes(want) == data[lo:hi].tobytes()
    into = np.zeros(2 * part, np.uint8)
    assert _run(tcodec.framed_read(tp, "obj", table, byte_range=[100, 100 + 2 * part], into=into)) is into
    assert into.tobytes() == data[100 : 100 + 2 * part].tobytes()
    with pytest.raises(tcodec.CodecFrameError, match="outside"):
        _run(tcodec.framed_read(tp, "obj", table, byte_range=[0, data.nbytes + 1]))
    _run(tp.close())


def _state(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal(70001).astype(np.float32),  # striped, 5 frames, ragged last
        "h": rng.standard_normal(40000).astype(np.float16),
        "d": rng.standard_normal(20000),  # f64, one frame
        "i": rng.integers(-99, 99, 33000).astype(np.int64),
        "z": np.zeros(50000, np.float32),
        "s": np.float32(3.5) * np.ones(10, np.float32),
    }


@contextlib.contextmanager
def _knobs(codec, batching=False):
    with contextlib.ExitStack() as stack:
        for k in (tknobs, jknobs):
            stack.enter_context(k.override_codec(codec))
            stack.enter_context(k.override_stripe_part_size_bytes(PART))
            stack.enter_context(k.override_stripe_min_object_size_bytes(MIN))
            stack.enter_context(k.override_disable_batching(not batching))
        yield


def _port_take(path, state, asynchronous=False, base=None):
    app = {"app": tts.StateDict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})}
    if asynchronous:
        return tts.Snapshot.async_take(path, app, base=base).wait()
    return tts.Snapshot.take(path, app, base=base)


def _port_restored(path, state):
    dest = tts.StateDict({k: torch.zeros(v.shape, dtype=torch.from_numpy(np.array(v)).dtype) for k, v in state.items()})
    tts.Snapshot(path).restore({"app": dest}, device="cpu")
    return {k: t.numpy() for k, t in dest.items()}


def _jax_restored(path, state):
    dest = jts.StateDict({k: np.zeros_like(v) for k, v in state.items()})
    jts.Snapshot(path).restore({"app": dest})
    return dict(dest)


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.mark.parametrize("codec", ["zlib", "huff"])
def test_jax_encoded_snapshot_restores_bitwise_in_the_port(tmp_path, codec):
    state = _state(7)
    path = str(tmp_path / "s")
    with _knobs(codec, batching=True):
        jts.Snapshot.take(path, {"app": jts.StateDict(dict(state))})
    md = jts.Snapshot(path).metadata
    assert md.codecs and any(len(t["parts"]) > 1 for t in md.codecs.values())
    c0 = dict(tobs.counters())
    _assert_bitwise(_port_restored(path, state), state)
    assert tobs.counters()["storage.codec.parts_decoded"] > c0.get("storage.codec.parts_decoded", 0)
    snap = tts.Snapshot(path)
    loc = md.manifest["0/app/w"].location
    frame_raw = md.codecs[loc]["part_size"]
    # budgets that do not divide the frames: tiles straddle them
    for budget in (frame_raw + 4, 3 * frame_raw // 2 + 8, 1 << 20):
        tmpl = torch.zeros(state["w"].shape)
        assert snap.read_object("0/app/w", obj_out=tmpl, memory_budget_bytes=budget, device="cpu") is tmpl
        assert tmpl.numpy().tobytes() == state["w"].tobytes()
        f64 = snap.read_object("0/app/w", obj_out=torch.zeros(state["w"].shape, dtype=torch.float64),
                               memory_budget_bytes=budget, device="cpu")
        assert torch.equal(f64, torch.from_numpy(state["w"]).double())
    got = snap.read_object("0/app/h", memory_budget_bytes=10000, device="cpu")
    assert got.numpy().tobytes() == state["h"].tobytes()
    mat = snap.materialize(device="cpu")["app"]
    _assert_bitwise({k: v.numpy() for k, v in mat.items()}, state)
    for deep in (False, True):
        res = tts.verify_snapshot(path, deep=deep)
        assert res.ok and res.complete and res.objects_checked == jts.verify_snapshot(path, deep=deep).objects_checked


@pytest.mark.parametrize("codec", ["zlib", "huff"])
@pytest.mark.parametrize("mode", ["take", "async_take"])
def test_port_encoded_snapshot_restores_bitwise_in_jax(tmp_path, codec, mode):
    """Whole-staged (slabs) and part-streamed encoded writes: the JAX
    package restores them bitwise and verifies them deep; the codecs
    tables and stored files equal the JAX package's own take."""
    state = _state(8)
    for batching in (True, False):
        port, jax = str(tmp_path / f"port{batching}"), str(tmp_path / f"jax{batching}")
        c0 = dict(tobs.counters())
        with _knobs(codec, batching):
            _port_take(port, state, asynchronous=mode == "async_take")
            jts.Snapshot.take(jax, {"app": jts.StateDict(dict(state))})
        c1 = tobs.counters()
        assert c1["storage.codec.parts_encoded"] > c0.get("storage.codec.parts_encoded", 0)
        if not batching:
            assert c1["storage.stripe.streamed_writes"] > c0.get("storage.stripe.streamed_writes", 0)
        tm, jm = tts.Snapshot(port).metadata, jts.Snapshot(jax).metadata
        assert tm.codecs == jm.codecs and tm.objects == jm.objects and tm.codecs
        for loc in tm.objects:
            assert filecmp.cmp(os.path.join(port, loc), os.path.join(jax, loc), shallow=False), loc
        _assert_bitwise(_jax_restored(port, state), state)
        assert jts.verify_snapshot(port, deep=True).ok
        _assert_bitwise(_port_restored(port, state), state)


def test_incremental_port_take_over_a_jax_encoded_base_links_and_carries_tables(tmp_path):
    state = _state(9)
    base, inc = str(tmp_path / "base"), str(tmp_path / "inc")
    with _knobs("zlib"):
        jts.Snapshot.take(base, {"app": jts.StateDict(dict(state))})
    tobs.reset_metrics()
    changed = dict(state, i=state["i"] + 1)
    with _knobs("raw"):
        _port_take(inc, changed, base=base)
    bm, im = jts.Snapshot(base).metadata, tts.Snapshot(inc).metadata
    linked = {loc for loc in im.objects if os.stat(os.path.join(inc, loc)).st_ino == os.stat(os.path.join(base, loc)).st_ino}
    assert linked == set(im.objects) - {im.manifest["0/app/i"].location}
    # the raw bytes the links saved, as the JAX package counts them
    assert tobs.counters()[tobs.BYTES_DEDUPED] == sum(im.objects[loc][2] for loc in linked)
    assert {loc: im.codecs[loc] for loc in linked} == {loc: bm.codecs[loc] for loc in linked}
    assert im.manifest["0/app/i"].location not in im.codecs  # written raw
    _assert_bitwise(_port_restored(inc, changed), changed)
    _assert_bitwise(_jax_restored(inc, changed), changed)
    assert jts.verify_snapshot(inc, deep=True).ok and tts.verify_snapshot(inc, deep=True).ok


def test_encode_transient_retries_and_huff_without_the_library(tmp_path, caplog):
    state = _state(10)
    c0 = dict(tobs.counters())
    with _knobs("huff"), tknobs.override_retry_backoff_cap_s(0.01), \
            tknobs.override_failpoints("scheduler.codec.encode=eagain::1"):
        _port_take(str(tmp_path / "s"), state)
    c1 = tobs.counters()
    assert c1.get("resilience.codec.retries", 0) - c0.get("resilience.codec.retries", 0) == 1
    _assert_bitwise(_jax_restored(str(tmp_path / "s"), state), state)
    # with the native library off, huff writes raw (one warning) and a
    # huff frame cannot be read
    tcodec._warned_unavailable.discard("huff")
    with _knobs("huff"), tknobs.override_enable_native_ext(False), caplog.at_level(logging.WARNING):
        _port_take(str(tmp_path / "raw"), state)
        assert not tts.Snapshot(str(tmp_path / "raw")).metadata.codecs
        with pytest.raises(tcodec.CodecUnavailableError, match="huff"):
            _port_restored(str(tmp_path / "s"), state)
    assert any("not installed" in r.getMessage() for r in caplog.records)
