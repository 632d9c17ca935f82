"""The port's native fast-I/O engine (``_csrc/fastio.cpp`` behind
``storage/fastio.py`` and the fs plugin) against zlib, the JAX package's
native library and the port's pure-Python legs.

The contract: for any size, offset, alignment and knob setting the
engine's bytes and (crc32, adler32) digests equal the pure-Python
path's; snapshots taken with ``FASTIO=0``, ``FASTIO=1`` and
``FASTIO=1`` + ``FASTIO_DIRECT=1`` are byte-identical and restore in
either package.  Every thread here is joined with a timeout and every
wait has a deadline.  Inputs come from seeded numpy generators.
"""

import os
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import _csrc as jcsrc
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu_torch import _csrc, batcher, knobs, obs, scheduler
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, TransformerLM
from torchsnapshot_tpu_torch.storage import fastio
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.utils import checksums

_SIZES = [0, 1, 4095, 4096, 4097, (1 << 20) + 3]
_EDGE_SIZES = [0, 1, 511, 4096, 4097, 65536 + 17, (1 << 20) + 4095, (3 << 20) + 17]


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _zlib(b):
    return zlib.crc32(b) & 0xFFFFFFFF, zlib.adler32(b) & 0xFFFFFFFF


def _delta(before, name):
    return obs.counters().get(name, 0) - before.get(name, 0)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


# ------------------------------------------------------------- digests


def test_native_digests_equal_zlib_and_the_jax_library():
    lib, jlib = _csrc.load(), jcsrc.load()
    assert jlib is not None
    for n in _SIZES:
        b = _rand(n, n)
        want = _zlib(b)
        # the library itself, at every size, on writable and read-only views
        for data in (b, bytes(b)):
            assert _csrc.digest(lib, data) == want, n
            assert (_csrc.crc32z(lib, data), _csrc.adler32(lib, data)) == want, n
        assert _csrc.crc32z(lib, b, 12345) == zlib.crc32(b, 12345), n
        assert _csrc.adler32(lib, b, 777) == zlib.adler32(b, 777), n
        # the checksums module every caller goes through
        assert checksums.digest(b) == want, n
        assert (checksums.crc32_fast(b), checksums.adler32_fast(b)) == want, n
        # the JAX package's library on the same bytes
        assert jcsrc.digest(b) == want and jcsrc.crc32z(b) == want[0], n
        for copy in (lambda d, s: _csrc.copy_digest(lib, d, s), checksums.copy_digest):
            dst = np.zeros(n, np.uint8)
            assert copy(dst, b) == want and bytes(dst) == bytes(b), n
        jdst = np.zeros(n, np.uint8)
        assert jcsrc.copy_digest(jdst, b) == want, n
    with pytest.raises(ValueError):
        _csrc.copy_digest(lib, bytes(8), _rand(8, 0))  # read-only destination


def test_library_is_built_from_the_port_source_under_build_dir():
    _csrc.load()
    path = _csrc.LOADED["path"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(path) == os.path.join(repo, "build", "torch_kernels")
    assert _csrc.SOURCE == os.path.join(repo, "torchsnapshot_tpu_torch", "_csrc", "fastio.cpp")
    # the file name is the source + flags hash and CPU fingerprint of a variant
    assert path in [_csrc.lib_path(*v) for v in _csrc.variants()]
    assert _csrc.cpu_fingerprint() in os.path.basename(path)


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    monkeypatch.setattr(_csrc, "_lib", None)
    monkeypatch.setattr(_csrc, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_csrc, "COMPILER", "tsnp-no-such-compiler")
    with pytest.raises(RuntimeError, match="tsnp-no-such-compiler") as info:
        _csrc.load()
    assert "did not build in any variant" in str(info.value)
    # no quiet fallback: with the knobs at their defaults the plugin and
    # the digests raise too
    with pytest.raises(RuntimeError, match="tsnp-no-such-compiler"):
        FSStoragePlugin(str(tmp_path / "snap"))
    with pytest.raises(RuntimeError, match="tsnp-no-such-compiler"):
        checksums.digest(_rand(8192, 1))
    # the knobs are the only way to the pure-Python legs
    with knobs.override_enable_native_ext(False):
        assert checksums.digest(_rand(8192, 1)) == _zlib(_rand(8192, 1))
        assert FSStoragePlugin(str(tmp_path / "snap"))._fastio is None
    with knobs.override_fastio(False):
        assert FSStoragePlugin(str(tmp_path / "snap"))._fastio is None


def test_builds_starting_together_compile_once(tmp_path, monkeypatch):
    """Three builds start on an empty build directory at once, each with
    its own open file description of the lock, as separate processes
    have (``flock`` tells them apart the same way): one runs the compiler,
    the others find its library; no temporary file is left behind."""
    build = tmp_path / "build"
    calls = tmp_path / "compiler-calls"
    wrapper = tmp_path / "gxx"
    wrapper.write_text(f'#!/bin/sh\necho run >> {calls}\nexec g++ "$@"\n')
    wrapper.chmod(0o755)
    monkeypatch.setattr(_csrc, "BUILD_DIR", str(build))
    monkeypatch.setattr(_csrc, "COMPILER", str(wrapper))
    results, errors = [], []

    def build_once():
        try:
            results.append(_csrc._find_or_build()[0])
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=build_once, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(results) == 3 and len(set(results)) == 1
    assert os.path.dirname(results[0]) == str(build)
    assert sorted(os.listdir(build)) == sorted([os.path.basename(results[0]), "fastio.lock"])
    assert calls.read_text().split() == ["run"]


def test_knob_defaults_equal_the_jax_package(monkeypatch):
    for name in ("ENABLE_NATIVE_EXT", "FS_VERIFY_WRITES", "FS_SYNC_DATA", "FASTIO",
                 "FASTIO_DIRECT", "FASTIO_BUFFER_POOL_BYTES"):
        monkeypatch.delenv("TORCHSNAPSHOT_TPU_TORCH_" + name, raising=False)
        monkeypatch.delenv("TORCHSNAPSHOT_TPU_" + name, raising=False)
    pairs = [
        ("is_native_ext_enabled", True), ("is_fs_verify_writes", False),
        ("is_fs_sync_data", False), ("fastio_enabled", True),
        ("fastio_direct_enabled", False), ("get_fastio_buffer_pool_bytes", 64 << 20),
    ]
    for fn, want in pairs:
        assert getattr(knobs, fn)() == getattr(jknobs, fn)() == want, fn
    with knobs.override_fastio_buffer_pool_bytes(1), knobs.override_fs_sync_data(True), \
            knobs.override_fs_verify_writes(True), knobs.override_fastio_direct(True):
        assert knobs.get_fastio_buffer_pool_bytes() == 4 << 20
        assert knobs.is_fs_sync_data() and knobs.is_fs_verify_writes()
        assert knobs.fastio_direct_enabled()


# -------------------------------------------------------------- engine


def _engine(root, direct):
    with knobs.override_fastio_direct(direct):
        return fastio.create_engine(_csrc.load(), str(root))


@pytest.mark.parametrize("direct", [False, True], ids=["buffered", "direct"])
def test_engine_round_trips_at_alignment_edges(tmp_path, monkeypatch, direct):
    """Writes and reads at every edge size, whole and at unaligned offsets,
    into a misaligned ``into``; digests fused into the write equal zlib's.
    The direct leg (``DIRECT_MIN_BYTES`` lowered to 1) bounces unaligned
    heads, tails and memory through the pool."""
    monkeypatch.setattr(fastio, "DIRECT_MIN_BYTES", 1)
    eng = _engine(tmp_path, direct)
    assert eng.direct == direct and not eng.dontneed
    before = obs.counters()
    for i, n in enumerate(_EDGE_SIZES):
        b = _rand(n, i)
        path = str(tmp_path / f"f{i}")
        assert eng.write_file(path, b, sync_file=(i % 2 == 0), want_digest=True) == _zlib(b)
        assert open(path, "rb").read() == bytes(b)
        assert eng.write_file(path, memoryview(bytes(b)), False, want_digest=False) is None
        backing = np.zeros(n + 3, np.uint8)
        into = backing[3:]  # starts 3 bytes past an allocation: misaligned
        assert eng.read_into(path, 0, n, into) == n and bytes(into) == bytes(b)
        if n > 4099:
            lo, hi = 4093, n - 5
            part = np.zeros(hi - lo + 1, np.uint8)[1:]
            assert eng.read_into(path, lo, hi - lo, part) == hi - lo
            assert bytes(part) == bytes(b[lo:hi])
    # a part at an unaligned offset, through fds the caller holds
    b = _rand((2 << 20) + 9, 99)
    path = str(tmp_path / "parts")
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    fd_direct = eng.open_direct(path)
    try:
        assert (fd_direct >= 0) == direct
        assert eng.pwrite_part(fd, fd_direct, 4097, b, True) == _zlib(b)
    finally:
        if fd_direct >= 0:
            os.close(fd_direct)
        os.close(fd)
    assert open(path, "rb").read()[4097:] == bytes(b)
    assert (_delta(before, obs.FASTIO_DIRECT_PARTS) > 0) == direct
    assert _delta(before, obs.FASTIO_FUSED_DIGESTS) == len(_EDGE_SIZES) + 1
    assert _delta(before, obs.FASTIO_BYTES_WRITTEN) == 2 * sum(_EDGE_SIZES) + b.nbytes
    assert eng.pool_free_count() == (16 if direct else 0)


def test_plugin_legs_agree_and_honour_into(tmp_path, monkeypatch):
    """The fs plugin on the engine (buffered and direct) and on the
    pure-Python legs writes the same files and reads them back, into a
    caller's buffer when it fits; FS_VERIFY_WRITES and FS_SYNC_DATA pass
    on sound writes."""
    monkeypatch.setattr(fastio, "DIRECT_MIN_BYTES", 1)
    b = _rand((1 << 20) + 4097, 5)
    for label, ctx in (
        ("py", knobs.override_fastio(False)),
        ("engine", knobs.override_fastio_direct(False)),
        ("direct", knobs.override_fastio_direct(True)),
    ):
        with ctx, knobs.override_fs_verify_writes(True), knobs.override_fs_sync_data(True):
            fs = FSStoragePlugin(str(tmp_path / label))
            assert fs.supports_fused_digest == (label != "py")
            wio = WriteIO(path="a/b", buf=b, want_digest=True)
            fs.sync_write(wio)
            assert wio.digests == (None if label == "py" else _zlib(b))
            into = np.zeros(b.nbytes + 1, np.uint8)[1:]
            rio = ReadIO(path="a/b", into=into)
            fs.sync_read(rio)
            assert rio.buf is into and bytes(into) == bytes(b)
            rio = ReadIO(path="a/b", byte_range=[10, 5000])
            fs.sync_read(rio)
            assert bytes(rio.buf) == bytes(b[10:5000])
            with pytest.raises(OSError, match="short read"):
                fs.sync_read(ReadIO(path="a/b", byte_range=[0, b.nbytes + 1]))
            fs.sync_close()
        assert open(tmp_path / label / "a" / "b", "rb").read() == bytes(b)
        assert not [f for f in os.listdir(tmp_path / label / "a") if "tsnp-tmp" in f]


def test_ladder_refused_o_direct_degrades_to_dontneed(tmp_path, monkeypatch):
    monkeypatch.setattr(fastio, "probe_direct", lambda root: False)
    eng = _engine(tmp_path, True)
    assert not eng.direct and eng.dontneed and eng.pool_free_count() == 0
    assert eng.open_direct(str(tmp_path / "x")) == -1
    before = obs.counters()
    b = _rand(3 << 20, 3)
    eng.write_file(str(tmp_path / "f"), b, False, False)
    out = np.empty_like(b)
    assert eng.read_into(str(tmp_path / "f"), 0, b.nbytes, out) == b.nbytes
    assert bytes(out) == bytes(b)
    assert _delta(before, obs.FASTIO_DONTNEED_READS) == 1
    assert _delta(before, obs.FASTIO_DIRECT_PARTS) == 0
    assert _delta(before, obs.FASTIO_BUFFERED_PARTS) == 2
    # the read-only rung: a root that refuses the create probe but holds a file
    monkeypatch.undo()
    assert fastio._probe_direct_readonly(str(tmp_path), os.O_DIRECT)
    assert not fastio._probe_direct_readonly(str(tmp_path / "empty-missing"), os.O_DIRECT)


# ---------------------------------------------------------------- pool


def test_pool_backpressure_is_deterministic_and_recovers(tmp_path, monkeypatch):
    """The test holds the only bounce buffer; a writer must wait for it
    (pool_waits rises), then finishes once it is released."""
    monkeypatch.setattr(fastio, "DIRECT_MIN_BYTES", 1)
    with knobs.override_fastio_buffer_pool_bytes(4 << 20):
        eng = _engine(tmp_path, True)
    assert eng.direct and eng.pool_free_count() == 1
    b = _rand(2 << 20, 7)
    held = eng._pool.acquire(timeout_s=1.0)
    waits0 = obs.counters().get(obs.FASTIO_POOL_WAITS, 0)
    result = {}

    def writer():
        try:
            result["digest"] = eng.write_file(str(tmp_path / "w"), b, False, True)
        except BaseException as e:  # noqa: BLE001 — asserted below
            result["error"] = e

    t = threading.Thread(target=writer, name="pool-writer", daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 10.0
        while obs.counters().get(obs.FASTIO_POOL_WAITS, 0) == waits0:
            assert time.monotonic() < deadline, "the writer never waited for the pool"
            time.sleep(0.005)
        assert "digest" not in result and t.is_alive()
    finally:
        eng._pool.release(held)
        t.join(timeout=30)
    assert not t.is_alive(), "the writer did not finish after the release"
    assert "error" not in result, result.get("error")
    assert result["digest"] == _zlib(b)
    assert open(tmp_path / "w", "rb").read() == bytes(b)
    assert eng.pool_free_count() == 1


def test_pool_returns_buffers_on_native_failure_and_times_out(tmp_path, monkeypatch):
    monkeypatch.setattr(fastio, "DIRECT_MIN_BYTES", 1)
    with knobs.override_fastio_buffer_pool_bytes(4 << 20):
        eng = _engine(tmp_path, True)
    path = str(tmp_path / "ro")
    open(path, "wb").close()
    fd = os.open(path, os.O_RDONLY)
    fd_direct = os.open(path, os.O_RDONLY | os.O_DIRECT)
    try:
        with pytest.raises(OSError):  # EBADF: both fds are read-only
            eng.pwrite_part(fd, fd_direct, 0, _rand(1 << 20, 8), True)
    finally:
        os.close(fd_direct)
        os.close(fd)
    assert eng.pool_free_count() == 1
    held = eng._pool.acquire(timeout_s=1.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="fastio bounce pool"):
        eng._pool.acquire(timeout_s=0.2)
    assert time.monotonic() - t0 < 5.0
    eng._pool.release(held)
    assert eng.pool_free_count() == 1


# ------------------------------------------------------- whole snapshots


# slabs take the tiny model's tensors (members up to 32 KiB, so the pack's
# native copy_digest runs); the 160 KB "big" leaf is written whole
_SLAB = 65536


def _state(seed):
    torch.manual_seed(seed)
    model = TransformerLM(TransformerConfig.tiny(), device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    tokens = torch.randint(0, 256, (2, 17))
    logits = model(tokens[:, :-1])
    torch.nn.functional.cross_entropy(logits.reshape(-1, 256), tokens[:, 1:].reshape(-1)).backward()
    opt.step()
    return model, opt


def _app(model, opt, seed):
    big = torch.from_numpy(np.random.default_rng(seed).standard_normal(40000).astype(np.float32))
    return {"model": model, "optim": opt, "meta": tts.StateDict(step=3, name="run", big=big)}


def _payload(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            # the flight record holds this take's timings, not payload
            if f not in (".snapshot_metadata", ".snapshot_obsrecord"):
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _digests(root):
    md = tts.Snapshot(str(root)).metadata
    crcs = {k: getattr(e, "crc32", None) for k, e in md.manifest.items()}
    return crcs, md.objects


def test_snapshots_three_ways_are_byte_identical_and_restore_in_both(tmp_path, monkeypatch):
    """A tiny transformer + AdamW state taken with FASTIO=0, FASTIO=1 and
    FASTIO=1 + FASTIO_DIRECT=1 (and by async_take with the engine): the
    same payload files and manifest digests; the JAX package reads every
    entry of each bitwise; the port restores a snapshot the JAX engine
    wrote."""
    monkeypatch.setattr(fastio, "DIRECT_MIN_BYTES", 1)
    model, opt = _state(0)
    app = _app(model, opt, 0)
    settings = {
        "py": (knobs.override_fastio(False),),
        "engine": (),
        "direct": (knobs.override_fastio_direct(True),),
    }
    before = obs.counters()
    with knobs.override_slab_size_threshold_bytes(_SLAB):
        for name, ctxs in settings.items():
            for c in ctxs:
                c.__enter__()
            try:
                tts.Snapshot.take(str(tmp_path / name), app)
            finally:
                for c in ctxs:
                    c.__exit__(None, None, None)
        tts.Snapshot.async_take(str(tmp_path / "async"), app).wait()
    assert _delta(before, obs.FASTIO_DIRECT_PARTS) > 0
    ref = _payload(tmp_path / "py")
    assert any("batched" in k for k in ref) and len(ref) > 5
    for name in ("engine", "direct", "async"):
        assert _payload(tmp_path / name) == ref, name
        assert _digests(tmp_path / name) == _digests(tmp_path / "py"), name
    manifest = tts.Snapshot(str(tmp_path / "py")).metadata.manifest
    arrays = [k for k, e in manifest.items() if type(e).__name__ in ("ArrayEntry", "ChunkedArrayEntry")]
    assert len(arrays) >= 2 * len(model.state_dict())
    for name in settings:
        jsnap = jts.Snapshot(str(tmp_path / name))
        for k in arrays:
            want = tts.Snapshot(str(tmp_path / "py")).read_object(k, device="cpu")
            assert _bytes(jsnap.read_object(k)) == _bytes(want), (name, k)
    # the other way: the JAX engine writes, the port restores
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    with jknobs.override_fastio_direct(True), jknobs.override_slab_size_threshold_bytes(_SLAB):
        jts.Snapshot.take(str(tmp_path / "jax"), {"m": jts.StateDict(**sd)})
    templates = tts.StateDict({k: torch.zeros(v.shape) for k, v in sd.items()})
    with knobs.override_fastio_direct(True):
        tts.Snapshot(str(tmp_path / "jax")).restore({"m": templates})
    for k, v in sd.items():
        assert _bytes(templates[k]) == _bytes(v), k
    fresh, fresh_opt = _state(1)
    tts.Snapshot(str(tmp_path / "direct")).restore({"model": fresh, "optim": fresh_opt})
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k


def test_whole_buffer_digests_come_from_the_write_and_slabs_from_the_pack(tmp_path, monkeypatch):
    """With the engine, whole-buffer writes take their digest from the
    write (fused_digests rises and the scheduler digests no such buffer
    at staging); a host slab's member crcs come from the pack's
    copy_digest; a plugin that leaves ``digests`` None gets the same
    values computed after the write."""
    model, opt = _state(2)
    app = _app(model, opt, 2)
    staged_digests = []
    real_apply = scheduler.apply_checksum_sinks

    def spy_apply(buf, wr, precomputed=None):
        staged_digests.append((wr.path, precomputed is not None))
        return real_apply(buf, wr, precomputed)

    packed = []
    real_copy = batcher.copy_digest

    def spy_copy(dst, src):
        packed.append(memoryview(src).nbytes)
        return real_copy(dst, src)

    monkeypatch.setattr(scheduler, "apply_checksum_sinks", spy_apply)
    monkeypatch.setattr(batcher, "copy_digest", spy_copy)
    before = obs.counters()
    with knobs.override_slab_size_threshold_bytes(_SLAB):
        tts.Snapshot.take(str(tmp_path / "fused"), app)
    fused = _delta(before, obs.FASTIO_FUSED_DIGESTS)
    assert fused > 0
    # every staging-time digest was a slab's, folded from its pack
    assert staged_digests and all(pre for _, pre in staged_digests)
    assert all("batched" in p for p, _ in staged_digests)
    assert len(packed) > 2 and max(packed) > checksums.NATIVE_MIN_BYTES

    class NoFuse(FSStoragePlugin):
        async def write(self, write_io):
            await super().write(write_io)
            write_io.digests = None

    import torchsnapshot_tpu_torch.snapshot as snap_mod

    monkeypatch.setattr(snap_mod, "url_to_storage_plugin", lambda p: NoFuse(p))
    staged_digests.clear()
    with knobs.override_slab_size_threshold_bytes(_SLAB):
        tts.Snapshot.take(str(tmp_path / "unfused"), app)
    assert any(not pre for _, pre in staged_digests)  # computed after the write
    assert _digests(tmp_path / "unfused") == _digests(tmp_path / "fused")
    assert _payload(tmp_path / "unfused") == _payload(tmp_path / "fused")
    monkeypatch.undo()
    packed.clear()
    monkeypatch.setattr(batcher, "copy_digest", spy_copy)
    with knobs.override_write_checksums(False), knobs.override_slab_size_threshold_bytes(_SLAB):
        tts.Snapshot.take(str(tmp_path / "nock"), app)
    assert packed == []  # a plain copy
    assert _payload(tmp_path / "nock") == _payload(tmp_path / "fused")
