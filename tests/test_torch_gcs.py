"""The port's ``gs://`` plugin against the JAX package's, both driven
against one fake bucket: the JAX suite's ``FakeBucket``/``FakeBlob``
(``tests/test_gcs_chunked.py``), installed behind a stub
``google.cloud.storage`` module before either plugin is built.

Plugin contract, each case on both packages' plugins: the chunk split
and ``compose`` (hierarchical past 32 components), a retry re-sending
only the failed part, the sweep of part and compose blobs whatever the
outcome, the stripe engine's part handle, ranged and parallel reads
reassembled and pinned to one generation, 404 (``FileNotFoundError``,
idempotent deletes) and 416 (a zero-byte object), server-side copies and
the shared progress window (``_CollectiveProgressRetry``).  Part blobs
carry the same names in both packages, so either one's sweep removes
the other's leftovers.  Snapshot level: a take of either package
restores bitwise in the other with the same blobs in the bucket, and a
host cache over ``gs://`` filled by either package serves the other.
States come from a seeded numpy generator; comparisons are exact.
"""

import asyncio
import sys
import types

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu.storage.gcs as jgcs
import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.storage.gcs as tgcs
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.io_types import ReadIO as JReadIO, WriteIO as JWriteIO
from torchsnapshot_tpu.storage import stripe as jstripe
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.io_types import ReadIO as TReadIO, WriteIO as TWriteIO
from torchsnapshot_tpu_torch.io_types import run_in_fresh_loop as run
from torchsnapshot_tpu_torch.storage import stripe as tstripe
from test_gcs_chunked import FakeBlob, FakeBucket, PreconditionFailed, RangeUnsatisfiable

# package -> (module, knobs, ReadIO, WriteIO, stripe engine, package)
PKGS = {
    "port": (tgcs, tknobs, TReadIO, TWriteIO, tstripe, tts),
    "jax": (jgcs, jknobs, JReadIO, JWriteIO, jstripe, jts),
}


class _Client:
    def __init__(self, buckets):
        self._buckets = buckets

    def bucket(self, name):
        if name not in self._buckets:
            b = self._buckets[name] = FakeBucket()
            b.name = name
        return self._buckets[name]


@pytest.fixture
def buckets(monkeypatch):
    """Fake buckets by name, behind a stub ``google.cloud.storage``."""
    found = {}
    stub = types.ModuleType("google.cloud.storage")
    stub.Client = lambda *a, **kw: _Client(found)
    if "google.cloud" not in sys.modules:
        try:
            import google.cloud  # noqa: F401
        except ImportError:
            monkeypatch.setitem(sys.modules, "google", types.ModuleType("google"))
            monkeypatch.setitem(sys.modules, "google.cloud", types.ModuleType("google.cloud"))
    monkeypatch.setitem(sys.modules, "google.cloud.storage", stub)
    monkeypatch.setattr(sys.modules["google.cloud"], "storage", stub, raising=False)
    yield found
    tts.resilience.reset_breakers()
    jts.resilience.reset_breakers()


def _plugin(pkg, chunk_bytes, path="bkt/run"):
    p = PKGS[pkg][0].GCSStoragePlugin(path, chunk_bytes=chunk_bytes)
    p._retry.window_s = 100.0
    p._retry.backoff = lambda attempt: asyncio.sleep(0)
    return p


def _read(pkg, p, path, byte_range=None):
    io_ = PKGS[pkg][2](path=path, byte_range=byte_range)
    run(p.read(io_))
    return bytes(memoryview(io_.buf).cast("B"))


def _write(pkg, p, path, buf):
    run(p.write(PKGS[pkg][3](path=path, buf=buf)))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_chunked_writes_compose_retry_one_part_and_sweep(buckets, pkg):
    p = _plugin(pkg, 100)
    bkt = p._bucket
    _write(pkg, p, "small", b"x" * 50)
    assert bkt.data == {"run/small": b"x" * 50} and bkt.compose_calls == []
    payload = bytes(range(256)) * 2  # 6 parts
    _write(pkg, p, "big", payload)
    assert bkt.data["run/big"] == payload and len(bkt.compose_calls) == 1
    assert bkt.compose_calls[0] == [f"run/big.part-{i:05d}" for i in range(6)]
    assert set(bkt.data) == {"run/small", "run/big"}  # parts swept
    # 40 parts: two level-0 composes (32 + 8), then one final
    p10 = _plugin(pkg, 10)
    huge = bytes(i % 251 for i in range(400))
    bkt.compose_calls.clear()
    _write(pkg, p10, "huge", huge)
    assert bkt.data["run/huge"] == huge and sorted(map(len, bkt.compose_calls)) == [2, 8, 32]
    assert bkt.compose_calls[-1] == ["run/huge.compose-0-00000", "run/huge.compose-0-00001"]
    assert not any(".part-" in n or ".compose-" in n for n in bkt.data)
    # a transient on part 2: only that part is sent again
    writes, fails = [], {"n": 0}

    def hook(op, name):
        if op == "write":
            writes.append(name)
            if name.endswith("part-00002") and fails["n"] < 2:
                fails["n"] += 1
                raise ConnectionError("transient")

    bkt.fail_hook = hook
    _write(pkg, p, "flaky", b"q" * 450)
    assert bkt.data["run/flaky"] == b"q" * 450
    assert [writes.count(f"run/flaky.part-{i:05d}") for i in range(5)] == [1, 1, 3, 1, 1]
    # a part that never lands: the write raises, every uploaded part swept
    bkt.fail_hook = lambda op, name: (_ for _ in ()).throw(ConnectionError("down")) \
        if op == "write" and name.endswith("part-00002") else None
    p._retry.window_s = 0.0
    with pytest.raises(ConnectionError):
        _write(pkg, p, "doomed", b"q" * 450)
    assert not any(n.startswith("run/doomed") for n in bkt.data)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_reads_reassemble_pin_one_generation_and_map_404_and_416(buckets, pkg, monkeypatch):
    p = _plugin(pkg, 100)
    bkt = p._bucket
    payload = bytes(i % 256 for i in range(1000))
    bkt.data["run/big"], bkt.gens["run/big"] = payload, 1
    assert _read(pkg, p, "big") == payload
    assert _read(pkg, p, "big", [150, 650]) == payload[150:650]  # 5 ranges
    assert _read(pkg, p, "big", [7, 90]) == payload[7:90]  # one GET
    # the second ranged GET fails once: retried, reassembled
    seen = {"n": 0}

    def flaky(op, name):
        if op == "read":
            seen["n"] += 1
            if seen["n"] == 2:
                raise ConnectionError("transient")

    bkt.fail_hook = flaky
    assert _read(pkg, p, "big") == payload
    # a blob within one chunk is one request, no stat
    reads = []
    bkt.fail_hook = lambda op, name: reads.append(op)
    bkt.data["run/small"], bkt.gens["run/small"] = b"z" * 40, 1
    assert _read(pkg, p, "small") == b"z" * 40 and reads == ["read"]
    bkt.fail_hook = lambda op, name: None
    # a zero-byte blob: a whole read is empty, a ranged one raises the 416
    bkt.data["run/empty"], bkt.gens["run/empty"] = b"", 1
    assert _read(pkg, p, "empty") == b""
    with pytest.raises(RangeUnsatisfiable):
        _read(pkg, p, "empty", [0, 1])
    with pytest.raises(FileNotFoundError):
        _read(pkg, p, "nope")
    # an overwrite between the stat and the ranges fails, never splices
    orig_reload = FakeBlob.reload

    def reload_and_overwrite(self):
        orig_reload(self)
        self.bucket.data["run/big"] = bytes(1000)
        self.bucket.gens["run/big"] += 1

    monkeypatch.setattr(FakeBlob, "reload", reload_and_overwrite)
    with pytest.raises(PreconditionFailed):
        _read(pkg, p, "big")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_stat_delete_copy_and_the_striped_handle(buckets, pkg):
    _, knobs, _, _, stripe, _ = PKGS[pkg]
    p = _plugin(pkg, 10**9)
    _write(pkg, p, "obj", b"x" * 77)
    assert run(p.stat("obj")) == 77
    with pytest.raises(FileNotFoundError):
        run(p.stat("missing"))
    run(p.delete("obj"))
    run(p.delete("obj"))  # 404 on delete: success
    assert "run/obj" not in p._bucket.data
    # server-side copies, within the bucket and from another one
    p._bucket.data["base/obj"], p._bucket.gens["base/obj"] = b"payload", 1
    run(p.link_from("gs://bkt/base", "obj"))
    other = p._client.bucket("old")
    other.data["b2/obj2"], other.gens["b2/obj2"] = b"elsewhere", 1
    run(p.link_from("gs://old/b2", "obj2"))
    assert _read(pkg, p, "obj") == b"payload" and _read(pkg, p, "obj2") == b"elsewhere"
    with pytest.raises(FileNotFoundError):
        run(p.link_from("gs://bkt/base", "nope"))
    # the stripe engine: parts as blobs, composed, swept
    payload = np.random.default_rng(1).integers(0, 256, 5000, dtype=np.uint8).tobytes()
    with knobs.override_stripe_part_size_bytes(1024), knobs.override_stripe_min_object_size_bytes(1024):
        assert stripe.write_eligible(len(payload), p)
        run(stripe.striped_write(p, "striped", payload))
    assert p._bucket.data["run/striped"] == payload
    assert not any(".part-" in n for n in p._bucket.data)
    h = run(p.begin_striped_write("aborted", 3000))
    run(h.write_part(0, 0, payload[:1024]))
    run(h.write_part(1, 1024, payload[1024:2048]))
    assert "run/aborted.part-00001" in p._bucket.data
    run(h.abort())
    run(h.abort())
    assert not any(n.startswith("run/aborted") for n in p._bucket.data)
    h = run(p.begin_striped_write("zero", 0))
    run(h.complete())
    assert p._bucket.data["run/zero"] == b""


def test_part_names_match_so_either_sweep_takes_the_others_leftovers(buckets):
    names = {}
    for pkg in ("port", "jax"):
        p = _plugin(pkg, 100, path=f"{pkg}/run")
        written = []
        p._bucket.fail_hook = lambda op, name: written.append(name) if op == "write" else None
        _write(pkg, p, "0/app/big", bytes(450))
        names[pkg] = sorted(written)
        p._bucket.fail_hook = lambda op, name: None
    assert names["port"] == names["jax"] == [f"run/0/app/big.part-{i:05d}" for i in range(5)]
    # an abandoned upload of either package, then the other's write of the
    # same object: no part blob is left
    for first, second in (("port", "jax"), ("jax", "port")):
        a = _plugin(first, 100, path="bkt/left")
        h = run(a.begin_striped_write("obj", 300))
        for i in range(3):
            run(h.write_part(i, 100 * i, bytes([i]) * 100))
        assert sum(".part-" in n for n in a._bucket.data) == 3
        b = _plugin(second, 100, path="bkt/left")
        _write(second, b, "obj", bytes(range(250)) + bytes(50))
        assert [n for n in b._bucket.data if n.startswith("left/")] == ["left/obj"]


def test_collective_progress_retry_window():
    assert tgcs._CollectiveProgressRetry is tts.resilience.SharedProgress
    for cls in (tgcs._CollectiveProgressRetry, jgcs._CollectiveProgressRetry):
        r = cls(window_s=0.2, max_attempts=10, label="gcs")
        assert r.should_retry(1)
        r.last_progress -= 1.0  # no progress for longer than the window
        assert not r.should_retry(1)
        r.record_progress()  # any completed operation refreshes it
        assert r.should_retry(1) and not r.should_retry(10)


# ----------------------------------------------------- snapshot level


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((50, 41)).astype(np.float32),
        "ids": rng.integers(-9, 9, 3001).astype(np.int64),
        "e": np.zeros((0, 5), np.float32),
    }


def _state(pkg, seed, zero=False):
    arrays = {k: np.zeros_like(v) if zero else v for k, v in _arrays(seed).items()}
    if pkg == "port":
        return {"app": tts.StateDict(step=-1 if zero else seed, **{k: torch.from_numpy(v) for k, v in arrays.items()})}
    return {"app": jts.StateDict(step=-1 if zero else seed, **arrays)}


def _check(dest, seed):
    assert dest["app"]["step"] == seed
    for k, v in _arrays(seed).items():
        got = dest["app"][k]
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert got.dtype == v.dtype and np.array_equal(got, v), k


@pytest.mark.parametrize("taker", ["port", "jax"])
def test_take_restores_in_the_other_package_with_the_same_blobs(buckets, taker):
    other = "jax" if taker == "port" else "port"
    opts = {"chunk_bytes": 4096}  # the 8200-byte leaf goes up composed
    names = {}
    for pkg, url in ((taker, "gs://bkt/a/s1"), (other, "gs://bkt/b/s1")):
        PKGS[pkg][5].Snapshot.take(url, _state(pkg, 4), storage_options=opts)
        prefix = url[len("gs://bkt/"):] + "/"
        names[pkg] = sorted(n[len(prefix):] for n in buckets["bkt"].data if n.startswith(prefix))
    assert names[taker] == names[other] and ".snapshot_metadata" in names[taker]
    assert not any(".part-" in n or ".compose-" in n for n in buckets["bkt"].data)
    assert buckets["bkt"].compose_calls
    for pkg, url in ((other, "gs://bkt/a/s1"), (taker, "gs://bkt/b/s1")):
        dest = _state(pkg, 4, zero=True)
        PKGS[pkg][5].Snapshot(url, storage_options=opts).restore(dest)
        _check(dest, 4)
    # a budgeted read by the port: no GET above the budget
    gets = []
    real = FakeBlob.download_as_bytes

    def spy(self, start=None, end=None, if_generation_match=None):
        if not self.name.endswith(".snapshot_metadata"):
            gets.append(None if start is None else end + 1 - start)
        return real(self, start, end, if_generation_match)

    FakeBlob.download_as_bytes = spy
    try:
        into = torch.zeros(50, 41, dtype=torch.float64)
        tts.Snapshot("gs://bkt/a/s1", storage_options=opts).read_object(
            "0/app/w", obj_out=into, memory_budget_bytes=2048)
    finally:
        FakeBlob.download_as_bytes = real
    assert np.array_equal(into.numpy(), _arrays(4)["w"].astype(np.float64))
    assert len(gets) > 1 and None not in gets and max(gets) <= 2048, gets


@pytest.mark.parametrize("filler", ["port", "jax"])
def test_a_host_cache_over_gs_filled_by_either_package_serves_the_other(buckets, tmp_path, filler):
    reader = "jax" if filler == "port" else "port"
    tts.Snapshot.take("gs://bkt/c/s1", _state("port", 6))
    cache = str(tmp_path / "cache")
    reads = []
    # payload GETs (the metadata is a marker, never cached)
    buckets["bkt"].fail_hook = lambda op, name: reads.append(name) if op == "read" and "/0/" in name else None
    for pkg in (filler, reader):
        with PKGS[pkg][1].override_cache_dir(cache):
            dest = _state(pkg, 6, zero=True)
            PKGS[pkg][5].Snapshot("gs://bkt/c/s1").restore(dest)
            _check(dest, 6)
            if pkg == filler:
                n_fill = len(reads)
    assert n_fill > 0 and len(reads) == n_fill  # the second restore made no GET


def test_the_card_paths_fake_stores_what_the_jax_suites_fake_stores(buckets, monkeypatch):
    """``cloud_fakes.GCSFake`` (what ``chip_smoke.py`` and the CUDA tests
    run over) against ``FakeBucket``: the same blobs, composes and errors
    for the same port take and restore."""
    import cloud_fakes

    lean = cloud_fakes.GCSFake()
    stores = {}
    for name, client in (("suite", _Client(buckets)), ("lean", lean)):
        monkeypatch.setattr(sys.modules["google.cloud.storage"], "Client", lambda *a, **kw: client)
        tts.Snapshot.take("gs://bkt/y/s0", _state("port", 2), storage_options={"chunk_bytes": 4096})
        dest = _state("port", 2, zero=True)
        tts.Snapshot("gs://bkt/y/s0", storage_options={"chunk_bytes": 4096}).restore(dest)
        _check(dest, 2)
        p = tgcs.GCSStoragePlugin("bkt/y", chunk_bytes=100)
        _write("port", p, "empty", b"")
        assert _read("port", p, "empty") == b""
        with pytest.raises(FileNotFoundError):
            _read("port", p, "nope")
        data = client.bucket("bkt").data
        stores[name] = {k: bytes(v[0] if name == "lean" else v) for k, v in data.items() if not k.endswith("obsrecord")}
    assert stores["suite"] == stores["lean"] and not any(".part-" in k for k in stores["lean"])
    assert lean.ops["compose"] == len(buckets["bkt"].compose_calls) > 0
