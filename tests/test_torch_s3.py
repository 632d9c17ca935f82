"""The port's ``s3://`` plugin against the JAX package's, both driven
against one fake client: the JAX suite's ``FakeBoto3Client``
(``tests/test_s3_storage.py``), which validates every call and response
against the vendored service model (``tests/s3_service_model.py``).  The
fake is installed as the ``boto3`` module before either plugin is built,
so both bind it in their own ``__init__``.

Plugin contract, each case run on both packages' plugins: put/get and
``Range`` reads, ``NoSuchKey`` as ``FileNotFoundError``, idempotent
deletes, zero-byte objects, true multipart writes (parts of at least
5 MiB but the last) whose abort or failure leaves no upload in progress,
``SlowDown`` retried, ``AccessDenied`` surfacing as itself, the ``s3``
breaker and the ``storage.s3.*`` failpoints, server-side copies, the
endpoint knob.  Snapshot level: a take of either package restores
bitwise in the other with the same keys in the bucket, budgeted reads
never GET more than the budget, incremental takes copy server-side, and
a tier over a durable ``s3://`` root works across both packages.  States
come from a seeded numpy generator; comparisons are exact.
"""

import contextlib
import re
import sys
import types

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu.storage.s3 as js3
import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.storage.s3 as ts3
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.io_types import ReadIO as JReadIO, WriteIO as JWriteIO
from torchsnapshot_tpu.storage import stripe as jstripe
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.io_types import ReadIO as TReadIO, WriteIO as TWriteIO
from torchsnapshot_tpu_torch.io_types import run_in_fresh_loop as run
from torchsnapshot_tpu_torch.storage import stripe as tstripe
from test_s3_storage import FakeBoto3Client, FakeClientError

# package -> (plugin class, knobs, ReadIO, WriteIO, stripe engine, package)
PKGS = {
    "port": (ts3.S3StoragePlugin, tknobs, TReadIO, TWriteIO, tstripe, tts),
    "jax": (js3.S3StoragePlugin, jknobs, JReadIO, JWriteIO, jstripe, jts),
}
PART = 5 << 20  # S3's floor for every part but the last


@pytest.fixture
def fake(monkeypatch):
    """The shared fake client, installed as ``boto3``; ``fake.client_kw``
    records what each plugin passed to ``boto3.client``."""
    client = FakeBoto3Client()
    client.client_kw = []

    def make_client(service, **kw):
        assert service == "s3"
        client.client_kw.append(kw)
        return client

    monkeypatch.setitem(sys.modules, "boto3", types.SimpleNamespace(client=make_client))
    yield client
    tts.resilience.reset_breakers()
    jts.resilience.reset_breakers()


def _plugin(pkg, path="bkt/run/1"):
    return PKGS[pkg][0](path)


def _read(pkg, p, path, byte_range=None):
    io_ = PKGS[pkg][2](path=path, byte_range=byte_range)
    run(p.read(io_))
    return bytes(memoryview(io_.buf).cast("B"))


def _write(pkg, p, path, buf):
    run(p.write(PKGS[pkg][3](path=path, buf=buf)))


def _stripes(knobs, part=PART):
    ctx = contextlib.ExitStack()
    ctx.enter_context(knobs.override_stripe_part_size_bytes(part))
    ctx.enter_context(knobs.override_stripe_min_object_size_bytes(part))
    return ctx


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_put_get_ranges_missing_and_idempotent_delete(fake, pkg):
    p = _plugin(pkg)
    src = bytearray(b"hello s3" * 50)
    _write(pkg, p, "0/app/w", src)
    assert fake.objects == {("bkt", "run/1/0/app/w"): bytes(src)}
    # the body is a read-only view of the staged buffer, not a copy
    body = [kw for op, kw in fake.validated if op == "PutObject"][-1]["Body"]
    assert isinstance(body, memoryview) and body.readonly
    assert _read(pkg, p, "0/app/w") == bytes(src)
    for lo, hi in ((10, 30), (0, 1), (0, 400), (399, 400), (10, 999)):
        assert _read(pkg, p, "0/app/w", [lo, hi]) == bytes(src)[lo:min(hi, 400)]
    assert [c[3] for c in fake.calls if c[0] == "get"][1] == "bytes=10-29"  # inclusive end
    _write(pkg, p, "mv", memoryview(b"abcdef")[2:5])
    assert _read(pkg, p, "mv") == b"cde"
    assert run(p.stat("0/app/w")) == 400 and ("head", "bkt", "run/1/0/app/w") in fake.calls
    # a zero-byte object reads back empty; any range on it is S3's 416
    _write(pkg, p, "empty", b"")
    assert _read(pkg, p, "empty") == b"" and run(p.stat("empty")) == 0
    with pytest.raises(FakeClientError, match="InvalidRange"):
        _read(pkg, p, "empty", [0, 1])
    with pytest.raises(FileNotFoundError, match="s3://bkt/run/1/nope"):
        _read(pkg, p, "nope")
    with pytest.raises(FileNotFoundError):
        run(p.stat("nope"))
    run(p.delete("0/app/w"))
    run(p.delete("0/app/w"))  # idempotent
    assert ("bkt", "run/1/0/app/w") not in fake.objects
    run(p.close())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_multipart_writes_complete_or_leave_no_upload(fake, pkg):
    _, knobs, _, _, stripe, pkg_mod = PKGS[pkg]
    p = _plugin(pkg)
    payload = np.random.default_rng(3).integers(0, 256, 2 * PART + 4099, dtype=np.uint8).tobytes()
    with _stripes(knobs):
        assert stripe.write_eligible(len(payload), p) and p.supports_striped_write
        run(stripe.striped_write(p, "0/app/big", payload))
    assert fake.objects[("bkt", "run/1/0/app/big")] == payload and fake.multipart_uploads == {}
    parts = [kw for op, kw in fake.validated if op == "UploadPart"]
    assert sorted(kw["PartNumber"] for kw in parts) == [1, 2, 3]
    assert all(kw["Body"].nbytes >= PART for kw in parts if kw["PartNumber"] < 3)
    assert _read(pkg, p, "0/app/big", [PART - 7, PART + 9]) == payload[PART - 7 : PART + 9]
    # two transient part faults: retried, each part lands once
    r0 = pkg_mod.obs.counter(pkg_mod.obs.RESILIENCE_RETRIES).value
    with _stripes(knobs), knobs.override_retry_backoff_cap_s(0.01), \
            knobs.override_failpoints("storage.s3.part.write=slowdown:1:2"):
        run(stripe.striped_write(p, "0/app/flaky", payload))
    assert pkg_mod.obs.counter(pkg_mod.obs.RESILIENCE_RETRIES).value - r0 >= 2
    assert fake.objects[("bkt", "run/1/0/app/flaky")] == payload and fake.multipart_uploads == {}
    # a permanent part fault and a failed complete: aborted, nothing left
    for site in ("part.write", "part.complete"):
        with _stripes(knobs), knobs.override_retry_max_attempts(2), knobs.override_retry_backoff_cap_s(0.01), \
                knobs.override_failpoints(f"storage.s3.{site}=http500"):
            with pytest.raises(Exception) as ei:
                run(stripe.striped_write(p, f"0/app/doomed-{site}", payload))
        assert ei.value.response["Error"]["Code"] == "InternalError"  # surfaced as itself
        assert fake.multipart_uploads == {} and ("bkt", f"run/1/0/app/doomed-{site}") not in fake.objects
        pkg_mod.resilience.reset_breakers()
    assert [c[0] for c in fake.calls].count("abort_multipart") == 2
    # an explicit abort after parts landed
    h = run(p.begin_striped_write("0/app/aborted", len(payload)))
    run(h.write_part(0, 0, payload[:PART]))
    run(h.abort())
    run(h.abort())  # idempotent
    assert fake.multipart_uploads == {} and ("bkt", "run/1/0/app/aborted") not in fake.objects


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_throttles_retry_fatal_errors_surface_and_the_breaker_opens(fake, pkg, monkeypatch):
    knobs, pkg_mod = PKGS[pkg][1], PKGS[pkg][5]
    p = _plugin(pkg)
    with knobs.override_retry_backoff_cap_s(0.01), knobs.override_failpoints("storage.s3.write=slowdown:1:1"):
        _write(pkg, p, "a", b"x" * 10)
    assert fake.objects[("bkt", "run/1/a")] == b"x" * 10
    with knobs.override_retry_backoff_cap_s(0.01), knobs.override_failpoints("storage.s3.read=slowdown:1:2"):
        assert _read(pkg, p, "a") == b"x" * 10
    # AccessDenied is fatal: one attempt, raised as the client raised it
    real_put = fake.put_object
    denied = []

    def put_denied(**kw):
        denied.append(kw["Key"])
        raise FakeClientError("put_object", "AccessDenied", kw["Key"])

    monkeypatch.setattr(fake, "put_object", put_denied)
    with pytest.raises(FakeClientError, match="AccessDenied"):
        _write(pkg, p, "b", b"y")
    assert denied == ["run/1/b"]
    monkeypatch.setattr(fake, "put_object", real_put)
    pkg_mod.resilience.reset_breakers()
    # the s3 breaker: after the threshold of failed writes it fails fast
    with knobs.override_breaker_threshold(2), knobs.override_retry_max_attempts(1), \
            knobs.override_retry_backoff_cap_s(0.01), knobs.override_failpoints("storage.s3.write=http500"):
        for _ in range(2):
            with pytest.raises(Exception, match="InternalError"):
                _write(pkg, p, "c", b"z")
        with pytest.raises(pkg_mod.resilience.CircuitOpenError):
            _write(pkg, p, "c", b"z")
    assert ("bkt", "run/1/c") not in fake.objects
    pkg_mod.resilience.reset_breakers()
    # a multipart create fault is the write's own failure
    with _stripes(knobs), knobs.override_retry_max_attempts(1), knobs.override_retry_backoff_cap_s(0.01), \
            knobs.override_failpoints("storage.s3.part.create=http500"):
        with pytest.raises(Exception, match="InternalError"):
            run(p.begin_striped_write("d", 2 * PART))
    assert fake.multipart_uploads == {}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_link_from_copies_server_side(fake, pkg):
    p = _plugin(pkg)
    fake.objects[("bkt", "base/7/obj")] = b"payload"
    run(p.link_from("s3://bkt/base/7", "obj"))
    assert ("copy", "bkt", "run/1/obj", (("Bucket", "bkt"), ("Key", "base/7/obj"))) in fake.calls
    assert not any(c[0] in ("get", "put") for c in fake.calls)
    assert run(p.stat("obj")) == 7
    with pytest.raises(FileNotFoundError):
        run(p.link_from("s3://bkt/base/7", "nope"))


def test_endpoint_knob_and_missing_clients(fake, monkeypatch):
    env = "TORCHSNAPSHOT_TPU_TORCH_S3_ENDPOINT_URL"
    monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("TSNP_S3_ENDPOINT_URL", "http://legacy:9000")  # not read by the port
    assert tknobs.get_s3_endpoint_url() is None
    monkeypatch.setenv(env, "http://env:9000")
    assert tknobs.get_s3_endpoint_url() == "http://env:9000"
    with tknobs.override_s3_endpoint_url("http://override:9000"):
        assert tknobs.get_s3_endpoint_url() == "http://override:9000"
        ts3.S3StoragePlugin("bkt")
        ts3.S3StoragePlugin("bkt", endpoint_url="http://arg:9000")  # the argument wins
    with tknobs.override_s3_endpoint_url(None):
        assert tknobs.get_s3_endpoint_url() is None
        ts3.S3StoragePlugin("bkt")
    assert fake.client_kw == [{"endpoint_url": "http://override:9000"}, {"endpoint_url": "http://arg:9000"}, {}]
    monkeypatch.delenv("TSNP_S3_ENDPOINT_URL")
    monkeypatch.delenv(env)
    assert tknobs.get_s3_endpoint_url() is jknobs.get_s3_endpoint_url() is None
    # url_to_storage_plugin builds the port's plugin
    p = tts.storage.url_to_storage_plugin("s3://bkt/some/prefix")
    assert type(p) is ts3.S3StoragePlugin and (p.bucket, p.prefix) == ("bkt", "some/prefix")
    # neither boto3 nor s3fs: both packages raise the same error
    monkeypatch.setitem(sys.modules, "boto3", None)
    monkeypatch.setitem(sys.modules, "s3fs", None)
    errs = []
    for cls in (ts3.S3StoragePlugin, js3.S3StoragePlugin):
        with pytest.raises(RuntimeError) as ei:
            cls("bkt")
        errs.append(str(ei.value))
    assert errs[0] == errs[1] == "s3:// support requires boto3 or s3fs; neither is installed"


# ----------------------------------------------------- snapshot level


def _arrays(seed, big=False):
    rng = np.random.default_rng(seed)
    out = {
        "w": rng.standard_normal((64, 33)).astype(np.float32),
        "ids": rng.integers(-1000, 1000, 777).astype(np.int64),
        "e": np.zeros((0, 3), np.float32),
    }
    if big:  # multipart under _stripes: 3 parts
        out["big"] = rng.integers(0, 256, 2 * PART + 12_345, dtype=np.uint8)
    return out


def _state(pkg, seed, big=False, zero=False):
    arrays = {k: np.zeros_like(v) if zero else v for k, v in _arrays(seed, big).items()}
    if pkg == "port":
        return {"app": tts.StateDict(step=-1 if zero else seed, **{k: torch.from_numpy(v) for k, v in arrays.items()})}
    return {"app": jts.StateDict(step=-1 if zero else seed, **arrays)}


def _got(app):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in app.items() if k != "step"}


def _restore(pkg, url, seed, big=False):
    dest = _state(pkg, seed, big, zero=True)
    PKGS[pkg][5].Snapshot(url).restore(dest)
    assert dest["app"]["step"] == seed
    got = _got(dest["app"])
    for k, v in _arrays(seed, big).items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.parametrize("taker", ["port", "jax"])
def test_take_restores_in_the_other_package_with_the_same_keys(fake, taker):
    other = "jax" if taker == "port" else "port"
    keys = {}
    for pkg, url in ((taker, "s3://bkt/a/step1"), (other, "s3://bkt/b/step1")):
        with _stripes(PKGS[pkg][1]):
            PKGS[pkg][5].Snapshot.take(url, _state(pkg, 5, big=True))
        prefix = url[len("s3://bkt/"):] + "/"
        keys[pkg] = sorted(k[len(prefix):] for b, k in fake.objects if k.startswith(prefix))
    assert keys[taker] == keys[other] and ".snapshot_metadata" in keys[taker]
    assert fake.multipart_uploads == {}
    assert sum(1 for c in fake.calls if c[0] == "complete_multipart") == 2  # the big leaf, once per take
    _restore(other, "s3://bkt/a/step1", 5, big=True)
    _restore(taker, "s3://bkt/b/step1", 5, big=True)
    # materialize on the host equals the JAX package's
    got = tts.Snapshot("s3://bkt/a/step1").materialize(device="cpu")["app"]
    assert np.array_equal(got["w"].numpy(), _arrays(5)["w"]) and got["step"] == 5


def test_budgeted_reads_base_copies_and_async_take(fake):
    budget = 4096
    jts.Snapshot.take("s3://bkt/j/s0", _state("jax", 8))
    tts.Snapshot.take("s3://bkt/p/s0", _state("port", 8))
    for url in ("s3://bkt/j/s0", "s3://bkt/p/s0"):
        n0 = len(fake.calls)
        into = torch.zeros(64, 33, dtype=torch.float64)
        tts.Snapshot(url).read_object("0/app/w", obj_out=into, memory_budget_bytes=budget)
        assert np.array_equal(into.numpy(), _arrays(8)["w"].astype(np.float64))
        ranges = [c[3] for c in fake.calls[n0:] if c[0] == "get" and c[3] is not None]
        sizes = [int(b) - int(a) + 1 for a, b in (re.match(r"bytes=(\d+)-(\d+)", r).groups() for r in ranges)]
        assert len(sizes) > 1 and max(sizes) <= budget, sizes
        assert not any(c[0] == "get" and c[3] is None and c[2].endswith("app/w") for c in fake.calls[n0:])
    # an incremental take over the port's snapshot: unchanged objects are
    # copied server-side, never uploaded; the JAX package restores it
    n0 = len(fake.calls)
    state = _state("port", 8)
    tts.Snapshot.take("s3://bkt/p/s1", state, base="s3://bkt/p/s0")
    copies = [c for c in fake.calls[n0:] if c[0] == "copy"]
    assert copies and all(c[3][0] == ("Bucket", "bkt") and c[3][1][1].startswith("p/s0/") for c in copies)
    assert tts.obs.counters()[tts.obs.BYTES_DEDUPED] > 0
    _restore("jax", "s3://bkt/p/s1", 8)
    # an async take to s3://, restored by the JAX package
    tts.Snapshot.async_take("s3://bkt/p/s2", _state("port", 10)).wait()
    _restore("jax", "s3://bkt/p/s2", 10)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tier_over_a_durable_s3_root_across_packages(fake, tmp_path, writer):
    reader = "jax" if writer == "port" else "port"
    w_fast, r_fast = str(tmp_path / "wfast"), str(tmp_path / "rfast")
    mgr = PKGS[writer][5].SnapshotManager("s3://bkt/mgr", tier=PKGS[writer][5].TierConfig(fast_root=w_fast))
    mgr.save(_state(writer, 11), step=3)
    PKGS[writer][5].drain_promotions(timeout_s=60) if writer == "port" else jts.drain_promotions()
    assert ("bkt", "mgr/step_0000000003/.snapshot_metadata") in fake.objects
    # the reader has its own (empty) fast root: served by the durable tier
    rmgr = PKGS[reader][5].SnapshotManager("s3://bkt/mgr", tier=PKGS[reader][5].TierConfig(fast_root=r_fast))
    assert rmgr.latest_step() == 3
    dest = _state(reader, 11, zero=True)
    rmgr.restore_latest(dest)
    got = _got(dest["app"])
    assert all(np.array_equal(got[k], v) for k, v in _arrays(11).items())
    PKGS[reader][5].drain_promotions(timeout_s=60) if reader == "port" else jts.drain_promotions()


def test_the_card_paths_fake_stores_what_the_jax_suites_fake_stores(fake, monkeypatch):
    """``cloud_fakes.S3Fake`` (what ``chip_smoke.py`` and the CUDA tests
    run over, with no JAX there) against ``FakeBoto3Client``: the same
    objects and errors for the same port take, restore and failures."""
    import cloud_fakes

    lean = cloud_fakes.S3Fake()
    stores = {}
    for name, client in (("suite", fake), ("lean", lean)):
        monkeypatch.setitem(sys.modules, "boto3", types.SimpleNamespace(client=lambda s, **kw: client))
        with _stripes(tknobs):
            tts.Snapshot.take("s3://bkt/x/s0", _state("port", 9, big=True))
            tts.Snapshot.take("s3://bkt/x/s1", _state("port", 9, big=True), base="s3://bkt/x/s0")
        _restore("port", "s3://bkt/x/s1", 9, big=True)
        p = ts3.S3StoragePlugin("bkt/x")
        with pytest.raises(FileNotFoundError):
            _read("port", p, "nope")
        _write("port", p, "empty", b"")
        with pytest.raises(Exception, match="InvalidRange"):
            _read("port", p, "empty", [0, 1])
        stores[name] = {k: bytes(v) for k, v in client.objects.items() if not k[1].endswith("obsrecord")}
        assert client.multipart_uploads == {}
    assert stores["suite"] == stores["lean"]
    assert lean.ops["complete_multipart_upload"] == 1 and lean.ops["copy_object"] > 0
    assert lean.ops["upload_part"] == 3
