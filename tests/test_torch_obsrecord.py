"""The port's ``.snapshot_obsrecord`` flight record and goodput on the CPU.

Each package reads the other's record (and the JAX package's ``doctor``
renders the port's); a corrupted record is refused by both; the record
lands before ``.snapshot_metadata`` and only a committing take writes it;
two ranks on two threads merge into one record; a rank whose publish
fails leaves a partial record and a snapshot committed within the
collection deadline; the goodput gauges move on take and async_take.
Inputs come from a seeded numpy generator.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu.obs import aggregate as jagg
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import obs as tobs
from torchsnapshot_tpu_torch.obs import aggregate as tagg
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _fresh_obs():
    tobs.reset_metrics()
    tobs.goodput.reset()
    yield
    tobs.goodput.reset()


def _state(seed, n=30000):
    rng = np.random.default_rng(seed)
    return {"m": tts.StateDict(
        x=torch.from_numpy(rng.standard_normal(n)),
        small=torch.from_numpy(rng.integers(0, 9, 50).astype(np.int32)),
        step=seed,
    )}


def test_records_cross_between_packages_and_doctor_renders_the_port_s(tmp_path, capsys):
    from torchsnapshot_tpu.__main__ import main as jmain

    port = str(tmp_path / "port")
    tts.Snapshot.take(port, _state(0))
    rec = jagg.read_obsrecord(port)
    assert rec == tagg.read_obsrecord(port)
    assert rec["op"] == "take" and rec["ranks_reported"] == [0] and rec["missing_ranks"] == []
    assert rec["merged"]["counters"]["bytes_written"] >= 30000 * 8
    assert set(rec["per_rank"]["0"]["phases"]) == {"stage", "write"}
    assert rec["per_rank"]["0"]["backends"]["fs"]["write_bytes"] > 0
    assert jmain(["doctor", port]) == 0
    assert "take" in capsys.readouterr().out
    assert jmain(["doctor", port, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["path"] == port
    # a JAX record read by the port, and the same record encoding to the
    # same bytes in both packages
    jax_path = str(tmp_path / "jax")
    jts.Snapshot.take(jax_path, {"m": jts.StateDict(x=np.arange(64.0))})
    jrec = tagg.read_obsrecord(jax_path)
    assert jrec == jagg.read_obsrecord(jax_path) and jrec["op"] == "take"
    assert tagg.encode_record(jrec) == jagg.encode_record(jrec)
    assert tagg.decode_record(jagg.encode_record(rec)) == rec


@pytest.mark.parametrize("how", ["payload_byte", "trailer", "not_a_record"])
def test_a_corrupted_record_is_refused_by_both(tmp_path, how):
    path = str(tmp_path / "snap")
    tts.Snapshot.take(path, _state(1))
    f = os.path.join(path, tagg.OBSRECORD_FNAME)
    data = bytearray(open(f, "rb").read())
    if how == "payload_byte":
        i = data.index(b'"bytes_written"') + 2
        data[i] ^= 0x01
    elif how == "trailer":
        data[-3] = ord("G")
    else:
        data = bytearray(tagg.encode_record({"record": "something-else"}))
    open(f, "wb").write(bytes(data))
    for read in (tagg.read_obsrecord, jagg.read_obsrecord):
        with pytest.raises(RuntimeError):
            read(path)
    os.remove(f)
    with pytest.raises(FileNotFoundError, match="snapshot_obsrecord"):
        tagg.read_obsrecord(path)


def _failing_metadata_write(monkeypatch):
    import torchsnapshot_tpu_torch.snapshot as snap_mod

    class FailCommit(FSStoragePlugin):
        def sync_write(self, write_io):
            if write_io.path == ".snapshot_metadata":
                raise OSError(28, "injected ENOSPC at commit")
            return super().sync_write(write_io)

    monkeypatch.setattr(snap_mod, "url_to_storage_plugin", FailCommit)


@pytest.mark.parametrize("kind", ["take", "async_take"])
def test_record_lands_before_the_commit_marker(tmp_path, monkeypatch, kind):
    ok = str(tmp_path / "ok")
    if kind == "take":
        tts.Snapshot.take(ok, _state(2))
    else:
        tts.Snapshot.async_take(ok, _state(2)).wait()
    assert tagg.read_obsrecord(ok)["merged"]["counters"]["bytes_written"] >= 30000 * 8
    # a metadata write that fails leaves the record and no marker
    _failing_metadata_write(monkeypatch)
    bad = str(tmp_path / "bad")
    with pytest.raises(OSError, match="ENOSPC"):
        if kind == "take":
            tts.Snapshot.take(bad, _state(2))
        else:
            tts.Snapshot.async_take(bad, _state(2)).wait()
    assert not os.path.exists(os.path.join(bad, ".snapshot_metadata"))
    assert tagg.read_obsrecord(bad)["op"] == "take"


def test_a_take_that_fails_its_writes_writes_no_record(tmp_path, monkeypatch):
    import torchsnapshot_tpu_torch.snapshot as snap_mod

    class FailData(FSStoragePlugin):
        async def write(self, write_io):
            raise OSError(5, "injected EIO")

    monkeypatch.setattr(snap_mod, "url_to_storage_plugin", FailData)
    path = str(tmp_path / "snap")
    with pytest.raises(OSError, match="EIO"):
        tts.Snapshot.take(path, _state(3))
    assert not os.path.exists(os.path.join(path, tagg.OBSRECORD_FNAME))


class _NoPublish(tts.FileCoordinator):
    """A rank whose flight-record publish fails (its KV refuses the key)."""

    def kv_set(self, key, value):
        if "/obsrec/" in key:
            raise ConnectionError("injected KV failure on publish")
        super().kv_set(key, value)


def _two_ranks(fns):
    out, errs = [None, None], []

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append((i, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a rank outlived the timeout"
    assert not errs, errs
    return out


@pytest.mark.parametrize("failing", [None, 1])
def test_two_ranks_merge_and_a_failed_publish_leaves_a_partial_record(tmp_path, failing):
    path = str(tmp_path / "snap")
    kv = str(tmp_path / "kv")
    coords = [
        (_NoPublish if r == failing else tts.FileCoordinator)(kv, r, 2) for r in range(2)
    ]
    t0 = time.monotonic()
    _two_ranks([
        lambda r=r: tts.Snapshot.take(path, _state(10 + r, 2000), coordinator=coords[r])
        for r in range(2)
    ])
    elapsed = time.monotonic() - t0
    assert os.path.exists(os.path.join(path, ".snapshot_metadata"))
    rec = tagg.read_obsrecord(path)
    assert rec["world_size"] == 2
    if failing is None:
        assert rec["ranks_reported"] == [0, 1] and rec["missing_ranks"] == []
        assert set(rec["per_rank"]) == {"0", "1"}
    else:
        assert rec["ranks_reported"] == [0] and rec["missing_ranks"] == [1]
        # rank 0 waited one collection window for the missing payload
        assert elapsed < tagg._COLLECT_TIMEOUT_S + 20
        assert tobs.counters()[tobs.EXCEPTIONS_SWALLOWED] >= 1
    out = [_state(20 + r, 2000)["m"] for r in range(2)]
    fresh = [tts.FileCoordinator(str(tmp_path / "kv_restore"), r, 2) for r in range(2)]
    _two_ranks([
        lambda r=r: tts.Snapshot(path, coordinator=fresh[r]).restore({"m": out[r]})
        for r in range(2)
    ])
    for r in range(2):
        assert torch.equal(out[r]["x"], _state(10 + r, 2000)["m"]["x"])
    restored = tobs.aggregate.last_record("restore")
    assert restored["world_size"] == 2 and 0 in restored["ranks_reported"]


def test_a_failed_publish_at_world_one_still_commits(tmp_path, monkeypatch):
    class _Refusing(dict):
        def __setitem__(self, key, value):
            if key.startswith("_local/"):
                raise MemoryError("injected")
            super().__setitem__(key, value)

    monkeypatch.setattr(tagg, "_LAST_RECORDS", _Refusing())
    path = str(tmp_path / "snap")
    tts.Snapshot.take(path, _state(4))
    rec = tagg.read_obsrecord(path)
    assert rec["ranks_reported"] == [] and rec["missing_ranks"] == [0]
    out = _state(5)
    tts.Snapshot(path).restore(out)
    assert torch.equal(out["m"]["x"], _state(4)["m"]["x"])


def test_goodput_moves_on_take_and_async_take_unblocks_before_durable(tmp_path, monkeypatch):
    textfile = str(tmp_path / "metrics.prom")
    with tknobs.override_metrics_textfile(textfile):
        tts.Snapshot.take(str(tmp_path / "sync"), _state(6))
    gauges = tobs.metrics_snapshot()["gauges"]
    assert gauges[tobs.GOODPUT_TIME_TO_UNBLOCK_S]["value"] > 0
    assert gauges[tobs.GOODPUT_DURABILITY_LAG_S]["value"] > 0
    block = tobs.goodput.block()
    assert block["takes"] == 1 and block["durable_commits"] == 1
    assert 0 <= block["overhead_fraction"] <= 1
    json.dumps(block)
    assert "tsnp_bytes_written_total" in open(textfile).read()

    import torchsnapshot_tpu_torch.snapshot as snap_mod

    class Slow(FSStoragePlugin):
        async def write(self, write_io):
            await __import__("asyncio").sleep(0.2)
            await super().write(write_io)

    monkeypatch.setattr(snap_mod, "url_to_storage_plugin", Slow)
    pending = tts.Snapshot.async_take(str(tmp_path / "async"), _state(7))
    unblock = tobs.goodput.block()["time_to_unblock_s"]
    assert unblock is not None and tobs.goodput.block()["durable_commits"] == 1
    pending.wait()
    block = tobs.goodput.block()
    assert block["takes"] == 2 and block["durable_commits"] == 2
    assert block["durability_lag_s"] > unblock + 0.2
    assert tobs.metrics_snapshot()["gauges"][tobs.GOODPUT_DURABILITY_LAG_S]["value"] > unblock
