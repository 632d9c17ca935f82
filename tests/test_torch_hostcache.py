"""The port's shared-host object cache (``storage/hostcache.py``) against
the JAX package's: one durable GET per object across reader threads and
across processes, commit markers never cached, a write or delete
dropping its entry, eviction oldest-first by unlink, a streamed fill of
an object larger than a stripe part, mapped hits, the same cache keys
(a directory filled by either package serves the other with no GET),
the ``stats`` CLI's cache rollup, a durable fallback of a tier through
the cache, and the bounded lock poll.  States come from a seeded numpy
generator; comparisons are exact.
"""

import errno
import fcntl
import json
import os
import shutil
import subprocess
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.storage import hostcache as jcache
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO, is_mmap_backed
from torchsnapshot_tpu_torch.storage import hostcache as tcache
from torchsnapshot_tpu_torch.storage.memory import MemoryStoragePlugin, reset_namespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counters():
    return dict(tts.obs.counters())


def _delta(before, name):
    return _counters().get(name, 0) - before.get(name, 0)


def _arrays(seed, n=3, size=1 << 12):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(size) for k in "abc"[:n]}


def _port_take(path, seed, n=3):
    with tknobs.override_disable_batching(True):
        tts.Snapshot.take(path, {"m": tts.StateDict(**{
            k: torch.from_numpy(v) for k, v in _arrays(seed, n).items()})})


def _cached(ns, **kw):
    return tcache.HostCachedStoragePlugin(MemoryStoragePlugin(namespace=ns), f"memory://{ns}", **kw)


@pytest.fixture
def counted_reads(monkeypatch):
    """Every payload read that reaches the memory plugin (a durable GET)."""
    gets = []
    orig = MemoryStoragePlugin.read

    async def counting(self, read_io):
        if not os.path.basename(read_io.path).startswith(".snapshot"):
            gets.append(read_io.path)
        await orig(self, read_io)

    monkeypatch.setattr(MemoryStoragePlugin, "read", counting)
    return gets


def test_reader_threads_get_each_object_once(tmp_path, counted_reads):
    ns = f"tcache_threads_{os.getpid()}"
    reset_namespace(ns)
    n_readers = 6
    results, errors = {}, []
    with tknobs.override_cache_dir(str(tmp_path / "cache")):
        _port_take(f"memory://{ns}", 1)
        counted_reads.clear()
        before = _counters()
        barrier = threading.Barrier(n_readers)

        def reader(i):
            try:
                snap = tts.Snapshot(f"memory://{ns}")
                barrier.wait(timeout=60)
                results[i] = {
                    k: zlib.crc32(snap.read_object(f"0/m/{k}", device="cpu").numpy().tobytes())
                    for k in "abc"
                }
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=reader, args=(i,)) for i in range(n_readers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not errors, errors
    assert sorted(counted_reads) == ["0/m/a", "0/m/b", "0/m/c"]
    assert _delta(before, tts.obs.CACHE_MISSES) == 3
    assert (_delta(before, tts.obs.CACHE_HITS) + _delta(before, tts.obs.CACHE_SINGLEFLIGHT_WAITS)
            == n_readers * 3 - 3)
    want = {k: zlib.crc32(v.tobytes()) for k, v in _arrays(1).items()}
    assert all(r == want for r in results.values())
    reset_namespace(ns)


_CHILD = r"""
import json, os, sys, zlib
sys.path.insert(0, sys.argv[3])
root, log = sys.argv[1], sys.argv[2]
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

orig = FSStoragePlugin.read

async def logged(self, read_io):
    with open(log, "a") as f:  # O_APPEND single-line writes are atomic
        f.write(read_io.path + "\n")
    await orig(self, read_io)

FSStoragePlugin.read = logged
import torchsnapshot_tpu_torch as tts

snap = tts.Snapshot(root)
out = {p: zlib.crc32(snap.read_object(p, device="cpu").numpy().tobytes()) for p in ("0/m/a", "0/m/b")}
c = tts.obs.counters()
out["counts"] = [c.get(k, 0) for k in (tts.obs.CACHE_MISSES, tts.obs.CACHE_HITS,
                                         tts.obs.CACHE_SINGLEFLIGHT_WAITS)]
print(json.dumps(out))
"""


def test_reader_processes_get_each_object_once(tmp_path):
    root = str(tmp_path / "snap")
    _port_take(root, 2, n=2)
    log = str(tmp_path / "gets.log")
    env = dict(os.environ, TORCHSNAPSHOT_TPU_TORCH_CACHE_DIR=str(tmp_path / "cache"))
    procs = [
        subprocess.Popen([sys.executable, "-c", _CHILD, root, log, REPO],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for _ in range(2)
    ]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr.decode()[-2000:]
            outs.append(json.loads(stdout.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=10)
    gets = [ln.strip() for ln in open(log) if not os.path.basename(ln.strip()).startswith(".snapshot")]
    assert sorted(gets) == ["0/m/a", "0/m/b"]
    # summed over the processes: one miss per object, every other read a
    # hit or a wait behind the other's fill
    misses, hits, waits = (sum(o["counts"][i] for o in outs) for i in range(3))
    assert misses == 2 and hits + waits == 2
    want = {f"0/m/{k}": zlib.crc32(v.tobytes()) for k, v in _arrays(2, 2).items()}
    for o in outs:
        assert {k: o[k] for k in want} == want


def test_markers_bypass_and_writes_and_deletes_invalidate(tmp_path):
    ns = f"tcache_inval_{os.getpid()}"
    reset_namespace(ns)
    with tknobs.override_cache_dir(str(tmp_path / "cache")):
        plugin = _cached(ns)
        for v in (b"marker-v1", b"marker-v2"):
            plugin.sync_write(WriteIO(path=".snapshot_metadata", buf=v))
            r = ReadIO(path=".snapshot_metadata")
            plugin.sync_read(r)
            assert bytes(r.buf) == v
            assert not os.path.exists(plugin._cache_file(".snapshot_metadata"))
        for v in (b"one", b"two"):
            plugin.sync_write(WriteIO(path="obj", buf=v))
            assert not os.path.exists(plugin._cache_file("obj"))
            r = ReadIO(path="obj")
            plugin.sync_read(r)
            assert bytes(r.buf) == v and os.path.exists(plugin._cache_file("obj"))
        plugin.sync_delete("obj")
        assert not os.path.exists(plugin._cache_file("obj"))
        with pytest.raises(FileNotFoundError):
            plugin.sync_read(ReadIO(path="obj"))
        plugin.sync_close()
    reset_namespace(ns)


def test_eviction_unlinks_the_oldest_entries_first(tmp_path):
    ns = f"tcache_evict_{os.getpid()}"
    reset_namespace(ns)
    with tknobs.override_cache_dir(str(tmp_path / "cache")), tknobs.override_cache_max_bytes(2500):
        plugin = _cached(ns)
        before = _counters()
        for i in range(3):
            plugin.sync_write(WriteIO(path=f"o{i}", buf=bytes([i]) * 1000))
        for i in (0, 1):
            plugin.sync_read(ReadIO(path=f"o{i}"))
            os.utime(plugin._cache_file(f"o{i}"), (100 + i, 100 + i))
        # a mapped view of the oldest entry survives its eviction
        r = ReadIO(path="o0", want_mmap=True)
        plugin.sync_read(r)
        assert is_mmap_backed(r.buf)
        plugin.sync_read(ReadIO(path="o2"))  # 3000 bytes > 2500: o0 goes
        assert _delta(before, tts.obs.CACHE_EVICTIONS) == 1
        assert not os.path.exists(plugin._cache_file("o0"))
        assert all(os.path.exists(plugin._cache_file(f"o{i}")) for i in (1, 2))
        assert bytes(r.buf) == bytes([0]) * 1000
        r = ReadIO(path="o0")
        plugin.sync_read(r)  # refills
        assert bytes(r.buf) == bytes([0]) * 1000
        plugin.sync_close()
    reset_namespace(ns)


def test_streamed_fill_of_an_object_larger_than_a_part(tmp_path):
    ns = f"tcache_stream_{os.getpid()}"
    reset_namespace(ns)
    payload = np.random.default_rng(3).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    spans = []
    orig = MemoryStoragePlugin.read

    async def spy(self, read_io):
        spans.append(read_io.byte_range)
        await orig(self, read_io)

    with tknobs.override_cache_dir(str(tmp_path / "cache")), \
            tknobs.override_stripe_part_size_bytes(1 << 16):
        plugin = _cached(ns)
        plugin.inner._store["big"] = payload
        plugin.inner.read = spy.__get__(plugin.inner)
        before = _counters()
        r = ReadIO(path="big")
        plugin.sync_read(r)
        assert bytes(memoryview(r.buf).cast("B")) == payload
        # 16 spans of one part each, never the whole object at once
        assert spans == [[lo, lo + (1 << 16)] for lo in range(0, 1 << 20, 1 << 16)]
        assert _delta(before, tts.obs.CACHE_MISSES) == 1
        assert _delta(before, tts.obs.CACHE_BYTES_FILLED) == len(payload)
        r = ReadIO(path="big", byte_range=[5, 70000])
        plugin.sync_read(r)
        assert bytes(memoryview(r.buf).cast("B")) == payload[5:70000]
        assert _delta(before, tts.obs.CACHE_HITS) == 1
        plugin.sync_close()
    reset_namespace(ns)


@pytest.mark.parametrize("filler", ["jax", "port"])
def test_a_cache_filled_by_either_package_serves_the_other(tmp_path, filler):
    root = str(tmp_path / "snap")
    _port_take(root, 4)
    cache = str(tmp_path / "cache")
    want = _arrays(4)
    # the same key for the same (durable url, path) in both packages
    tp = tcache.HostCachedStoragePlugin(MemoryStoragePlugin(namespace="k"), root, cache_dir=cache)
    jp = jcache.HostCachedStoragePlugin(object(), root, cache_dir=cache)
    assert all(tp._cache_file(f"0/m/{k}") == jp._cache_file(f"0/m/{k}") for k in want)
    with jknobs.override_cache_dir(cache), tknobs.override_cache_dir(cache):
        for k, v in want.items():
            if filler == "jax":
                got = np.asarray(jts.Snapshot(root).read_object(f"0/m/{k}"))
            else:
                got = tts.Snapshot(root).read_object(f"0/m/{k}", device="cpu").numpy()
            assert got.tobytes() == v.tobytes()
        shutil.rmtree(os.path.join(root, "0"))  # the cache alone serves now
        before = _counters()
        for k, v in want.items():
            if filler == "jax":
                got = tts.Snapshot(root).read_object(f"0/m/{k}", device="cpu").numpy()
            else:
                got = np.asarray(jts.Snapshot(root).read_object(f"0/m/{k}"))
            assert got.tobytes() == v.tobytes(), k
        if filler == "jax":
            assert _delta(before, tts.obs.CACHE_HITS) == 3
            assert _delta(before, tts.obs.CACHE_MISSES) == 0


def test_restore_through_the_cache_is_mapped_and_stats_rolls_it_up(tmp_path, capsys):
    from torchsnapshot_tpu.__main__ import main as jax_main
    from torchsnapshot_tpu_torch.__main__ import main as port_main

    root = str(tmp_path / "snap")
    _port_take(root, 5)
    cache = str(tmp_path / "cache")
    with tknobs.override_cache_dir(cache), jknobs.override_cache_dir(cache):
        for _ in range(2):
            dest = {"m": tts.StateDict(**{k: torch.zeros(1 << 12, dtype=torch.float64) for k in "abc"})}
            before = _counters()
            tts.Snapshot(root).restore(dest, device="cpu")
            for k, v in _arrays(5).items():
                assert dest["m"][k].numpy().tobytes() == v.tobytes()
        # the second restore: every payload a hit, served mapped
        assert _delta(before, tts.obs.CACHE_HITS) == 3
        assert _delta(before, tts.obs.CACHE_MISSES) == 0
        assert _delta(before, tts.obs.MMAP_READS) == 3
        docs = {}
        for name, main in (("port", port_main), ("jax", jax_main)):
            assert main(["stats", root, "--json"]) == 0
            docs[name] = json.loads(capsys.readouterr().out)["cache"]
    for key in ("dir", "objects", "bytes"):
        assert docs["port"][key] == docs["jax"][key], key
    assert docs["port"]["objects"] == 3 and docs["port"]["hits"] >= 3


def test_tier_durable_fallback_goes_through_the_cache(tmp_path):
    fast, durable = str(tmp_path / "fast"), str(tmp_path / "durable")
    opts = {"tier": {"fast_url": fast, "policy": "write_back"}}
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(1 << 12))
    try:
        with tknobs.override_cache_dir(str(tmp_path / "cache")):
            tts.Snapshot.take(durable, {"m": tts.StateDict(w=w)}, storage_options=opts)
            tts.drain_promotions(timeout_s=60)
            before = _counters()
            outs = []
            for _ in range(2):
                shutil.rmtree(fast)  # the first fallback repaired it
                outs.append(tts.Snapshot(durable, storage_options=opts).read_object("0/m/w", device="cpu"))
    finally:
        tts.drain_promotions(raise_on_error=False, timeout_s=60)
    assert all(torch.equal(o, w) for o in outs)
    assert _delta(before, tts.obs.CACHE_MISSES) == 1
    assert _delta(before, tts.obs.CACHE_HITS) >= 1


def test_lock_poll_is_bounded_and_a_lockless_filesystem_raises(tmp_path, monkeypatch):
    ns = f"tcache_lock_{os.getpid()}"
    reset_namespace(ns)
    with tknobs.override_cache_dir(str(tmp_path / "cache")):
        plugin = _cached(ns)
        plugin.sync_write(WriteIO(path="obj", buf=b"x" * 10))
        # another open file description holds the fill lock and never publishes
        lock = plugin._lock_path(plugin._cache_file("obj"))
        os.makedirs(os.path.dirname(lock), exist_ok=True)
        fd = os.open(lock, os.O_CREAT | os.O_RDWR, 0o644)
        fcntl.flock(fd, fcntl.LOCK_EX)
        monkeypatch.setattr(tcache, "LOCK_DEADLINE_S", 0.2)
        try:
            with pytest.raises(tcache.CacheLockTimeout) as e:
                plugin.sync_read(ReadIO(path="obj"))
            assert lock in str(e.value) and "'obj'" in str(e.value)
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)
        r = ReadIO(path="obj")
        plugin.sync_read(r)
        assert bytes(r.buf) == b"x" * 10

        def no_locks(fd, op):
            raise OSError(errno.ENOLCK, "No locks available")

        monkeypatch.setattr(fcntl, "flock", no_locks)
        plugin.sync_write(WriteIO(path="obj2", buf=b"y"))
        with pytest.raises(OSError) as e:
            plugin.sync_read(ReadIO(path="obj2"))
        assert e.value.errno == errno.ENOLCK
        plugin.sync_close()
    reset_namespace(ns)
