"""The port's stripe engine (``storage/stripe.py``) against the JAX
package's: the part plan (hypothesis over sizes and part sizes), striped,
part-streamed and whole-staged striped writes on fs and ``memory://``
laying down the bytes the JAX package lays down (and the same bytes as a
one-stream write), striped reads honouring ``into``, whole, striped and
slab reads landing in a consumer's own buffer, abort and
cancellation leaving nothing behind, and a streamed object's admission
held to a window of 4 parts.  Byte comparisons are exact.
"""

import asyncio
import contextlib
import filecmp
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.storage import memory as jmemory
from torchsnapshot_tpu.storage import stripe as jstripe
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import obs as tobs
from torchsnapshot_tpu_torch import resilience as tres
from torchsnapshot_tpu_torch import scheduler as tsched
from torchsnapshot_tpu_torch.io_types import (
    BufferConsumer, ReadIO, ReadReq, StoragePlugin, StripedWriteHandle, WriteIO,
)
from torchsnapshot_tpu_torch.storage import memory as tmemory
from torchsnapshot_tpu_torch.storage import stripe as tstripe
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin
from torchsnapshot_tpu_torch.storage.memory import MemoryStoragePlugin

PART = 64 << 10
MIN = 128 << 10


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


@contextlib.contextmanager
def _stripes(part=PART, min_bytes=MIN, batching=False):
    with contextlib.ExitStack() as stack:
        for k in (tknobs, jknobs):
            stack.enter_context(k.override_stripe_part_size_bytes(part))
            stack.enter_context(k.override_stripe_min_object_size_bytes(min_bytes))
            stack.enter_context(k.override_disable_batching(not batching))
            stack.enter_context(k.override_retry_backoff_cap_s(0.01))
        yield


def _counts():
    return dict(tobs.counters())


def _delta(c0, *names):
    c1 = tobs.counters()
    return [c1.get(n, 0) - c0.get(n, 0) for n in names]


@settings(max_examples=200, deadline=None, database=None)
@given(part=st.integers(1, 1 << 26), whole=st.integers(0, 600), tail=st.integers(0, 1 << 26))
def test_plan_parts_matches_jax(part, whole, tail):
    total = whole * part + tail % part
    got = tstripe.plan_parts(total, part)
    assert got == jstripe.plan_parts(total, part)
    assert sum(hi - lo for lo, hi in got) == total
    assert all(hi - lo == part for lo, hi in got[:-1]) and (not got or 0 < got[-1][1] - got[-1][0] <= part)


def test_eligibility_matches_jax():
    plugin = MemoryStoragePlugin("elig")
    jplugin = jmemory.MemoryStoragePlugin("elig")
    for part, min_bytes in ((PART, MIN), (PART, 1), (PART, 0), (1 << 20, 1 << 20)):
        with _stripes(part, min_bytes):
            for n in (0, PART, PART + 1, MIN - 1, MIN, 1 << 20, (1 << 20) + 1):
                assert tstripe.write_eligible(n, plugin) == jstripe.write_eligible(n, jplugin)
                assert tstripe.read_eligible(n) == jstripe.read_eligible(n)
            assert tstripe.part_concurrency() == jstripe.part_concurrency()


def _state(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal(70001).astype(np.float32),  # 280 KB: 5 parts, a ragged last
        "h": rng.standard_normal(40000).astype(np.float16),  # 80 KB: one stream
        "i": rng.integers(-99, 99, 33000).astype(np.int64),  # 264 KB
    }


def _port_app(state):
    return {"app": tts.StateDict({k: torch.from_numpy(v.copy()) for k, v in state.items()})}


@pytest.mark.parametrize("mode", ["take", "async_take"])
def test_striped_and_streamed_fs_files_equal_jax(tmp_path, mode):
    """Streamed (host arrays, sync or after the async defensive copy)
    writes lay down the JAX package's bytes and the bytes of a one-stream
    write; every striped object is counted."""
    state = _state(1)
    paths = {k: str(tmp_path / k) for k in ("port", "jax", "plain")}
    c0 = _counts()
    with _stripes():
        if mode == "take":
            tts.Snapshot.take(paths["port"], _port_app(state))
        else:
            tts.Snapshot.async_take(paths["port"], _port_app(state)).wait()
        jts.Snapshot.take(paths["jax"], {"app": jts.StateDict(dict(state))})
    writes, streamed = _delta(c0, "storage.stripe.writes", "storage.stripe.streamed_writes")
    assert writes == streamed == 2
    with _stripes(min_bytes=0):
        tts.Snapshot.take(paths["plain"], _port_app(state))
    for other in ("jax", "plain"):
        for loc in tts.Snapshot(paths["port"]).metadata.objects:
            assert filecmp.cmp(os.path.join(paths["port"], loc), os.path.join(paths[other], loc), shallow=False)
    assert tts.Snapshot(paths["port"]).metadata.objects == jts.Snapshot(paths["jax"]).metadata.objects
    c1 = _counts()
    with _stripes():
        dest = jts.StateDict({k: np.zeros_like(v) for k, v in state.items()})
        jts.Snapshot(paths["port"]).restore({"app": dest})
        tdest = tts.StateDict({k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in state.items()})
        # reads that copy stripe; a mapped read (MMAP, the default) never does
        with tknobs.override_mmap(False):
            tts.Snapshot(paths["jax"]).restore({"app": tdest}, device="cpu")
    assert _delta(c1, "storage.stripe.reads") == [2]
    for k, v in state.items():
        assert dest[k].tobytes() == v.tobytes() == tdest[k].numpy().tobytes()
    c2 = _counts()
    with _stripes():
        mdest = tts.StateDict({k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in state.items()})
        tts.Snapshot(paths["jax"]).restore({"app": mdest}, device="cpu")
    reads, mapped = _delta(c2, "storage.stripe.reads", "storage.mmap.reads")
    assert reads == 0 and mapped == len(state)
    for k, v in state.items():
        assert mdest[k].numpy().tobytes() == v.tobytes()


@pytest.mark.parametrize("backend", ["fs", "memory"])
def test_engine_writes_and_reads_match_jax(tmp_path, backend):
    """``striped_write`` (whole-staged, digests fused per part) and
    ``streamed_part_write`` store what the JAX engine stores; the folded
    digests are the whole buffer's; ``striped_read`` reads into ``into``."""
    from torchsnapshot_tpu.preparers.array import HostArrayBufferStager as JHost
    from torchsnapshot_tpu_torch.preparers.array import HostArrayBufferStager as THost
    from torchsnapshot_tpu_torch.utils.checksums import digest

    data = np.random.default_rng(2).integers(0, 256, 5 * PART + 777, dtype=np.uint8)
    if backend == "fs":
        tp, jp = FSStoragePlugin(str(tmp_path / "t")), jts.storage.fs.FSStoragePlugin(str(tmp_path / "j"))
    else:
        tp, jp = MemoryStoragePlugin("eng_t"), jmemory.MemoryStoragePlugin("eng_j")
    spans = tstripe.plan_parts(data.nbytes, PART)
    try:
        with _stripes():
            d = _run(tstripe.striped_write(tp, "obj", memoryview(data), want_digests=True))
            _run(jstripe.striped_write(jp, "obj", memoryview(data)))
            parts = _run(tstripe.streamed_part_write(
                tp, "streamed", THost(data, defensive_copy=False), spans, None,
                window_parts=4, want_digests=True))
            _run(jstripe.streamed_part_write(
                jp, "streamed", JHost(data, defensive_copy=False), spans, None, window_parts=4))
            assert d == (*digest(data), data.nbytes)
            assert len(parts) == len(spans) and [p[2] for p in parts] == [hi - lo for lo, hi in spans]
            for name in ("obj", "streamed"):
                got, want = ReadIO(path=name), jts.io_types.ReadIO(path=name)
                _run(tp.read(got))
                _run(jp.read(want))
                assert bytes(got.buf) == bytes(want.buf) == data.tobytes()
            into = np.zeros(3 * PART + 5, dtype=np.uint8)
            out = _run(tstripe.striped_read(tp, "obj", offset=PART - 3, length=into.nbytes, into=into))
            assert out is into and into.tobytes() == data[PART - 3 : 4 * PART + 2].tobytes()
            out = _run(tstripe.striped_read(tp, "obj", offset=1, length=7, into=np.zeros(3, np.uint8)))
            assert bytes(out) == data[1:8].tobytes()
    finally:
        _run(tp.close())
        tmemory.reset_namespace("eng_t")
        jmemory.reset_namespace("eng_j")


def test_whole_staged_striped_slab_equals_jax(tmp_path):
    """Small tensors batched into a slab over the threshold: a
    whole-staged striped write (slabs never stream), the same file and
    manifest as the JAX package's."""
    rng = np.random.default_rng(3)
    state = {f"p{i}": rng.standard_normal(9000).astype(np.float32) for i in range(12)}
    c0 = _counts()
    with _stripes(batching=True):
        tts.Snapshot.take(str(tmp_path / "port"), _port_app(state))
        jts.Snapshot.take(str(tmp_path / "jax"), {"app": jts.StateDict(dict(state))})
    assert _delta(c0, "storage.stripe.writes", "storage.stripe.streamed_writes") == [1, 0]
    tm, jm = tts.Snapshot(str(tmp_path / "port")).metadata, jts.Snapshot(str(tmp_path / "jax")).metadata
    assert tm.objects == jm.objects and list(tm.objects) == ["0/batched.0"]
    assert filecmp.cmp(str(tmp_path / "port" / "0/batched.0"), str(tmp_path / "jax" / "0/batched.0"), shallow=False)
    assert tts.verify_snapshot(str(tmp_path / "port"), deep=True).ok


def test_memory_scheme_take_restore_and_bytes_equal_jax():
    state = _state(4)
    try:
        with _stripes():
            tts.Snapshot.take("memory://stripe_t", _port_app(state))
            jts.Snapshot.take("memory://stripe_j", {"app": jts.StateDict(dict(state))})
            dest = tts.StateDict({k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in state.items()})
            tts.Snapshot("memory://stripe_t").restore({"app": dest}, device="cpu")
        assert all(dest[k].numpy().tobytes() == v.tobytes() for k, v in state.items())
        t_store, j_store = tmemory._NAMESPACES["stripe_t"], jmemory._NAMESPACES["stripe_j"]
        for loc in tts.Snapshot("memory://stripe_t").metadata.objects:
            assert bytes(memoryview(t_store[loc]).cast("B")) == bytes(memoryview(j_store[loc]).cast("B"))
        assert tts.verify_snapshot("memory://stripe_t", deep=True).ok
    finally:
        tmemory.reset_namespace("stripe_t")
        jmemory.reset_namespace("stripe_j")


def test_aborted_handle_leaves_no_temp_file(tmp_path):
    plugin = FSStoragePlugin(str(tmp_path / "fs"))
    c0 = _counts()
    try:
        with _stripes(), tknobs.override_failpoints("storage.fs.part.write=io"):
            with pytest.raises(OSError):
                _run(tstripe.striped_write(plugin, "doomed", memoryview(b"x" * (3 * PART))))
            spans = tstripe.plan_parts(3 * PART, PART)
            from torchsnapshot_tpu_torch.preparers.array import HostArrayBufferStager

            with pytest.raises(OSError):
                _run(tstripe.streamed_part_write(
                    plugin, "doomed2", HostArrayBufferStager(np.zeros(3 * PART, np.uint8)), spans,
                    None, window_parts=4))
        # six failed parts tripped the fs breaker (as in the JAX package)
        assert tres.get_breaker("fs").state == "open"
        tres.reset_breakers()
        handle = _run(plugin.begin_striped_write("explicit", 10))
        _run(handle.write_part(0, 0, b"0123456789"))
        _run(handle.abort())
        _run(handle.abort())  # idempotent
    finally:
        _run(plugin.close())
        tres.reset_breakers()
    assert _delta(c0, "storage.stripe.aborts") == [2]
    assert [f for _, _, fs in os.walk(str(tmp_path / "fs")) for f in fs] == []


def test_cancellation_aborts_the_handle():
    events = []

    class Handle(StripedWriteHandle):
        async def write_part(self, index, offset, buf, want_digest=False):
            events.append(("part", index))
            await asyncio.sleep(30)

        async def complete(self):
            events.append(("complete",))

        async def abort(self):
            events.append(("abort",))

    class Plugin(StoragePlugin):
        supports_striped_write = True
        obs_backend = "fake"

        async def begin_striped_write(self, path, total):
            return Handle()

        async def write(self, write_io):  # pragma: no cover
            raise AssertionError

        async def read(self, read_io):  # pragma: no cover
            raise AssertionError

    async def main():
        task = asyncio.ensure_future(tstripe.striped_write(Plugin(), "x", memoryview(b"a" * (3 * PART))))
        await asyncio.sleep(0.05)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        await asyncio.sleep(0.05)

    with _stripes():
        _run(main())
    assert ("abort",) in events and ("complete",) not in events


def test_streamed_admission_is_at_most_four_parts(tmp_path, monkeypatch):
    """The scheduler reserves 4 parts for a streamed object, and the
    engine never holds more than 4 parts' bytes staged and unwritten; an
    object larger than the whole budget still moves under it."""
    from torchsnapshot_tpu_torch.io_types import WriteReq
    from torchsnapshot_tpu_torch.preparers.array import HostArrayBufferStager

    data = np.random.default_rng(5).integers(0, 256, 13 * PART + 5, dtype=np.uint8)
    plugin = MemoryStoragePlugin("window_t")
    held = {"now": 0, "max": 0}

    class Tracking(HostArrayBufferStager):
        async def stage_part(self, span, executor=None):
            held["now"] += span[1] - span[0]
            held["max"] = max(held["max"], held["now"])
            await asyncio.sleep(0.001)
            return await super().stage_part(span, executor)

    def done(n):
        held["now"] -= n

    try:
        with _stripes():
            pipes = [tsched._WritePipeline(WriteReq(path="big", buffer_stager=Tracking(data)))]
            tsched._plan_streams(pipes, plugin)
            assert pipes[0].admission_cost == tsched._STREAM_WINDOW_PARTS * PART == 4 * PART
            _run(tstripe.streamed_part_write(
                plugin, "big", Tracking(data), tstripe.plan_parts(data.nbytes, PART), None,
                window_parts=tsched._STREAM_WINDOW_PARTS, on_part_done=done))
            assert 0 < held["max"] <= 4 * PART
            monkeypatch.setenv("TORCHSNAPSHOT_TPU_TORCH_PER_RANK_MEMORY_BUDGET_BYTES", str(5 * PART))
            tts.Snapshot.take("memory://window_s", _port_app({"big": data}))
            out = tts.Snapshot("memory://window_s").read_object("0/app/big", device="cpu")
            assert out.numpy().tobytes() == data.tobytes()
    finally:
        tmemory.reset_namespace("window_t")
        tmemory.reset_namespace("window_s")


def test_defensive_copy_and_device_stagers_stage_whole():
    from torchsnapshot_tpu_torch.batcher import BatchedBufferStager
    from torchsnapshot_tpu_torch.preparers.array import HostArrayBufferStager

    arr = np.zeros(4 * PART, np.uint8)
    assert HostArrayBufferStager(arr, defensive_copy=True).part_plan(PART) is None
    st = HostArrayBufferStager(arr, defensive_copy=True)
    st.offload()
    assert st.part_plan(PART) == tstripe.plan_parts(arr.nbytes, PART)
    assert HostArrayBufferStager(np.zeros((64, 64), np.float32).T, False).part_plan(PART) is None
    assert BatchedBufferStager([(HostArrayBufferStager(arr), 0)], arr.nbytes).part_plan(PART) is None


class _Offering(BufferConsumer):
    """Offers the storage a buffer of its own, or none, and keeps what it
    is handed."""

    def __init__(self, nbytes, offers):
        self.nbytes = nbytes
        self.into = np.empty(nbytes, np.uint8) if offers else None
        self.asked = []
        self.got = None

    def read_buffer(self, nbytes):
        self.asked.append(nbytes)
        return self.into

    async def consume_buffer(self, buf, executor=None):
        self.got = buf

    def get_consuming_cost_bytes(self):
        return self.nbytes


@pytest.mark.parametrize("offers", [True, False], ids=["offers", "offers_none"])
@pytest.mark.parametrize("case", ["striped", "whole", "slab"])
def test_reads_land_in_the_consumers_own_buffer(case, offers):
    """A whole object above the stripe threshold, one below it and a
    ranged read spanning a slab's members each land in the buffer the
    consumer offers (that same object, bitwise the stored bytes); a
    consumer that offers none gets the storage's own buffer."""
    ns = f"offer_{case}_{offers}"
    plugin = MemoryStoragePlugin(ns)
    data = np.random.default_rng(7).integers(0, 256, 3 * PART + 11, dtype=np.uint8)
    try:
        with _stripes(batching=True):
            if case == "slab":
                small = {f"s{i}": np.full(300 + i, i, np.float32) for i in range(4)}
                tts.Snapshot.take(f"memory://{ns}", _port_app(small))
                manifest = tts.Snapshot(f"memory://{ns}").metadata.manifest
                ranges = [manifest[f"0/app/{k}"].byte_range for k in small]
                path = manifest["0/app/s0"].location
                byte_range = [min(r[0] for r in ranges), max(r[1] for r in ranges)]
                assert "batched" in path and len({manifest[f"0/app/{k}"].location for k in small}) == 1
            else:
                path, byte_range = "obj", None
                if case == "whole":
                    data = data[: PART + 5]
                _run(plugin.write(WriteIO(path=path, buf=memoryview(data))))
            stored = bytes(memoryview(tmemory._NAMESPACES[ns][path]).cast("B"))
            if byte_range is not None:
                stored = stored[byte_range[0] : byte_range[1]]
            consumer = _Offering(len(stored), offers)
            c0 = _counts()
            tsched.sync_execute_read_reqs(
                [ReadReq(path=path, buffer_consumer=consumer, byte_range=byte_range)], plugin, 1 << 30, 0
            )
            assert _delta(c0, "storage.stripe.reads") == [int(case == "striped")]
        assert consumer.asked == [len(stored)]
        assert (consumer.got is consumer.into) == offers
        assert bytes(memoryview(consumer.got).cast("B")) == stored
    finally:
        tmemory.reset_namespace(ns)
