"""The port's budgeted buffer writes (``scheduler.sync_execute_buffer_writes``)
and the transports' ``device_move``, the continuous loop's replication
engine and its peer leg.

Mirrors ``tests/test_transport.py``'s two buffer-write tests on the port
(payloads routed through the collective engine's device round trip land
bitwise, with ``transport.device_moves`` advancing; a raising transport
degrades each payload to its staged bytes with ``transport.fallbacks``
advancing), and adds the pieces the reference's engine keeps: admission
under the budget (an oversized item alone), the ``io_concurrency`` cap,
the failpoint site, the span label and the counter.  The collective
engine runs its local mode on the CPU here (``device="cpu"``); the
card's round trip on a side stream is in ``test_torch_cuda.py``."""

import asyncio
import threading

import numpy as np
import pytest

from torchsnapshot_tpu_torch import knobs, obs
from torchsnapshot_tpu_torch.coordination import LocalCoordinator
from torchsnapshot_tpu_torch.io_types import StoragePlugin
from torchsnapshot_tpu_torch.scheduler import _LoopThread, sync_execute_buffer_writes
from torchsnapshot_tpu_torch.storage.memory import _NAMESPACES, MemoryStoragePlugin, reset_namespace
from torchsnapshot_tpu_torch.transport import Transport, resolve_transport
from torchsnapshot_tpu_torch.transport import collective as collective_mod
from torchsnapshot_tpu_torch.transport.kv import KVTransport


def _counter(name):
    return obs.counter(name).value


def _staged_items(k=3, n=50_000):
    rng = np.random.default_rng(7)
    return [(f"replica/part{i}", rng.integers(0, 256, n, dtype=np.uint8).tobytes()) for i in range(k)]


def _collective():
    with knobs.override_transport("collective"):
        t = resolve_transport(LocalCoordinator(), device="cpu")
    assert t.engine == "collective" and t.mode == "local"
    return t


def test_buffer_writes_device_move_preserves_bytes():
    reset_namespace("txdev")
    storage = MemoryStoragePlugin("txdev")
    t = _collective()
    moves0 = _counter("transport.device_moves")
    bytes0 = _counter("transport.collective_bytes")
    items = _staged_items()
    try:
        written = sync_execute_buffer_writes(
            items, storage, memory_budget_bytes=1 << 20,
            counter_name="continuous.replicated_bytes", transport=t,
        )
    finally:
        t.close()
    assert written == sum(len(b) for _, b in items)
    assert _counter("transport.device_moves") == moves0 + len(items)
    assert _counter("transport.collective_bytes") == bytes0 + written
    for path, buf in items:
        assert bytes(_NAMESPACES["txdev"][path]) == buf


def test_buffer_writes_raising_transport_degrades_to_staged_bytes():
    class _Broken(Transport):
        engine = "collective"

        def device_move(self, buf):
            raise RuntimeError("fabric down")

    reset_namespace("txdeg")
    storage = MemoryStoragePlugin("txdeg")
    items = _staged_items(k=2)
    fb0 = _counter("transport.fallbacks")
    written = sync_execute_buffer_writes(
        items, storage, memory_budget_bytes=1 << 20,
        counter_name="continuous.replicated_bytes", transport=_Broken(),
    )
    assert written == sum(len(b) for _, b in items)
    assert _counter("transport.fallbacks") == fb0 + 2
    for path, buf in items:
        assert bytes(_NAMESPACES["txdeg"][path]) == buf


def test_device_move_round_trip_verifies_and_counts(monkeypatch):
    """Local mode, in parts of ``TRANSPORT_PART_BYTES``: bitwise, one move
    and the payload's bytes counted; an empty payload moves nothing; a
    corrupted round trip raises; KV's ``device_move`` is the identity."""
    t = _collective()
    payload = np.random.default_rng(3).integers(0, 256, 3 * 4096 + 17, dtype=np.uint8).tobytes()
    moves0 = _counter("transport.device_moves")
    with knobs.override_transport_part_bytes(4096):
        assert bytes(t.device_move(payload)) == payload
        assert bytes(t.device_move(memoryview(payload)[5:])) == payload[5:]
    assert _counter("transport.device_moves") == moves0 + 2
    assert t.device_move(b"") == b""
    assert _counter("transport.device_moves") == moves0 + 2

    def corrupt(self, host, out, spans):
        out.copy_(host)
        out[0] ^= 1

    monkeypatch.setattr(collective_mod.CollectiveTransport, "_round_trip", corrupt)
    with pytest.raises(ValueError, match="digest verification"):
        t.device_move(payload)
    assert _counter("transport.device_moves") == moves0 + 2
    kv = KVTransport(LocalCoordinator())
    assert kv.device_move(payload) is payload


class _Recording(StoragePlugin):
    """Records, for each write, the bytes in flight once it started."""

    def __init__(self):
        self.in_flight = 0
        self.at_start = {}
        self.lock = threading.Lock()

    async def write(self, write_io):
        n = memoryview(write_io.buf).cast("B").nbytes
        with self.lock:
            self.in_flight += n
            self.at_start[write_io.path] = self.in_flight
        await asyncio.sleep(0.01)
        with self.lock:
            self.in_flight -= n

    async def read(self, read_io):
        raise NotImplementedError

    async def delete(self, path):
        raise NotImplementedError

    async def close(self):
        pass


def test_admission_under_the_budget_with_the_oversized_rule(monkeypatch):
    """At most the budget is in flight; an item larger than the budget is
    admitted alone and still lands; the io_concurrency cap holds with room
    in the budget."""
    storage = _Recording()
    items = [(f"p{i}", bytes(1000)) for i in range(8)] + [("big", bytes(5000))]
    assert sync_execute_buffer_writes(items, storage, 2500, counter_name="continuous.bytes_replicated") == 13000
    assert sorted(storage.at_start) == sorted(p for p, _ in items)
    assert storage.at_start.pop("big") == 5000  # alone
    assert max(storage.at_start.values()) == 2000  # two of 1000 fit 2500, a third does not
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_TORCH_MAX_PER_RANK_IO_CONCURRENCY", "1")
    storage = _Recording()
    sync_execute_buffer_writes(items[:8], storage, 1 << 20, counter_name="continuous.bytes_replicated")
    assert max(storage.at_start.values()) == 1000


def test_failpoint_span_counter_and_a_kept_loop_thread():
    """The failpoint site fires per item, each write is one span of the
    given label, the counter advances by the bytes written, and a loop
    thread passed in outlives the call."""
    reset_namespace("txfp")
    storage = MemoryStoragePlugin("txfp")
    items = _staged_items(k=2, n=100)
    with knobs.override_failpoints("continuous.replicate=io"):
        with pytest.raises(OSError):
            sync_execute_buffer_writes(items, storage, 1 << 20, counter_name="continuous.bytes_replicated",
                                       failpoint_site="continuous.replicate")
    assert not _NAMESPACES["txfp"]
    lt = _LoopThread("test-buffer-loop")
    try:
        c0 = _counter("continuous.bytes_replicated")
        with knobs.override_trace(1):
            obs.get_tracer().reset()
            for _ in range(2):
                assert sync_execute_buffer_writes(
                    items, storage, 1 << 20, counter_name="continuous.bytes_replicated",
                    span_label="continuous/replicate_object", loop_thread=lt,
                ) == 200
            spans = [s for s in obs.get_tracer().spans() if s.name == "continuous/replicate_object"]
        assert len(spans) == 4 and _counter("continuous.bytes_replicated") == c0 + 400
        assert lt._thread.is_alive()
    finally:
        lt.shutdown()
    assert sync_execute_buffer_writes([], storage, 1, counter_name="continuous.bytes_replicated") == 0
