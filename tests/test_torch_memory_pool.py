"""The memory plugin's recycled destination buffers
(``torchsnapshot_tpu_torch/storage/memory.py``).

A take loop over two namespaces draws its writes from the buffers the
snapshot before last released, by the pool's counters, and restores
bitwise; a read's view, a tensor over it or a ``link_from`` copy keeps
its bytes across later takes and its buffer out of the pool; stored
buffers are read-only, recycled ones included; a striped write with a
hole fails and publishes nothing; an aborted one gives its buffer back;
a miss frees pooled bytes first, so live plus pooled bytes stay under
the earlier peak; objects the plugin did not allocate are never pooled;
threads writing and deleting at once never share a buffer.
"""

import asyncio
import contextlib
import sys
import threading
import uuid
import weakref

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import knobs, obs
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage import memory
from torchsnapshot_tpu_torch.storage.memory import MemoryStoragePlugin

# commit-time objects whose length changes from take to take
VARYING = (".snapshot_metadata", ".snapshot_obsrecord")


def _run(coro):
    return asyncio.run(coro)


@pytest.fixture
def names():
    """Fresh namespaces, an empty pool before and after."""
    made = []

    def make():
        made.append(f"pool-{uuid.uuid4().hex}")
        return made[-1]

    memory.release_pool()
    yield make
    for ns in made:
        memory.reset_namespace(ns)
    memory.release_pool()


def _pool_counts():
    c = obs.counters()
    return c.get(obs.MEMORY_POOL_HIT_BYTES, 0), c.get(obs.MEMORY_POOL_MISS_BYTES, 0)


def _pooled():
    return [b for bufs in memory._FREE.values() for b in bufs]


def _in_pool(buf):
    return any(b is buf for b in _pooled())


def _nbytes(objs):
    return sum(memoryview(v).nbytes for v in objs)


def _state(seed, n=4096):
    g = torch.Generator().manual_seed(seed)
    return {
        "m": tts.StateDict(
            w=torch.randn(n, 64, generator=g),
            b=torch.randn(300, 40, generator=g).to(torch.bfloat16),
            ids=torch.randint(0, 1 << 30, (5000,), generator=g),
            step=seed,
        )
    }


def _restore_equals(ns, state):
    into = {"m": tts.StateDict(**{k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0
                                   for k, v in state["m"].items()})}
    tts.Snapshot(f"memory://{ns}").restore(into)
    for k, v in state["m"].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(into["m"][k], v), k
        else:
            assert into["m"][k] == v


@contextlib.contextmanager
def _layout(striped, native):
    with contextlib.ExitStack() as stack:
        if striped:
            stack.enter_context(knobs.override_stripe_part_size_bytes(64 << 10))
            stack.enter_context(knobs.override_stripe_min_object_size_bytes(128 << 10))
        stack.enter_context(knobs.override_enable_native_ext(native))
        yield


def _published_read_only(ns):
    for path, buf in memory._NAMESPACES[ns].items():
        assert isinstance(buf, np.ndarray) and not buf.flags.writeable, path
        with pytest.raises(ValueError):
            buf[:1] = 0


@pytest.mark.parametrize("native", [True, False], ids=["fused_digest", "plain_copy"])
@pytest.mark.parametrize("striped", [False, True], ids=["whole", "striped"])
@pytest.mark.parametrize("take", ["sync", "async"])
def test_take_loop_draws_from_the_pool_and_restores_bitwise(names, striped, native, take):
    spaces = (names(), names())
    committed = None
    with _layout(striped, native):
        for i in range(5):
            ns = spaces[i % 2]
            state = _state(seed=i)
            hit0, miss0 = _pool_counts()
            if take == "sync":
                tts.Snapshot.take(f"memory://{ns}", state)
            else:
                tts.Snapshot.async_take(f"memory://{ns}", state).wait()
            hit, miss = _pool_counts()
            hit, miss = hit - hit0, miss - miss0
            objs = memory._NAMESPACES[ns]
            assert hit + miss == _nbytes(objs.values())
            if i < 2:
                assert hit == 0
            else:
                # everything but the commit-time objects reuses a buffer
                assert miss <= _nbytes(objs[p] for p in VARYING if p in objs)
                assert hit >= _nbytes(v for p, v in objs.items() if p not in VARYING) > 0
            _published_read_only(ns)
            _restore_equals(ns, state)
            if committed is not None:
                memory.reset_namespace(committed)
            committed = ns
    # the kept snapshot was never written over by the later takes
    _restore_equals(committed, _state(seed=4))


@pytest.mark.parametrize("holder", ["read_view", "frombuffer", "link_from"])
def test_a_buffer_referenced_outside_the_store_is_never_recycled(names, holder):
    a, b, spaces = names(), names(), (names(), names())
    tts.Snapshot.take(f"memory://{a}", _state(seed=0))
    path, stored = max(memory._NAMESPACES[a].items(), key=lambda kv: memoryview(kv[1]).nbytes)
    expected = bytes(memoryview(stored))
    if holder == "link_from":
        _run(MemoryStoragePlugin(b).link_from(f"memory://{a}", path))
        held = memory._NAMESPACES[b][path]
        assert held is stored
    else:
        read_io = ReadIO(path=path)
        _run(MemoryStoragePlugin(a).read(read_io))
        held = read_io.buf
        if holder == "frombuffer":
            with pytest.warns(UserWarning):
                held = torch.frombuffer(held, dtype=torch.uint8)
    del stored
    memory.reset_namespace(a)
    for i in range(1, 5):
        # same sizes, other bytes
        tts.Snapshot.take(f"memory://{spaces[i % 2]}", _state(seed=i))
        memory.reset_namespace(spaces[(i + 1) % 2])
    if holder == "frombuffer":
        assert held.numpy().tobytes() == expected
    else:
        assert bytes(memoryview(held)) == expected
    obj = held if holder == "link_from" else None
    if holder == "read_view":
        obj = held.obj
    if obj is not None:
        assert not _in_pool(obj)
    if holder == "link_from":
        # once the last namespace lets go, nothing reaches it: pooled
        ref = weakref.ref(obj)
        del obj, held
        memory.reset_namespace(b)
        assert _in_pool(ref())


@pytest.mark.parametrize("path", ["whole", "striped", "overwritten"])
def test_recycled_buffers_are_published_read_only(names, path):
    ns = names()
    plugin = MemoryStoragePlugin(ns)
    payload = np.arange(4096, dtype=np.uint8)

    async def write(p, data):
        if path == "striped":
            h = await plugin.begin_striped_write(p, data.nbytes)
            await h.write_part(0, 0, data[:1000])
            await h.write_part(1, 1000, data[1000:])
            await h.complete()
        else:
            await plugin.write(WriteIO(path=p, buf=data))

    _run(write("x", payload))
    first = weakref.ref(memory._NAMESPACES[ns]["x"])
    if path == "overwritten":
        # an overwrite releases the object it replaces
        _run(write("x", payload[::-1].copy()))
    else:
        _run(plugin.delete("x"))
    assert _in_pool(first())
    hit0, _ = _pool_counts()
    _run(write("y", payload[::-1].copy()))
    assert _pool_counts()[0] - hit0 == payload.nbytes
    _published_read_only(ns)
    assert bytes(memoryview(memory._NAMESPACES[ns]["y"])) == payload[::-1].tobytes()


@pytest.mark.parametrize(
    "parts",
    [[(100, 300)], [(0, 100), (200, 300)], [(0, 150), (100, 200), (250, 300)]],
    ids=["head", "middle", "overlap_then_gap"],
)
def test_a_striped_write_with_a_hole_fails_and_publishes_nothing(names, parts):
    ns = names()
    plugin = MemoryStoragePlugin(ns)
    data = np.full(300, 7, dtype=np.uint8)

    async def go():
        h = await plugin.begin_striped_write("x", 300)
        for i, (lo, hi) in enumerate(parts):
            await h.write_part(i, lo, data[lo:hi])
        await h.complete()

    with pytest.raises(OSError, match="no part wrote byte"):
        _run(go())
    assert "x" not in memory._NAMESPACES[ns]
    # the buffer went back to the pool
    assert [b.nbytes for b in _pooled()] == [300]


def test_covering_parts_in_any_order_publish(names):
    ns = names()
    plugin = MemoryStoragePlugin(ns)
    data = np.random.default_rng(0).integers(0, 256, 300, dtype=np.uint8)

    async def go():
        h = await plugin.begin_striped_write("x", 300)
        for i, (lo, hi) in enumerate([(200, 300), (0, 120), (100, 200)]):
            await h.write_part(i, lo, data[lo:hi])
        await h.complete()

    _run(go())
    assert bytes(memoryview(memory._NAMESPACES[ns]["x"])) == data.tobytes()


@pytest.mark.parametrize("written", [0, 1, 2], ids=["no_part", "one_part", "all_parts"])
def test_an_aborted_striped_write_returns_its_buffer(names, written):
    ns = names()
    plugin = MemoryStoragePlugin(ns)
    data = np.ones(2048, dtype=np.uint8)

    async def go():
        h = await plugin.begin_striped_write("x", 2048)
        for i in range(written):
            await h.write_part(i, i * 1024, data[i * 1024 : (i + 1) * 1024])
        await h.abort()

    _run(go())
    assert "x" not in memory._NAMESPACES[ns]
    assert [b.nbytes for b in _pooled()] == [2048]
    hit0, _ = _pool_counts()
    _run(plugin.write(WriteIO(path="y", buf=data)))
    assert _pool_counts()[0] - hit0 == 2048


@pytest.mark.parametrize("new_size", [1000, 5000, 100000])
def test_a_miss_frees_pooled_bytes_first(names, new_size):
    ns = names()
    plugin = MemoryStoragePlugin(ns)
    peak = 0

    def live():
        return _nbytes(memory._NAMESPACES[ns].values())

    async def write(p, n):
        nonlocal peak
        await plugin.write(WriteIO(path=p, buf=np.zeros(n, dtype=np.uint8)))
        peak = max(peak, live())

    sizes = [4096, 4096, 8192, 30000, 60000]
    for i, n in enumerate(sizes):
        _run(write(f"a{i}", n))
    for i in range(len(sizes)):
        _run(plugin.delete(f"a{i}"))
    assert sum(b.nbytes for b in _pooled()) == sum(sizes) == peak
    _, miss0 = _pool_counts()
    _run(write("new", new_size))
    assert _pool_counts()[1] - miss0 == new_size
    assert live() + sum(b.nbytes for b in _pooled()) <= peak
    memory.release_pool()
    assert _pooled() == [] and memory._FREE == {}


@pytest.mark.parametrize("raw", ["bytes", "bytearray", "foreign_array"])
def test_objects_the_plugin_did_not_allocate_are_never_pooled(names, raw):
    ns = names()
    plugin = MemoryStoragePlugin(ns)
    make = {"bytes": lambda: b"r" * 4096, "bytearray": lambda: bytearray(4096),
            "foreign_array": lambda: np.zeros(4096, dtype=np.uint8)}[raw]
    plugin._store["a"] = make()
    plugin._store["b"] = make()
    plugin._store["c"] = make()
    _run(plugin.delete("a"))
    # an overwrite drops what it replaces
    _run(plugin.write(WriteIO(path="b", buf=np.zeros(10, dtype=np.uint8))))
    memory.reset_namespace(ns)
    assert [b.nbytes for b in _pooled()] == [10]
    _, miss0 = _pool_counts()
    _run(MemoryStoragePlugin(ns).write(WriteIO(path="d", buf=np.zeros(4096, dtype=np.uint8))))
    assert _pool_counts()[1] - miss0 == 4096


def test_threads_writing_and_deleting_never_share_a_buffer(names):
    """Twelve threads cycle writes, verified reads and deletes of a few
    sizes through one pool under a short switch interval."""
    spaces = [names() for _ in range(12)]
    errors = []

    def worker(idx):
        plugin = MemoryStoragePlugin(spaces[idx])

        async def cycle():
            for rnd in range(40):
                for j, n in enumerate((4096, 8192, 65536)):
                    data = np.full(n, (idx * 41 + rnd * 7 + j) % 251, dtype=np.uint8)
                    await plugin.write(WriteIO(path=f"o{j}", buf=data))
                for j, n in enumerate((4096, 8192, 65536)):
                    read_io = ReadIO(path=f"o{j}")
                    await plugin.read(read_io)
                    got = np.frombuffer(read_io.buf, dtype=np.uint8)
                    want = (idx * 41 + rnd * 7 + j) % 251
                    if got.nbytes != n or not (got == want).all():
                        errors.append((idx, rnd, j))
                    del got, read_io
                    await plugin.delete(f"o{j}")

        try:
            _run(cycle())
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(repr(e))

    hit0, _ = _pool_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(spaces))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert _pool_counts()[0] > hit0
