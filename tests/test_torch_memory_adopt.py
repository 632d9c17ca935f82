"""The memory plugin's adoption of the take's private staged buffers
(``torchsnapshot_tpu_torch/storage/memory.py``, ``WriteIO.owned``).

An owned write publishes the caller's buffer itself, digested in place
(whole, or by stripe parts) to what ``copy_digest`` gives; a buffer
that is not owned is still copied; an adopted object never enters the
pool, is never handed to a later write and is freed once it leaves the
store; ``storage.memory.adopted_bytes`` counts exactly the adopted
bytes; a snapshot taken through the scheduler with a stager that marks
its buffers private restores bitwise and deep-verifies.
"""

import asyncio
import contextlib
import gc
import uuid
import weakref

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import knobs, obs
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.preparers import array as array_prep
from torchsnapshot_tpu_torch.preparers import sharded as sharded_prep
from torchsnapshot_tpu_torch.storage import memory, stripe
from torchsnapshot_tpu_torch.storage.memory import MemoryStoragePlugin
from torchsnapshot_tpu_torch.utils.checksums import copy_digest

PART = 64 << 10
# whole: below the stripe threshold; striped: five parts, the last short
SIZES = {"whole": 100_003, "striped": 4 * PART + 12_345}


@pytest.fixture
def ns():
    """A fresh namespace, an empty pool before and after."""
    name = f"adopt-{uuid.uuid4().hex}"
    memory.release_pool()
    yield name
    memory.reset_namespace(name)
    memory.release_pool()


@contextlib.contextmanager
def _striping():
    with knobs.override_stripe_part_size_bytes(PART), knobs.override_stripe_min_object_size_bytes(2 * PART):
        yield


def _adopted():
    return obs.counters().get(obs.MEMORY_ADOPTED_BYTES, 0)


def _copy_clocks():
    return obs.histogram(obs.WRITE_COPY_S).count


def _pooled():
    return [b for bufs in memory._FREE.values() for b in bufs]


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _write(plugin, path, buf, owned, want_digest=True):
    wio = WriteIO(path=path, buf=memoryview(buf), want_digest=want_digest, owned=owned)
    asyncio.run(plugin.write(wio))
    return wio


@pytest.mark.parametrize("want_digest", [True, False], ids=["digest", "no_digest"])
@pytest.mark.parametrize("layout", ["whole", "striped"])
def test_owned_write_publishes_the_buffer_itself(ns, layout, want_digest):
    n = SIZES[layout]
    src = _bytes(n, 1)
    plugin = MemoryStoragePlugin(ns)
    with _striping():
        parts = len(stripe.plan_parts(n)) if stripe.write_eligible(n, plugin) else 1
        adopted, clocks, misses = _adopted(), _copy_clocks(), obs.counters().get(obs.MEMORY_POOL_MISS_BYTES, 0)
        wio = _write(plugin, "obj", src, owned=True, want_digest=want_digest)
    stored = memory._NAMESPACES[ns]["obj"]
    assert np.shares_memory(stored, src) and stored.nbytes == n
    assert not stored.flags.writeable
    with pytest.raises(ValueError):
        stored[:1] = 0
    assert _adopted() - adopted == n
    # no draw from the pool, and one digest-only pass a stripe part
    assert obs.counters().get(obs.MEMORY_POOL_MISS_BYTES, 0) == misses
    if want_digest:
        assert wio.digests == copy_digest(np.empty(n, dtype=np.uint8), src)
        assert _copy_clocks() - clocks == parts
    else:
        assert wio.digests is None and _copy_clocks() == clocks
    assert (layout == "striped") == (parts > 1)


@pytest.mark.parametrize("layout", ["whole", "striped"])
def test_a_buffer_not_owned_is_copied(ns, layout):
    n = SIZES[layout]
    src = _bytes(n, 2)
    want = src.copy()
    plugin = MemoryStoragePlugin(ns)
    adopted = _adopted()
    with _striping():
        if layout == "striped":
            d = asyncio.run(stripe.striped_write(plugin, "obj", memoryview(src), want_digests=True))
            digests = d[:2]
        else:
            digests = _write(plugin, "obj", src, owned=False).digests
    src[:] = 7  # the caller writes its buffer again
    stored = memory._NAMESPACES[ns]["obj"]
    assert not np.shares_memory(stored, src)
    assert np.array_equal(stored, want)
    assert _adopted() == adopted
    assert tuple(digests) == copy_digest(np.empty(n, dtype=np.uint8), want)


@pytest.mark.parametrize("reader", [False, True], ids=["no_reader", "reader_view"])
@pytest.mark.parametrize("leave", ["delete", "overwrite", "reset_namespace"])
def test_an_adopted_object_is_never_pooled_or_reused(ns, leave, reader):
    n = SIZES["whole"]
    owner = _bytes(n, 3)  # the staging buffer
    want = owner.copy()
    alive = weakref.ref(owner)
    plugin = MemoryStoragePlugin(ns)
    _write(plugin, "obj", owner, owned=True)
    view = None
    if reader:
        rio = ReadIO(path="obj")
        asyncio.run(plugin.read(rio))
        view = np.frombuffer(rio.buf, dtype=np.uint8)
    del owner
    gc.collect()
    assert alive() is not None  # the store holds it
    if leave == "delete":
        asyncio.run(plugin.delete("obj"))
    elif leave == "overwrite":
        _write(plugin, "obj", _bytes(n, 4), owned=False)
    else:
        memory.reset_namespace(ns)
    gc.collect()
    assert not _pooled()
    # freed once the store and its last reader let go, never pooled
    assert (alive() is not None) == reader
    # a later write of that size draws a buffer of its own
    plugin = MemoryStoragePlugin(ns)
    for i in range(2):
        _write(plugin, f"next{i}", _bytes(n, 5 + i), owned=False)
        assert memory._NAMESPACES[ns][f"next{i}"].nbytes == n
    if reader:
        assert all(not np.shares_memory(b, view) for b in memory._NAMESPACES[ns].values())
        assert np.array_equal(view, want)
        del view, rio
        gc.collect()
        assert alive() is None and not _pooled()


def test_adopted_bytes_count_only_owned_writes(ns):
    plugin = MemoryStoragePlugin(ns)
    sizes = {"a": 10, "b": 0, "c": SIZES["whole"], "d": SIZES["striped"]}
    adopted = _adopted()
    with _striping():
        for i, (path, size) in enumerate(sizes.items()):
            _write(plugin, path, _bytes(size, 10 + i), owned=True)
            _write(plugin, f"{path}.copy", _bytes(size, 20 + i), owned=False)
    assert _adopted() - adopted == sum(sizes.values())


class _PrivateCopyStager(array_prep.HostArrayBufferStager):
    """Stages a host array as a private copy of its own and says so, as
    the CUDA stagers do for their pinned copies.  After an async take's
    offload it has a part plan, as an offloaded CUDA leaf has."""

    stages_private_buffer = True

    def __init__(self, arr, defensive_copy=False):
        super().__init__(arr, defensive_copy=True)


def _private_stager_for(obj, is_async=False):
    stager = _PrivateCopyStager(obj)
    stager.codec_filter_stride = 0
    return stager


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "big": torch.randn(300, 257, generator=g),  # 308,400 B: striped size
        "mid": torch.randn(100, 50, generator=g).to(torch.bfloat16),  # whole
        "ids": torch.randint(0, 1 << 30, (2000,), generator=g),  # whole
        # slab members: the slab is copied
        "tiny": torch.randn(10, generator=g),
        "tiny2": torch.randint(0, 9, (7,), generator=g, dtype=torch.int16),
    }


@pytest.mark.parametrize("take", ["sync", "async"])
def test_take_with_private_stagers_adopts_and_restores_bitwise(ns, monkeypatch, take):
    monkeypatch.setattr(array_prep, "_stager_for", _private_stager_for)
    monkeypatch.setattr(sharded_prep, "_stager_for", _private_stager_for)
    want = _state(7)
    url = f"memory://{ns}"
    adopted, copies = _adopted(), obs.counters().get(obs.MEMORY_POOL_MISS_BYTES, 0)
    stripes = obs.counters().get(obs.STRIPE_WRITES, 0)
    with _striping(), knobs.override_slab_size_threshold_bytes(3000):
        app = {"app": tts.StateDict({k: v.clone() for k, v in want.items()}, step=3)}
        if take == "sync":
            tts.Snapshot.take(url, app)
        else:
            tts.Snapshot.async_take(url, app).wait()
        # the striped-size object was adopted whole
        assert obs.counters().get(obs.STRIPE_WRITES, 0) == stripes
        dest = {"app": tts.StateDict({k: torch.zeros_like(v) for k, v in want.items()}, step=0)}
        tts.Snapshot(url).restore(dest)
    whole = sum(v.numel() * v.element_size() for k, v in want.items() if not k.startswith("tiny"))
    assert _adopted() - adopted == whole
    # the slab and the metadata were drawn and copied
    assert obs.counters().get(obs.MEMORY_POOL_MISS_BYTES, 0) > copies
    for k, v in want.items():
        assert torch.equal(dest["app"][k], v), k
    assert dest["app"]["step"] == 3
    for path, buf in memory._NAMESPACES[ns].items():
        assert isinstance(buf, np.ndarray) and not buf.flags.writeable, path
    assert tts.verify_snapshot(url, deep=True).ok
