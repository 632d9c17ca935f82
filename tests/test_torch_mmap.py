"""Zero-copy mapped reads on the port's restore path (``MMAP``, default
1), against the JAX package's.

``mmap_read`` refuses a read past the file's end with EIO before any map,
maps nothing for a zero-length read and keeps the ``storage.mmap.*``
counters.  A default restore on fs serves its raw reads that have no
buffer of their own as private maps, and the consumers build tensors
over the mapped pages with no host copy; its ``storage.mmap.reads`` is
the JAX package's for the same restore.  Frames, chunks and ranged
reads that must land in a consumer's own buffer never map; a buffer a
consumer merely offers leaves a mapped read mapped; ``MMAP=0`` copies; a written
``materialize(device="cpu")`` leaf leaves the file unchanged; a plugin
that declines the map is debited its cost.
"""

import errno
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu import obs as jobs
from torchsnapshot_tpu.storage import fs as jfs
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import obs as tobs
from torchsnapshot_tpu_torch import scheduler as tscheduler
from torchsnapshot_tpu_torch.io_types import BufferConsumer, ReadReq, is_mmap_backed
from torchsnapshot_tpu_torch.preparers import array as tarray
from torchsnapshot_tpu_torch.storage import fs as tfs


def _state(seed):
    rng = np.random.default_rng(seed)
    return {
        "big": rng.standard_normal(50000).astype(np.float32),  # an object of its own
        "w": rng.standard_normal((32, 16)).astype(np.float32),
        "h": rng.standard_normal(300).astype(np.float16),
        "i": rng.integers(-9, 9, 77).astype(np.int32),
    }


def _take(path, state, **kw):
    with tknobs.override_slab_size_threshold_bytes(64 << 10):
        tts.Snapshot.take(path, {"app": tts.StateDict({k: torch.from_numpy(v.copy()) for k, v in state.items()})}, **kw)


def _zeros(state):
    return tts.StateDict({k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in state.items()})


def _mmap_reads():
    return tobs.counters().get(tobs.MMAP_READS, 0)


def test_mmap_read_extent_zero_length_and_counters(tmp_path):
    f = str(tmp_path / "obj")
    data = np.random.default_rng(1).integers(0, 256, 10000, dtype=np.uint8)
    data.tofile(f)
    for rng in ([9000, 10001], [0, 10001], [10001, 10001]):
        with pytest.raises(OSError) as e:
            tfs.mmap_read(f, rng)
        assert e.value.errno == errno.EIO
        with pytest.raises(OSError) as je:
            jfs.mmap_read(f, rng)
        assert je.value.errno == errno.EIO
    c0 = dict(tobs.counters())
    empty = tfs.mmap_read(f, [500, 500])
    assert empty.nbytes == 0 and tobs.counters() == c0
    for rng in (None, [0, 4096], [4097, 9999], [123, 124]):
        got = tfs.mmap_read(f, rng)
        want = jfs.mmap_read(f, rng)
        assert is_mmap_backed(got) and got.tobytes() == want.tobytes()
    c1 = tobs.counters()
    assert c1[tobs.MMAP_READS] - c0.get(tobs.MMAP_READS, 0) == 4
    assert c1[tobs.MMAP_BYTES_MAPPED] - c0.get(tobs.MMAP_BYTES_MAPPED, 0) == 10000 + 4096 + 5902 + 1
    # the plugin's read under the knob, through its retry and failpoint
    plugin = tfs.FSStoragePlugin(str(tmp_path))
    try:
        from torchsnapshot_tpu_torch.io_types import ReadIO

        rio = ReadIO(path="obj", byte_range=[10, 20], want_mmap=True)
        plugin.sync_read(rio)
        assert is_mmap_backed(rio.buf) and rio.buf.tobytes() == data[10:20].tobytes()
        with tknobs.override_mmap(False):
            rio = ReadIO(path="obj", byte_range=[10, 20], want_mmap=True)
            plugin.sync_read(rio)
            assert not is_mmap_backed(rio.buf) and rio.buf.tobytes() == data[10:20].tobytes()
        with tknobs.override_failpoints("storage.fs.read=eintr::1"):
            rio = ReadIO(path="obj", want_mmap=True)
            plugin.sync_read(rio)
        assert is_mmap_backed(rio.buf) and rio.buf.tobytes() == data.tobytes()
    finally:
        plugin.sync_close()


def test_default_restore_maps_and_copies_nothing_on_the_host(tmp_path, monkeypatch):
    """Every raw read is mapped, every tensor a consumer builds lies
    inside a mapping (no ``bytearray`` or clone between the map and
    ``torch.frombuffer``), and the restore is bitwise."""
    state = _state(2)
    path = str(tmp_path / "s")
    _take(path, state)
    built = []
    real = tarray.tensor_from_buffer

    def spy(buf, dtype, shape):
        t = real(buf, dtype, shape)
        built.append((is_mmap_backed(buf), is_mmap_backed(t)))
        return t

    monkeypatch.setattr(tarray, "tensor_from_buffer", spy)
    c0 = _mmap_reads()
    dest = _zeros(state)
    tts.Snapshot(path).restore({"app": dest}, device="cpu")
    for k, v in state.items():
        assert dest[k].numpy().tobytes() == v.tobytes(), k
    assert _mmap_reads() - c0 == 2  # the large object and the slab
    # slab members at aligned offsets stay over the map; none is copied
    assert built and all(m for m, _ in built)
    assert sum(t for _, t in built) >= len(state) - 1
    # under VERIFY_ON_RESTORE the digests are taken through the map
    with tknobs.override_verify_on_restore(True):
        tts.Snapshot(path).restore({"app": _zeros(state)}, device="cpu")


def test_mmap_reads_equal_the_jax_package_count_for_the_same_restore(tmp_path):
    state = _state(3)
    path = str(tmp_path / "s")
    with jknobs.override_slab_size_threshold_bytes(64 << 10):
        jts.Snapshot.take(path, {"app": jts.StateDict(dict(state))})
    j0 = jobs.counter(jobs.MMAP_READS).value
    jdest = jts.StateDict({k: jnp.zeros(v.shape, v.dtype) for k, v in state.items()})
    jts.Snapshot(path).restore({"app": jdest})
    jax_reads = jobs.counter(jobs.MMAP_READS).value - j0
    c0 = _mmap_reads()
    dest = _zeros(state)
    tts.Snapshot(path).restore({"app": dest}, device="cpu")
    assert _mmap_reads() - c0 == jax_reads > 0
    for k, v in state.items():
        assert dest[k].numpy().tobytes() == v.tobytes() == np.asarray(jdest[k]).tobytes()


class _OwnBuffer(BufferConsumer):
    """A consumer with a buffer of its own, as the pinned tiles have."""

    def __init__(self, n):
        self.into = np.empty(n, np.uint8)
        self.got = None

    def read_buffer(self, nbytes):
        return self.into

    def provides_read_buffer(self):
        return True

    async def consume_buffer(self, buf, executor=None):
        self.got = buf

    def get_consuming_cost_bytes(self):
        return self.into.nbytes


def test_frames_chunks_and_own_buffer_reads_never_map(tmp_path):
    state = _state(4)
    with tknobs.override_codec("zlib"):
        _take(str(tmp_path / "z"), state)
    _take(str(tmp_path / "run" / "c"), state, cas=True)
    for path in (str(tmp_path / "z"), str(tmp_path / "run" / "c")):
        c0 = _mmap_reads()
        dest = _zeros(state)
        tts.Snapshot(path).restore({"app": dest}, device="cpu")
        tts.Snapshot(path).read_object("0/app/big", memory_budget_bytes=4096, device="cpu")
        assert _mmap_reads() == c0, path
        assert dest["big"].numpy().tobytes() == state["big"].tobytes()
    _take(str(tmp_path / "p"), state)
    loc = tts.Snapshot(str(tmp_path / "p")).metadata.manifest["0/app/big"].location
    consumer = _OwnBuffer(1000)
    storage = tfs.FSStoragePlugin(str(tmp_path / "p"))
    c0 = _mmap_reads()
    try:
        tscheduler.sync_execute_read_reqs(
            [ReadReq(path=loc, buffer_consumer=consumer, byte_range=[40, 1040])], storage, 1 << 20, 0
        )
    finally:
        storage.sync_close()
    assert consumer.got is consumer.into and _mmap_reads() == c0
    assert consumer.into.tobytes() == state["big"].view(np.uint8)[40:1040].tobytes()


def test_mmap_off_takes_the_copying_path(tmp_path):
    state = _state(5)
    path = str(tmp_path / "s")
    _take(path, state)
    c0 = _mmap_reads()
    with tknobs.override_mmap(False):
        dest = _zeros(state)
        tts.Snapshot(path).restore({"app": dest}, device="cpu")
        mat = tts.Snapshot(path).materialize(device="cpu")["app"]
    assert _mmap_reads() == c0
    assert not any(is_mmap_backed(t) for t in mat.values())
    for k, v in state.items():
        assert dest[k].numpy().tobytes() == mat[k].numpy().tobytes() == v.tobytes()


def test_a_written_materialized_leaf_leaves_the_file_unchanged(tmp_path):
    state = _state(6)
    path = str(tmp_path / "s")
    _take(path, state)
    snap = tts.Snapshot(path)
    loc = snap.metadata.manifest["0/app/big"].location
    before = open(os.path.join(path, loc), "rb").read()
    mat = snap.materialize(device="cpu")["app"]
    assert is_mmap_backed(mat["big"])  # a view of the map, not a copy
    mat["big"].fill_(7.0)
    mat["w"].zero_()
    assert open(os.path.join(path, loc), "rb").read() == before
    again = tts.Snapshot(path).materialize(device="cpu")["app"]
    for k, v in state.items():
        assert again[k].numpy().tobytes() == v.tobytes()
    assert tts.verify_snapshot(path, deep=True).ok


class _Declining(tfs.FSStoragePlugin):
    """Exempt like fs, but serves every read as a heap copy."""

    async def read(self, read_io):
        read_io.want_mmap = False
        await super().read(read_io)


def test_a_declined_map_is_debited_its_cost(tmp_path, monkeypatch):
    state = _state(7)
    path = str(tmp_path / "s")
    _take(path, state)
    seen = []

    class Budget(tscheduler._Budget):
        def __setattr__(self, name, value):
            if name == "used":
                seen.append(value)
            super().__setattr__(name, value)

    monkeypatch.setattr(tscheduler, "_Budget", Budget)
    snap = tts.Snapshot(path)
    for plugin, debited in ((tfs.FSStoragePlugin, False), (_Declining, True)):
        seen.clear()
        monkeypatch.setattr(tts.snapshot, "url_to_storage_plugin", lambda p, *a, plugin=plugin: plugin(p))
        dest = _zeros(state)
        snap.restore({"app": dest}, device="cpu")
        assert (max(seen) > 0) == debited and seen[-1] == 0
        for k, v in state.items():
            assert dest[k].numpy().tobytes() == v.tobytes()
    assert max(seen) >= state["big"].nbytes


class _Offers(_OwnBuffer):
    """Offers a buffer of its own without asking never to be mapped, as a
    consumer bound for the card does."""

    def provides_read_buffer(self):
        return False


@pytest.mark.parametrize("consumer,ranged", [(_OwnBuffer, False), (_Offers, False), (_Offers, True)],
                         ids=["whole_own", "whole_offered", "ranged_offered"])
def test_an_offered_buffer_leaves_mapped_reads_mapped(tmp_path, consumer, ranged):
    """With MMAP on, a whole-object fs read whose consumer offers a buffer
    of its own, and a ranged one whose consumer only offers, are served
    mapped as before: the offer is never asked for."""
    state = _state(6)
    _take(str(tmp_path / "p"), state)
    loc = tts.Snapshot(str(tmp_path / "p")).metadata.manifest["0/app/big"].location
    byte_range = [40, 1040] if ranged else None
    want = state["big"].view(np.uint8)
    want = want[40:1040] if ranged else want
    c = consumer(want.nbytes)
    asked = []
    c.read_buffer = lambda n: asked.append(n) or c.into
    storage = tfs.FSStoragePlugin(str(tmp_path / "p"))
    c0 = _mmap_reads()
    try:
        tscheduler.sync_execute_read_reqs(
            [ReadReq(path=loc, buffer_consumer=c, byte_range=byte_range)], storage, 1 << 20, 0
        )
    finally:
        storage.sync_close()
    assert _mmap_reads() == c0 + 1 and not asked
    assert c.got is not c.into and is_mmap_backed(c.got)
    assert bytes(memoryview(c.got).cast("B")) == want.tobytes()
