"""Runs with the timed path broken underneath: each fault a cell can
have has to make ``correct`` come out false.  (One chip: no exchange
between chips to leave out.)"""

import json
import zlib

import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.storage.memory import MemoryStoragePlugin

from portbench.reference.reader import CRC_MARKER, METADATA, metadata_document
from portbench.tests.tiny import run_tiny


class _LazyPending:
    """An async take that returns at once and stages the live state at
    wait(): after the next step has changed it."""

    def __init__(self, take, path, app_state):
        self._take, self._path, self._app_state = take, path, app_state

    def wait(self):
        return self._take(self._path, self._app_state)


def _stale_take(monkeypatch):
    take = tts.Snapshot.take
    monkeypatch.setattr(tts.Snapshot, "async_take",
                        classmethod(lambda cls, path, app_state, **kw: _LazyPending(take, path, app_state)))


def _half_take(monkeypatch):
    real = tts.Snapshot.async_take.__func__
    monkeypatch.setattr(tts.Snapshot, "async_take", classmethod(
        lambda cls, path, app_state, **kw: real(cls, path, {k: v for k, v in app_state.items() if k != "optim"})))


def _altered_write(monkeypatch):
    real = MemoryStoragePlugin.write

    async def write(self, write_io):
        if not write_io.path.startswith(".snapshot"):
            buf = bytearray(memoryview(write_io.buf).cast("B"))
            buf[len(buf) // 2] ^= 0x40
            write_io.buf = memoryview(buf)
        return await real(self, write_io)

    monkeypatch.setattr(MemoryStoragePlugin, "write", write)


def _no_digests(monkeypatch):
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_TORCH_WRITE_CHECKSUMS", "0")


def _wrong_digest(monkeypatch):
    """One stored object's crc32 in the metadata's digest table is off by
    one; the metadata's own trailer still holds."""
    real = MemoryStoragePlugin.write

    async def write(self, write_io):
        if write_io.path == METADATA:
            doc = metadata_document(bytes(memoryview(write_io.buf).cast("B")))
            location = sorted(doc["objects"])[0]
            doc["objects"][location][0] ^= 1
            body = json.dumps(doc)
            write_io.buf = memoryview(f"{body}{CRC_MARKER}{zlib.crc32(body.encode()):08x}".encode())
        return await real(self, write_io)

    monkeypatch.setattr(MemoryStoragePlugin, "write", write)


def _unchanged_restore(monkeypatch):
    monkeypatch.setattr(tts.Snapshot, "restore", lambda self, app_state, **kw: None)


def _half_restore(monkeypatch):
    real = tts.Snapshot.restore
    monkeypatch.setattr(tts.Snapshot, "restore",
                        lambda self, app_state, **kw: real(self, app_state, paths=["model/**", "progress/**"]))


def _altered_restore(monkeypatch):
    real = tts.Snapshot.restore

    def restore(self, app_state, **kw):
        real(self, app_state, **kw)
        with torch.no_grad():
            next(app_state["model"].parameters()).view(-1)[0] += 1

    monkeypatch.setattr(tts.Snapshot, "restore", restore)


def _unchanged_read(monkeypatch):
    monkeypatch.setattr(tts.Snapshot, "read_object", lambda self, path, obj_out=None, **kw: obj_out)


def _half_read(monkeypatch):
    real = tts.Snapshot.read_object

    def read(self, path, obj_out=None, **kw):
        out = real(self, path, obj_out=obj_out, **kw)
        flat = out.view(-1)
        flat[flat.numel() // 2:] = 12345.0
        return out

    monkeypatch.setattr(tts.Snapshot, "read_object", read)


def _altered_read(monkeypatch):
    real = tts.Snapshot.read_object

    def read(self, path, obj_out=None, **kw):
        out = real(self, path, obj_out=obj_out, **kw)
        out.view(-1)[-1] += 1
        return out

    monkeypatch.setattr(tts.Snapshot, "read_object", read)


FAULTS = {
    "deepseek_llm_7b.take": [_stale_take, _half_take, _altered_write, _no_digests, _wrong_digest],
    "dlrm_criteo_tb.take": [_stale_take, _half_take, _altered_write, _no_digests, _wrong_digest],
    "deepseek_llm_7b.restore": [_unchanged_restore, _half_restore, _altered_restore],
    "deepseek_llm_7b.read": [_unchanged_read, _half_read, _altered_read],
}


@pytest.mark.parametrize(
    "name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs], ids=lambda x: getattr(x, "__name__", x)
)
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    result = run_tiny(name)
    assert result["correct"] is False, result["checks"]
    if fault in (_no_digests, _wrong_digest):
        # the stored values are right: only the digests fail
        assert result["checks"]["mismatched_elements"]["value"] == 0
        assert result["checks"]["bad_digests"]["value"] > 0
