"""In-memory storage plugin (``memory://<namespace>``), for tests.

Counterpart of ``torchsnapshot_tpu/storage/memory.py``: a process-wide
dict of namespaces, each a dict of objects.  Writes, reads and part
writes evaluate the failpoints ``storage.memory.write``,
``storage.memory.read`` and ``storage.memory.part.write`` under the
shared retry policy (only when the registry is armed).  A write with
``want_digest`` copies and digests in one native pass; the striped
handle writes parts into one preallocated buffer and publishes it,
read-only, on ``complete``.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Dict

import numpy as np

from .. import _csrc, obs
from ..io_types import ReadIO, StoragePlugin, StripedWriteHandle, WriteIO
from ..resilience import classify_generic, lazy_shared_progress, retry_call
from ..resilience.failpoints import active as _failpoints_active
from ..resilience.failpoints import failpoint
from ..utils.checksums import copy_digest

_NAMESPACES: Dict[str, Dict[str, object]] = {}
_LOCK = threading.Lock()


def reset_namespace(namespace: str) -> None:
    with _LOCK:
        _NAMESPACES.pop(namespace, None)


async def _injected(plugin: "MemoryStoragePlugin", site: str, op_name: str, **attrs) -> None:
    """The failpoint at ``site`` under the retry policy, when armed."""
    if _failpoints_active():
        await retry_call(
            lambda: failpoint(site, **attrs), op_name=op_name, backend="memory",
            classify=classify_generic, progress=lazy_shared_progress(plugin, "memory"),
        )


@obs.instrument_storage("memory")
class MemoryStoragePlugin(StoragePlugin):
    def __init__(self, namespace: str) -> None:
        self.namespace = namespace
        with _LOCK:
            self._store = _NAMESPACES.setdefault(namespace, {})
        # a copy fused with its digest needs the native library
        self.supports_fused_digest = _csrc.enabled_lib() is not None
        self.supports_fused_part_digest = self.supports_fused_digest

    async def write(self, write_io: WriteIO) -> None:
        await _injected(self, "storage.memory.write", f"write {write_io.path}", path=write_io.path)
        src = memoryview(write_io.buf).cast("B")
        if write_io.want_digest and self.supports_fused_digest:
            with obs.clocked(obs.WRITE_ALLOC_S, "write/alloc"):
                dst = bytearray(src.nbytes)
            with obs.clocked(obs.WRITE_COPY_S, "write/copy"):
                write_io.digests = copy_digest(dst, src)
            self._store[write_io.path] = dst
            return
        with obs.clocked(obs.WRITE_COPY_S, "write/copy"):
            self._store[write_io.path] = bytes(src)

    async def read(self, read_io: ReadIO) -> None:
        await _injected(self, "storage.memory.read", f"read {read_io.path}", path=read_io.path)
        try:
            data = self._store[read_io.path]
        except KeyError:
            raise FileNotFoundError(f"memory://{self.namespace}/{read_io.path}") from None
        view = memoryview(data).cast("B")
        if read_io.byte_range is None:
            # read-only: a consumer must not change the stored object
            read_io.buf = view.toreadonly()
            return
        start, end = read_io.byte_range
        into = read_io.into
        if into is not None:
            try:
                dst = memoryview(into).cast("B")
            except (TypeError, ValueError):
                dst = None
            if dst is not None and not dst.readonly and dst.nbytes == end - start:
                # a GIL-free block copy on the pool: striped reads
                # assemble their parts concurrently
                await asyncio.get_running_loop().run_in_executor(
                    None, np.copyto, np.frombuffer(dst, dtype=np.uint8),
                    np.frombuffer(view[start:end], dtype=np.uint8),
                )
                read_io.buf = into
                return
        read_io.buf = bytes(view[start:end])

    async def link_from(self, base_url: str, path: str) -> None:
        # the namespace is the whole path after the scheme
        base_ns = base_url.split("://", 1)[-1]
        with _LOCK:
            src_store = _NAMESPACES.setdefault(base_ns, {})
        try:
            src = src_store[path]
        except KeyError:
            raise FileNotFoundError(f"{base_url}/{path}") from None
        # no two namespaces share a mutable buffer
        self._store[path] = bytes(src) if isinstance(src, bytearray) else src

    async def stat(self, path: str) -> int:
        try:
            return memoryview(self._store[path]).nbytes
        except KeyError:
            raise FileNotFoundError(f"memory://{self.namespace}/{path}") from None

    async def delete(self, path: str) -> None:
        try:
            del self._store[path]
        except KeyError:
            raise FileNotFoundError(f"memory://{self.namespace}/{path}") from None

    # ------------------------------------------------- striped writes

    supports_striped_write = True

    async def begin_striped_write(self, path: str, total_size: int) -> "_MemoryStripedWriteHandle":
        return _MemoryStripedWriteHandle(self, path, total_size)


class _MemoryStripedWriteHandle(StripedWriteHandle):
    """Ranged copies into one preallocated buffer (on the default pool,
    GIL-free, so parts run in parallel), published whole and read-only
    on ``complete``."""

    def __init__(self, plugin: MemoryStoragePlugin, path: str, total: int) -> None:
        self._plugin = plugin
        self._path = path
        with obs.clocked(obs.WRITE_ALLOC_S, "write/alloc"):
            self._buf = np.empty(total, dtype=np.uint8)
        # ``total`` bounds encoded parts from above; complete() publishes
        # up to the highest byte written
        self._hwm = 0
        self.supports_fused_digest = plugin.supports_fused_digest

    async def write_part(self, index: int, offset: int, buf, want_digest: bool = False):
        await _injected(
            self._plugin, "storage.memory.part.write", f"write {self._path} [part {index}]",
            path=self._path, part=index,
        )
        src = np.frombuffer(memoryview(buf).cast("B"), dtype=np.uint8)
        dst = self._buf[offset : offset + src.nbytes]
        self._hwm = max(self._hwm, offset + src.nbytes)

        def copy():
            with obs.clocked(obs.WRITE_COPY_S, "write/copy"):
                if want_digest and self.supports_fused_digest:
                    return copy_digest(dst, src)
                np.copyto(dst, src)
                return None

        return await asyncio.get_running_loop().run_in_executor(None, copy)

    async def complete(self) -> None:
        buf = self._buf
        if self._hwm < buf.nbytes:
            with obs.clocked(obs.WRITE_COPY_S, "write/copy"):
                buf = buf[: self._hwm].copy()
        buf.setflags(write=False)
        self._plugin._store[self._path] = buf
        self._buf = None

    async def abort(self) -> None:
        self._buf = None
