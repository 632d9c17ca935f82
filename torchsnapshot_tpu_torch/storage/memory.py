"""In-memory storage plugin (``memory://<namespace>``), for tests.

Counterpart of ``torchsnapshot_tpu/storage/memory.py``: a process-wide
dict of namespaces, each a dict of objects.  Writes, reads and part
writes evaluate the failpoints ``storage.memory.write``,
``storage.memory.read`` and ``storage.memory.part.write`` under the
shared retry policy (only when the registry is armed).  A read given an
``into`` buffer of its length, whole or ranged, is copied there off the
event loop; a whole read without one is a read-only view of the
object.  A write with ``want_digest`` copies and digests in one native
pass; the striped handle writes parts into one preallocated buffer and
publishes it on ``complete``, which fails when the parts left a hole.
Every stored object the plugin writes is a ``uint8`` array, published
read-only.

A write marked ``owned`` (``WriteIO.owned``: the take's private staged
copy, which nothing else refers to or will write; a CUDA tensor's
pinned D2H copy or a slab K1 packed) is adopted: the staged buffer
itself becomes the stored object, with no draw and no copy, and with
``want_digest`` its (crc32, adler32) come from a digest-only pass over
the bytes where they lie, by stripe parts on the default pool for an
object at the stripe threshold.  The scheduler writes such an object
whole, never through the striped handle or part by part.  An adopted
object holds its pinned block of torch's caching host allocator (a
power of two at or above its size) until it leaves the store and its
last reader lets go; the block then goes back to torch's cache, never
to this module's free list.  ``storage.memory.adopted_bytes`` counts
the bytes adopted.

Destination buffers are recycled.  An object that leaves the store
(``delete``, ``reset_namespace``, an overwrite, an aborted or failed
striped write) goes to a free list keyed by its exact size when the
plugin allocated it and nothing outside the store still refers to it:
no read's zero-copy view, no ``link_from`` copy in another namespace,
no tensor over it.  A later write of that size draws it back instead
of faulting in fresh pages, and overwrites all of it.  On a miss the
pool first frees, smallest first, at least as many bytes as the write
needs, so live plus pooled bytes never exceed the most the plugin held
live at once.  ``storage.memory.pool_hit_bytes`` and
``storage.memory.pool_miss_bytes`` count each draw; ``release_pool``
drops every pooled buffer.
"""

from __future__ import annotations

import asyncio
import sys
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import _csrc, obs
from ..io_types import ReadIO, StoragePlugin, StripedWriteHandle, WriteIO
from ..resilience import classify_generic, lazy_shared_progress, retry_call
from ..resilience.failpoints import active as _failpoints_active
from ..resilience.failpoints import failpoint
from ..utils.checksums import combine_piece_digests, copy_digest, digest
from . import stripe

_NAMESPACES: Dict[str, Dict[str, object]] = {}
_LOCK = threading.Lock()
# released buffers by exact size (under _LOCK)
_FREE: Dict[int, List[np.ndarray]] = {}
# the buffers this module allocated, by id, while they live
_OWNED: Dict[int, "weakref.ref[np.ndarray]"] = {}


def _sole_refs() -> int:
    """What ``sys.getrefcount`` reads inside ``_release`` for a buffer
    its caller holds in one local variable, and nothing else holds."""
    seen = []

    def probe(buf) -> None:
        seen.append(sys.getrefcount(buf))

    buf = bytearray(1)
    probe(buf)
    return seen[0]


_SOLE_REFS = _sole_refs()


def _draw(nbytes: int) -> np.ndarray:
    """A writable ``uint8`` buffer of ``nbytes`` with unspecified
    contents: a released one of that size, or a new one once pooled
    buffers holding at least ``nbytes`` are freed, smallest first."""
    evicted: List[np.ndarray] = []
    with _LOCK:
        free = _FREE.get(nbytes)
        if free:
            buf = free.pop()
            if not free:
                del _FREE[nbytes]
        else:
            buf, freed = None, 0
            for size in sorted(_FREE):
                free = _FREE[size]
                while free and freed < nbytes:
                    evicted.append(free.pop())
                    freed += size
                if free:
                    break
                del _FREE[size]
    if buf is not None:
        buf.setflags(write=True)
        obs.counter(obs.MEMORY_POOL_HIT_BYTES).inc(nbytes)
        return buf
    # freed before the new buffer is mapped
    evicted.clear()
    obs.counter(obs.MEMORY_POOL_MISS_BYTES).inc(nbytes)
    # np.empty, not bytearray: no zero fill under the GIL, the copy
    # writes every byte
    buf = np.empty(nbytes, dtype=np.uint8)
    key = id(buf)
    _OWNED[key] = weakref.ref(buf, lambda _ref: _OWNED.pop(key, None))
    return buf


def _release(buf) -> None:
    """Pool ``buf``, an object that has left the store, when this module
    allocated it and no reference but the caller's one local variable
    reaches it; otherwise leave it to the collector."""
    if sys.getrefcount(buf) > _SOLE_REFS:
        return
    ref = _OWNED.get(id(buf))
    if ref is None or ref() is not buf or buf.nbytes == 0:
        return
    with _LOCK:
        _FREE.setdefault(buf.nbytes, []).append(buf)


def release_pool() -> None:
    """Drop every pooled buffer."""
    with _LOCK:
        _FREE.clear()


def reset_namespace(namespace: str) -> None:
    with _LOCK:
        store = _NAMESPACES.pop(namespace, None)
    while store:
        _, buf = store.popitem()
        _release(buf)


async def _injected(plugin: "MemoryStoragePlugin", site: str, op_name: str, **attrs) -> None:
    """The failpoint at ``site`` under the retry policy, when armed."""
    if _failpoints_active():
        await retry_call(
            lambda: failpoint(site, **attrs), op_name=op_name, backend="memory",
            classify=classify_generic, progress=lazy_shared_progress(plugin, "memory"),
        )


@obs.instrument_storage("memory")
class MemoryStoragePlugin(StoragePlugin):
    adopts_private_buffers = True

    def __init__(self, namespace: str) -> None:
        self.namespace = namespace
        with _LOCK:
            self._store = _NAMESPACES.setdefault(namespace, {})
        # a copy fused with its digest needs the native library
        self.supports_fused_digest = _csrc.enabled_lib() is not None
        self.supports_fused_part_digest = self.supports_fused_digest

    def _publish(self, path: str, buf: np.ndarray) -> None:
        buf.setflags(write=False)
        old = self._store.get(path)
        self._store[path] = buf
        if old is not None:
            _release(old)

    async def write(self, write_io: WriteIO) -> None:
        await _injected(self, "storage.memory.write", f"write {write_io.path}", path=write_io.path)
        src = memoryview(write_io.buf).cast("B")
        if write_io.owned:
            await self._adopt(write_io, src)
            return
        with obs.clocked(obs.WRITE_ALLOC_S, "write/alloc"):
            dst = _draw(src.nbytes)
        with obs.clocked(obs.WRITE_COPY_S, "write/copy"):
            if write_io.want_digest and self.supports_fused_digest:
                write_io.digests = copy_digest(dst, src)
            else:
                np.copyto(dst, np.frombuffer(src, dtype=np.uint8))
        self._publish(write_io.path, dst)

    async def _adopt(self, write_io: WriteIO, src: memoryview) -> None:
        """Publish the private buffer ``src`` itself; with
        ``want_digest``, digest it in place, by stripe parts concurrently
        on the default pool for an object at the stripe threshold."""
        with obs.clocked(obs.WRITE_ALLOC_S, "write/alloc"):
            buf = np.frombuffer(src, dtype=np.uint8)
        if write_io.want_digest:
            n = buf.nbytes
            spans = stripe.plan_parts(n) if stripe.write_eligible(n, self) else [(0, n)]

            def part_digest(lo: int, hi: int) -> Tuple[int, int, int]:
                with obs.clocked(obs.WRITE_COPY_S, "write/copy"):
                    return (*digest(buf[lo:hi]), hi - lo)

            loop = asyncio.get_running_loop()
            parts = await asyncio.gather(
                *(loop.run_in_executor(None, part_digest, lo, hi) for lo, hi in spans)
            )
            crc, adler, _ = combine_piece_digests(parts)
            write_io.digests = (crc, adler)
        obs.counter(obs.MEMORY_ADOPTED_BYTES).inc(buf.nbytes)
        self._publish(write_io.path, buf)

    async def read(self, read_io: ReadIO) -> None:
        await _injected(self, "storage.memory.read", f"read {read_io.path}", path=read_io.path)
        try:
            data = self._store[read_io.path]
        except KeyError:
            raise FileNotFoundError(f"memory://{self.namespace}/{read_io.path}") from None
        view = memoryview(data).cast("B")
        start, end = read_io.byte_range or (0, view.nbytes)
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
        if read_io.byte_range is None:
            # read-only: a consumer must not change the stored object
            read_io.buf = view.toreadonly()
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
        # no two namespaces share a mutable buffer; a shared read-only
        # one is pooled only once neither holds it
        self._store[path] = bytes(src) if isinstance(src, bytearray) else src

    async def stat(self, path: str) -> int:
        try:
            return memoryview(self._store[path]).nbytes
        except KeyError:
            raise FileNotFoundError(f"memory://{self.namespace}/{path}") from None

    async def delete(self, path: str) -> None:
        try:
            buf = self._store.pop(path)
        except KeyError:
            raise FileNotFoundError(f"memory://{self.namespace}/{path}") from None
        _release(buf)

    # ------------------------------------------------- striped writes

    supports_striped_write = True

    async def begin_striped_write(self, path: str, total_size: int) -> "_MemoryStripedWriteHandle":
        return _MemoryStripedWriteHandle(self, path, total_size)


def _first_hole(parts: List[Tuple[int, int]]) -> Optional[int]:
    """The first offset below the highest written byte that no part
    covers, or None."""
    covered = 0
    for lo, hi in sorted(parts):
        if lo > covered:
            return covered
        covered = max(covered, hi)
    return None


class _MemoryStripedWriteHandle(StripedWriteHandle):
    """Ranged copies into one preallocated buffer (on the default pool,
    GIL-free, so parts run in parallel), published whole and read-only
    on ``complete``."""

    def __init__(self, plugin: MemoryStoragePlugin, path: str, total: int) -> None:
        self._plugin = plugin
        self._path = path
        with obs.clocked(obs.WRITE_ALLOC_S, "write/alloc"):
            self._buf = _draw(total)
        # (offset, end) of each part written; ``total`` bounds encoded
        # parts from above, complete() publishes up to the highest end
        self._parts: List[Tuple[int, int]] = []
        self.supports_fused_digest = plugin.supports_fused_digest

    async def write_part(self, index: int, offset: int, buf, want_digest: bool = False):
        await _injected(
            self._plugin, "storage.memory.part.write", f"write {self._path} [part {index}]",
            path=self._path, part=index,
        )
        src = np.frombuffer(memoryview(buf).cast("B"), dtype=np.uint8)
        # the executor's work item outlives the copy by a moment: it must
        # not hold the buffer when the loop goes on to complete or abort
        views = [self._buf[offset : offset + src.nbytes], src]
        fuse = want_digest and self.supports_fused_digest

        def copy():
            dst, part = views
            views.clear()
            with obs.clocked(obs.WRITE_COPY_S, "write/copy"):
                if fuse:
                    return copy_digest(dst, part)
                np.copyto(dst, part)
                return None

        digests = await asyncio.get_running_loop().run_in_executor(None, copy)
        self._parts.append((offset, offset + src.nbytes))
        return digests

    async def complete(self) -> None:
        buf, self._buf = self._buf, None
        hole = _first_hole(self._parts)
        if hole is not None:
            # a recycled buffer holds another object's bytes there
            _release(buf)
            raise OSError(
                f"memory://{self._plugin.namespace}/{self._path}: no part wrote byte {hole}; "
                "nothing was published"
            )
        hwm = max((hi for _, hi in self._parts), default=0)
        if hwm < buf.nbytes:
            with obs.clocked(obs.WRITE_COPY_S, "write/copy"):
                head = _draw(hwm)
                np.copyto(head, buf[:hwm])
            _release(buf)
            buf = head
        self._plugin._publish(self._path, buf)

    async def abort(self) -> None:
        buf, self._buf = self._buf, None
        if buf is not None:
            _release(buf)
