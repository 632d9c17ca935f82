"""Shared-host object cache: co-located readers fetch each durable
object once.

Counterpart of ``torchsnapshot_tpu/storage/hostcache.py``.  N serving
processes cold-starting on one host from one snapshot would make N
durable GETs per object; ``HostCachedStoragePlugin`` wraps any plugin
with a per-host cache directory (the ``CACHE_DIR`` knob) that every
process of the machine shares:

- a **hit** serves the local cache file, as a private map when the read
  asks for one under ``MMAP`` (cached objects are local files, so the
  zero-copy restore path composes);
- a **miss** fills the entry under a cross-process ``flock`` with single-
  flight semantics: one process performs the GET and publishes the file
  by temp file and rename, the others poll the lock and serve the
  published file (counted as ``singleflight_waits``, not GETs).  The poll
  gives up after ``LOCK_DEADLINE_S`` (600 s) with an error naming the
  lock.

Cache keys hash the pair (durable url, object path) exactly as the JAX
package does, so a cache directory filled by either package serves the
other.  Commit markers (``.snapshot_metadata`` and
``.snapshot_obsrecord``) are never cached: they go from absent to
present at commit, and a stale marker would be a correctness bug.
Writes and deletes through the wrapper drop their entry.  Eviction
(``CACHE_MAX_BYTES``) unlinks the oldest entries by mtime and never
truncates: an unlinked file's pages stay valid under a live map.
"""

from __future__ import annotations

import asyncio
import errno
import hashlib
import os
import time
from typing import Any, Optional

from .. import knobs, obs
from ..io_types import (
    ReadIO,
    StoragePlugin,
    WriteIO,
    resolve_read_destination,
)
from .fs import _tmp_name, _unlink_quiet, mmap_read

_OBJECTS_SUBDIR = "objects"
_LOCKS_SUBDIR = "locks"
# how often a reader that lost the fill race re-probes the lock and the
# published file; cheap (one open+flock(NB)+close + one stat per tick)
_LOCK_POLL_S = 0.025
# the longest a reader polls another process's fill before it raises
LOCK_DEADLINE_S = 600.0


class CacheLockTimeout(TimeoutError):
    """Another process held a cache entry's fill lock past
    ``LOCK_DEADLINE_S`` without publishing the entry."""


def host_cache_active() -> bool:
    """Whether durable reads of this host go through the shared cache
    (the CACHE_DIR knob is set).  The fan-out restore composes with it: a
    one-host slice under the cache already costs one durable GET per
    object, so it skips the redistribution."""
    return knobs.get_cache_dir() is not None


def _cacheable(path: str) -> bool:
    # commit markers (.snapshot_metadata, .snapshot_obsrecord) are the
    # mutable absent→present reads; everything else in a snapshot is
    # immutable payload
    return not os.path.basename(path).startswith(".snapshot")


def _lock_try_acquire(lock_path: str) -> Optional[int]:
    """Non-blocking flock attempt: the fd (locked) or None when another
    process holds it.  NEVER blocks a thread on the lock — waiters poll
    from the event loop instead, so a host full of readers blocked on
    one fill cannot starve the bounded executor the fill itself needs
    to publish and release (the classic flock-on-executor deadlock)."""
    import fcntl

    os.makedirs(os.path.dirname(lock_path), exist_ok=True)
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError as e:
        os.close(fd)
        if e.errno in (errno.EWOULDBLOCK, errno.EAGAIN, errno.EACCES):
            return None
        # a filesystem without flock (ENOLCK): no single flight is
        # possible there, so say so instead of polling to the deadline
        raise
    except BaseException:
        os.close(fd)
        raise
    return fd


def _lock_release(fd: int) -> None:
    import fcntl

    try:
        fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)


def _read_local(cfile: str, read_io: ReadIO) -> Any:
    """Serve a cache file: mmap-backed when requested (zero-copy), else
    a single pread honoring the ``into`` destination hint (via the
    shared resolve_read_destination contract)."""
    if read_io.want_mmap and knobs.mmap_enabled():
        return mmap_read(cfile, read_io.byte_range, read_io.path)
    with open(cfile, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if read_io.byte_range is None:
            offset, length = 0, size
        else:
            offset, length = (
                read_io.byte_range[0],
                read_io.byte_range[1] - read_io.byte_range[0],
            )
        out = resolve_read_destination(read_io.into, length)
        view = memoryview(out).cast("B")
        f.seek(offset)
        pos = 0
        while pos < length:
            n = f.readinto(view[pos:])
            if not n:
                raise OSError(5, f"short read: {pos} of {length} bytes", cfile)
            pos += n
        return out


def _close_abandoned_open(fut: Any) -> None:
    """Done-callback for an executor ``open`` whose awaiter was
    cancelled: the fd exists only inside the dropped future, so close
    it here or it pins the (already-unlinked) temp inode until GC."""
    try:
        fobj = fut.result()
    except (OSError, asyncio.CancelledError):
        return  # open itself failed/was cancelled: nothing to close
    try:
        fobj.close()
    except OSError:
        pass


async def _fill_from_inner(
    plugin: "HostCachedStoragePlugin", path: str, cfile: str
) -> int:
    """Stream the durable object into ``cfile`` (temp+rename publish).
    Large objects move in stripe-part-sized spans so a fill never
    buffers a whole multi-GB object on the heap — per-fill memory is
    one part, and fills are single-flight per object, so host-wide
    transit memory stays bounded regardless of object size."""
    import numpy as np

    loop = asyncio.get_running_loop()
    part = knobs.get_stripe_part_size_bytes()
    size = None
    if type(plugin.inner).stat is not StoragePlugin.stat:
        # only probe plugins with a CHEAP stat — the base default
        # "stats" by reading the whole object, the very transit this
        # streaming path exists to avoid
        size = await plugin.inner.stat(path)
    os.makedirs(os.path.dirname(cfile), exist_ok=True)
    tmp = _tmp_name(cfile)
    total = 0
    try:
        if size is None or size <= part:
            inner_io = ReadIO(path=path)
            await plugin.inner.read(inner_io)
            view = memoryview(inner_io.buf).cast("B")
            total = view.nbytes

            def publish_whole() -> None:
                with open(tmp, "wb") as f:
                    f.write(view)

            await loop.run_in_executor(None, publish_whole)
        else:
            buf = np.empty(part, dtype=np.uint8)
            # open()/close() are synchronous metadata syscalls — on a
            # contended or networked cache filesystem they stall the
            # loop just like the writes would, so all three run on the
            # executor (the writes always did).  Each await is a new
            # cancellation point the synchronous form didn't have: a
            # cancel landing mid-open would drop the worker thread's
            # fd on the floor (pinning the unlinked tmp inode), so the
            # abandoned result is closed via a done-callback, and the
            # close is shielded so the fd never outlives the fill.
            open_fut = loop.run_in_executor(None, open, tmp, "wb")
            try:
                f = await asyncio.shield(open_fut)
            except asyncio.CancelledError:
                open_fut.add_done_callback(_close_abandoned_open)
                raise
            try:
                for lo in range(0, size, part):
                    hi = min(lo + part, size)
                    span_io = ReadIO(
                        path=path,
                        byte_range=[lo, hi],
                        into=buf[: hi - lo],
                    )
                    await plugin.inner.read(span_io)
                    view = memoryview(span_io.buf).cast("B")
                    await loop.run_in_executor(None, f.write, view)
                    total += view.nbytes
            finally:
                # shield: the close itself always completes in the
                # worker thread even if this await is cancelled
                await asyncio.shield(
                    loop.run_in_executor(None, f.close)
                )
        os.replace(tmp, cfile)
    except BaseException:
        _unlink_quiet(tmp)
        raise
    return total


async def singleflight_fill(
    plugin: "HostCachedStoragePlugin", path: str, cfile: str
) -> None:
    """Fill ``cfile`` from the durable tier exactly once across every
    process on the host.  The flock winner performs the GET and
    publishes via temp+rename; losers POLL (non-blocking lock attempts
    from the event loop — no thread ever parks on the lock) and serve
    the published file the moment it appears, performing no GET of
    their own.  The winner unlinks its lock file after publishing, so
    the locks directory holds only in-flight fills; the worst a stale-
    inode race can cost is one duplicate GET (publish stays atomic),
    never corruption."""
    with obs.span("cache/singleflight_fill", path=path):
        loop = asyncio.get_running_loop()
        lock_path = plugin._lock_path(cfile)
        waited = False
        deadline = time.monotonic() + LOCK_DEADLINE_S
        while True:
            lock_fd = await loop.run_in_executor(
                None, _lock_try_acquire, lock_path
            )
            if lock_fd is not None:
                break
            waited = True
            if time.monotonic() > deadline:
                raise CacheLockTimeout(
                    f"cache fill of {path!r}: the lock {lock_path!r} was held "
                    f"by another process for more than {LOCK_DEADLINE_S:g} s "
                    f"without the entry being published"
                )
            await asyncio.sleep(_LOCK_POLL_S)
            if os.path.exists(cfile):
                # the fill-holder published while we polled: its GET
                # is our GET — no need to ever touch the lock
                plugin._m_waits.inc()
                return
        try:
            if os.path.exists(cfile):
                # lost the race but the winner already published
                if waited:
                    plugin._m_waits.inc()
                else:
                    plugin._m_hits.inc()
                return
            plugin._m_misses.inc()
            n = await _fill_from_inner(plugin, path, cfile)
            plugin._m_filled.inc(n)
            await loop.run_in_executor(None, plugin._maybe_evict, cfile)
        finally:
            # in-flight fills only: a completed (or failed) fill's lock
            # file is removed so the locks dir never accumulates one
            # dentry per object ever read
            _unlink_quiet(lock_path)
            await loop.run_in_executor(None, _lock_release, lock_fd)


@obs.instrument_storage("cache")
class HostCachedStoragePlugin(StoragePlugin):
    """Read-through per-host object cache over ``inner`` (see module
    docstring).  Writes/deletes pass through and invalidate; only reads
    are accelerated."""

    # cached objects are local files — the zero-copy serving contract
    # (io_types.StoragePlugin.supports_mmap_read) holds for every read
    # this plugin serves from its cache directory; budget exemption
    # holds too because fills stream in bounded spans (_fill_from_inner)
    # — a cache read never buffers a whole object on the heap
    supports_mmap_read = True
    mmap_budget_exempt = True

    def __init__(
        self,
        inner: StoragePlugin,
        inner_url: str,
        cache_dir: Optional[str] = None,
        max_bytes: Optional[int] = None,
    ) -> None:
        self.inner = inner
        self.inner_url = inner_url.rstrip("/")
        self.cache_dir = cache_dir or knobs.get_cache_dir()
        if not self.cache_dir:
            raise ValueError(
                "HostCachedStoragePlugin needs a cache directory "
                "(TORCHSNAPSHOT_TPU_TORCH_CACHE_DIR or cache_dir=)"
            )
        self._max_bytes = (
            max_bytes if max_bytes is not None else knobs.get_cache_max_bytes()
        )
        self.supports_fused_digest = bool(
            getattr(inner, "supports_fused_digest", False)
        )
        self.supports_striped_write = bool(
            getattr(inner, "supports_striped_write", False)
        )
        # striped writes delegate to inner's handles verbatim, so the
        # part-level fused-digest capability passes through too — the
        # scheduler's defer decision must see the INNER plugin's truth
        self.supports_fused_part_digest = bool(
            getattr(inner, "supports_fused_part_digest", False)
        )
        m = obs.REGISTRY
        self._m_hits = m.counter(obs.CACHE_HITS)
        self._m_misses = m.counter(obs.CACHE_MISSES)
        self._m_waits = m.counter(obs.CACHE_SINGLEFLIGHT_WAITS)
        self._m_filled = m.counter(obs.CACHE_BYTES_FILLED)
        self._m_evictions = m.counter(obs.CACHE_EVICTIONS)

    # ------------------------------------------------------------ keys

    def _key(self, path: str) -> str:
        h = hashlib.sha256()
        h.update(self.inner_url.encode())
        h.update(b"\n")
        h.update(path.encode())
        return h.hexdigest()

    def _cache_file(self, path: str) -> str:
        k = self._key(path)
        return os.path.join(self.cache_dir, _OBJECTS_SUBDIR, k[:2], k)

    def _lock_path(self, cfile: str) -> str:
        return os.path.join(
            self.cache_dir, _LOCKS_SUBDIR, os.path.basename(cfile) + ".lock"
        )

    def _invalidate(self, path: str) -> None:
        _unlink_quiet(self._cache_file(path))

    # ------------------------------------------------------------ read

    async def read(self, read_io: ReadIO) -> None:
        if not _cacheable(read_io.path):
            await self.inner.read(read_io)
            return
        cfile = self._cache_file(read_io.path)
        loop = asyncio.get_running_loop()
        # bounded fill→serve retry: a peer's eviction can unlink the
        # entry between our fill and our open (an OPEN file or mapping
        # is never affected — this race exists only in the gap before
        # the serve opens it).  One refill closes it; a second
        # disappearance means the cache dir is being actively wiped,
        # which should surface, not spin.
        for _attempt in range(2):
            if not os.path.exists(cfile):
                await singleflight_fill(self, read_io.path, cfile)
            else:
                self._m_hits.inc()
            try:
                read_io.buf = await loop.run_in_executor(
                    None, _read_local, cfile, read_io
                )
                return
            except FileNotFoundError:
                continue
        raise OSError(
            5,
            "cache entry evicted twice between fill and serve — is the "
            "cache directory being wiped while in use?",
            cfile,
        )

    # ------------------------------------------------------- eviction

    def _maybe_evict(self, keep: str) -> None:
        """Oldest-first (mtime) unlink until under the soft cap, never
        touching ``keep`` (the entry just filled).  Deliberately
        lock-free and race-tolerant: a concurrently-evicted entry a
        peer was about to serve simply re-misses and refills, and
        unlink (never truncate) keeps any live mmap of the victim
        valid."""
        if self._max_bytes is None:
            return
        objects_root = os.path.join(self.cache_dir, _OBJECTS_SUBDIR)
        entries = []
        total = 0
        for dirpath, _dirs, files in os.walk(objects_root):
            for name in files:
                p = os.path.join(dirpath, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue  # concurrently evicted by a peer
                entries.append((st.st_mtime, st.st_size, p))
                total += st.st_size
        if total <= self._max_bytes:
            return
        for _mtime, size, p in sorted(entries):
            if p == keep:
                continue
            _unlink_quiet(p)
            self._m_evictions.inc()
            total -= size
            if total <= self._max_bytes:
                return

    # ----------------------------------------------- write-side ops

    async def write(self, write_io: WriteIO) -> None:
        await self.inner.write(write_io)
        # a write through the wrapper changes the content at this path:
        # drop any stale entry (root-reuse defense; committed snapshot
        # payloads never actually rewrite in place)
        if _cacheable(write_io.path):
            self._invalidate(write_io.path)

    async def begin_striped_write(self, path: str, total_size: int):
        if _cacheable(path):
            self._invalidate(path)
        return await self.inner.begin_striped_write(path, total_size)

    async def delete(self, path: str) -> None:
        try:
            await self.inner.delete(path)
        finally:
            if _cacheable(path):
                self._invalidate(path)

    async def link_from(self, base_url: str, path: str) -> None:
        await self.inner.link_from(base_url, path)
        if _cacheable(path):
            self._invalidate(path)

    async def stat(self, path: str) -> int:
        if _cacheable(path):
            try:
                return os.stat(self._cache_file(path)).st_size
            except OSError:
                pass  # not cached (or racing eviction): ask the source
        return await self.inner.stat(path)

    async def close(self) -> None:
        await self.inner.close()
