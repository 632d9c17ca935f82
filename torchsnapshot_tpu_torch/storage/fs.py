"""Local filesystem storage plugin.

Counterpart of ``torchsnapshot_tpu/storage/fs.py``.  Writes and reads go
through the native fast-I/O engine (``storage/fastio.py``), chosen once
when the plugin is made: each is one GIL-free native call, a write
digests its bytes in the same pass (``WriteIO.want_digest``), a read
lands in ``ReadIO.into`` when the caller gave one, and ``FASTIO_DIRECT``
moves payloads around the page cache.  ``FASTIO=0`` or
``ENABLE_NATIVE_EXT=0`` keep the pure-Python legs, which write and read
the same bytes.  ``delete``, ``stat`` and ``link_from`` (a hardlink of
a base snapshot's object for incremental takes, a copy across devices)
serve retention, verification and dedup.  A read that asks for a map
(``ReadIO.want_mmap``, under the ``MMAP`` knob) is served by
``mmap_read`` as a private file-backed mapping, before the fast-I/O
engine is reached.

Writes, reads and stats run under the shared retry policy
(``resilience/retry.py``: EINTR and EAGAIN retry, anything else is
fatal) and feed the ``fs`` circuit breaker; the failpoint sites are
``storage.fs.write``, ``storage.fs.write.sync`` (before the rename
commits a file), ``storage.fs.read`` and ``storage.fs.part.write``.
``begin_striped_write`` opens a striped write (``storage/stripe.py``):
parts are written at their offsets into a preallocated sibling temp
file, each through the fast-I/O engine with its digest fused into the
write, each retried on its own; ``complete`` trims the file to the
bytes written and renames it into place, ``abort`` unlinks it.

The commit discipline is the same on both legs: every write lands in a
unique sibling temp file and is ``os.replace``d onto its final name, so
a failed write never leaves a partial file a reader would trust, and a
later write to a path never goes through an inode that another
snapshot's hardlink shares; a
durable write (the ``.snapshot_metadata`` commit point, or every write
under ``FS_SYNC_DATA``) is fdatasync'd, and the commit point's directory
chain fsync'd.  ``FS_VERIFY_WRITES`` re-reads each file and compares its
crc32.  Syscalls run on the plugin's own thread pool, off the
scheduler's event loop.  Every write and read records the per-backend
latency and byte metrics (``storage.fs.*``) and, traced, a
``storage/write`` or ``storage/read`` span.
"""

from __future__ import annotations

import asyncio
import contextlib
import errno
import mmap
import os
import shutil
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from .. import _csrc, knobs, obs
from ..io_types import (
    ReadIO,
    StoragePlugin,
    StripedWriteHandle,
    WriteIO,
    register_mapping,
    resolve_read_destination,
)
from ..resilience import classify_fs, get_breaker, lazy_shared_progress, retry_call
from ..resilience.failpoints import failpoint
from ..utils.checksums import crc32_fast
from . import fastio, stripe


def _tmp_name(full: str) -> str:
    return f"{full}.tsnp-tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"


def _fsync_dir_chain(leaf_dir: str, stop_below: str) -> None:
    """fsync ``leaf_dir`` and each ancestor down to the parent of
    ``stop_below``: a NEW file is durable only once every newly created
    directory's entry is synced in its parent."""
    cur = os.path.abspath(leaf_dir)
    stop = os.path.dirname(os.path.abspath(stop_below))
    while True:
        fd = os.open(cur, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if cur == stop or os.path.dirname(cur) == cur:
            break
        cur = os.path.dirname(cur)


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def mmap_read(full: str, byte_range, path: str = "") -> np.ndarray:
    """Zero-copy read: a uint8 array over a private (copy-on-write) map
    of the whole of ``full``, offset to ``byte_range``.  The pages stay
    the page cache's until something writes them, and a write lands in
    a private copy, never in the file, so a tensor made over the array
    needs no copy (torch has no read-only tensors).  The pages fault in
    on first touch and the kernel may reclaim them, which is why the
    read scheduler admits mapped reads outside the budget.

    SIGBUS discipline: touching a mapped page past the inode's end
    raises SIGBUS, so a file truncated in place while mapped would kill
    the reader.  Nothing here truncates a live name: every writer
    publishes by temp file and rename, and every delete unlinks (an
    unlinked inode's pages stay valid while mapped).  The extent check
    below raises EIO for a file already shorter than the read, before
    any map.  ``MADV_WILLNEED`` starts readahead of the span."""
    with obs.span("storage/mmap_read", path=path or full):
        fd = os.open(full, os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            if byte_range is None:
                offset, length = 0, size
            else:
                offset, length = byte_range[0], byte_range[1] - byte_range[0]
            if offset + length > size:
                raise OSError(
                    errno.EIO,
                    f"mmap read of [{offset}, {offset + length}) exceeds file size {size}",
                    full,
                )
            if length == 0:
                return np.empty(0, dtype=np.uint8)
            mm = mmap.mmap(fd, size, access=mmap.ACCESS_COPY)
        finally:
            os.close(fd)
        try:
            lo = offset - offset % mmap.PAGESIZE  # madvise wants page alignment
            mm.madvise(mmap.MADV_WILLNEED, lo, length + offset - lo)
        except (AttributeError, OSError, ValueError) as e:
            obs.swallowed_exception("storage.fs.mmap_madvise", e)
        obs.counter(obs.MMAP_READS).inc()
        obs.counter(obs.MMAP_BYTES_MAPPED).inc(length)
        # the array holds the only reference to the map: it lives as long
        # as some view of the array does
        arr = np.frombuffer(mm, dtype=np.uint8, count=length, offset=offset)
        register_mapping(arr)
        return arr


@obs.instrument_storage("fs")
class FSStoragePlugin(StoragePlugin):
    supports_mmap_read = True
    # every read is a local file: a map never declines
    mmap_budget_exempt = True

    def __init__(self, root: str) -> None:
        self.root = root
        # probed once here: the library (built on first use; raises when
        # it cannot be built), the FASTIO knob, O_DIRECT support of root
        self._fastio: Optional[fastio.FastIOEngine] = None
        if knobs.fastio_enabled():
            self._fastio = fastio.create_engine(_csrc.enabled_lib(), root)
        self.supports_fused_digest = self._fastio is not None
        # the striped handles fuse part digests on the same condition
        self.supports_fused_part_digest = self.supports_fused_digest
        self._executor = ThreadPoolExecutor(
            max_workers=knobs.get_max_per_rank_io_concurrency(),
            thread_name_prefix="tsnp-torch-fsio",
        )

    def _full(self, path: str) -> str:
        return os.path.join(self.root, path)

    async def _off_loop(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, fn, *args
        )

    async def _retry(self, fn, op_name: str, breaker: Any = None):
        """``fn`` on the plugin's threads under the shared retry policy."""
        return await retry_call(
            fn, op_name=op_name, backend="fs", classify=classify_fs,
            progress=lazy_shared_progress(self, "fs"), executor=self._executor,
            breaker=breaker,
        )

    def _write_file(self, tmp: str, view: memoryview, sync: bool, want_digest: bool):
        if self._fastio is not None:
            return self._fastio.write_file(tmp, view, sync, want_digest)
        with open(tmp, "wb") as f:
            f.write(view)
            if sync:
                f.flush()
                os.fdatasync(f.fileno())
        return None

    def _write_sync(
        self, full: str, buf, durable: bool, want_digest: bool
    ) -> Optional[Tuple[int, int]]:
        os.makedirs(os.path.dirname(full), exist_ok=True)
        view = memoryview(buf).cast("B")
        tmp = _tmp_name(full)
        try:
            digests = self._write_file(
                tmp, view, durable or knobs.is_fs_sync_data(), want_digest
            )
            failpoint("storage.fs.write.sync", path=full)
            os.replace(tmp, full)
        except BaseException:
            _unlink_quiet(tmp)
            raise
        if durable:
            _fsync_dir_chain(os.path.dirname(full), self.root)
        if knobs.is_fs_verify_writes() and view.nbytes:
            expected = digests[0] if digests is not None else crc32_fast(view)
            got = crc32_fast(self._read_sync(full, None))
            if got != expected:
                raise OSError(
                    5, f"crc32 mismatch after write ({got:#x} != {expected:#x})", full
                )
        return digests

    async def write(self, write_io: WriteIO) -> None:
        full = self._full(write_io.path)

        def attempt():
            failpoint("storage.fs.write", path=write_io.path)
            return self._write_sync(full, write_io.buf, write_io.durable, write_io.want_digest)

        write_io.digests = await self._retry(
            attempt, f"write {write_io.path}", breaker=get_breaker("fs")
        )

    def _read_sync(self, full: str, byte_range, into=None) -> Any:
        if byte_range is None:
            start, length = 0, os.stat(full).st_size
        else:
            start, length = byte_range[0], byte_range[1] - byte_range[0]
        out = resolve_read_destination(into, length)
        if self._fastio is not None:
            got = self._fastio.read_into(full, start, length, out) if length else 0
        else:
            view = memoryview(out).cast("B")
            got = 0
            with open(full, "rb") as f:
                f.seek(start)
                while got < length:
                    n = f.readinto(view[got:])
                    if not n:
                        break
                    got += n
        if got != length:
            raise OSError(5, f"short read: {got} of {length} bytes", full)
        return out

    async def read(self, read_io: ReadIO) -> None:
        full = self._full(read_io.path)
        if read_io.want_mmap and knobs.mmap_enabled():
            def mmap_attempt():
                failpoint("storage.fs.read", path=read_io.path)
                return mmap_read(full, read_io.byte_range, read_io.path)

            read_io.buf = await self._retry(mmap_attempt, f"read {read_io.path}")
            return

        def attempt():
            failpoint("storage.fs.read", path=read_io.path)
            return self._read_sync(full, read_io.byte_range, read_io.into)

        read_io.buf = await self._retry(attempt, f"read {read_io.path}")

    async def delete(self, path: str) -> None:
        await self._off_loop(os.remove, self._full(path))

    async def stat(self, path: str) -> int:
        full = self._full(path)
        return await self._retry(lambda: os.stat(full).st_size, f"stat {path}")

    def _link_sync(self, src: str, dst: str) -> None:
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.lexists(dst):
            os.remove(dst)
        try:
            os.link(src, dst)
        except OSError as e:
            if e.errno != errno.EXDEV:
                raise
            # across devices: a copy, still no read through Python
            shutil.copyfile(src, dst)

    async def link_from(self, base_url: str, path: str) -> None:
        """Hardlink the base snapshot's object: each snapshot holds its
        own directory entry to the shared inode, so deleting either
        leaves the other intact.  Across devices it is copied."""
        src = os.path.join(base_url.split("://", 1)[-1], path)
        await self._off_loop(self._link_sync, src, self._full(path))

    async def close(self) -> None:
        self._executor.shutdown(wait=False)

    # ------------------------------------------------- striped writes

    supports_striped_write = True

    async def begin_striped_write(self, path: str, total_size: int) -> "_FSStripedWriteHandle":
        full = self._full(path)
        tmp = _tmp_name(full)
        # a caller cancelled while the open runs in its thread must not
        # orphan the temp file: whichever side comes second cleans up
        lock = threading.Lock()
        state: Dict[str, Any] = {"abandoned": False, "opened": None}

        def _undo(fds: Tuple[int, int]) -> None:
            for fd in fds:
                if fd >= 0:
                    os.close(fd)
            _unlink_quiet(tmp)

        def _open():
            os.makedirs(os.path.dirname(full), exist_ok=True)
            fd = os.open(tmp, os.O_RDWR | os.O_CREAT | os.O_EXCL | os.O_CLOEXEC, 0o644)
            fd_direct = -1
            try:
                os.ftruncate(fd, total_size)
                if self._fastio is not None:
                    # one O_DIRECT fd for every part's aligned body; -1
                    # when the direct leg is off
                    fd_direct = self._fastio.open_direct(tmp)
            except BaseException:
                _undo((fd, fd_direct))
                raise
            with lock:
                if not state["abandoned"]:
                    state["opened"] = (fd, fd_direct)
                    return fd, fd_direct
            _undo((fd, fd_direct))
            return None

        fut = asyncio.get_running_loop().run_in_executor(self._executor, _open)
        try:
            fd, fd_direct = await asyncio.shield(fut)
        except BaseException:
            # a cancelled caller: the open's thread runs on, so let it end
            # (bounded) and undo what it made before the error propagates
            if not fut.done():
                await asyncio.wait({fut}, timeout=stripe.WAIT_DEADLINE_S)
            with lock:
                state["abandoned"] = True
                opened = state["opened"]
            if opened is not None:
                _undo(opened)
            raise
        return _FSStripedWriteHandle(self, path, full, tmp, fd, fd_direct)


class _FSStripedWriteHandle(StripedWriteHandle):
    """Offset-parallel part writes into a preallocated sibling temp file.
    A part is one GIL-free call of the fast-I/O engine, its (crc32,
    adler32) fused into the pass that writes it; with ``FASTIO=0`` it is
    an ``os.pwrite`` loop and the stripe engine digests the bytes in one
    more pass.  Each part, and the commit, retries on its own and feeds
    the ``fs`` breaker.  ``complete`` trims the file to the highest byte written
    (encoded parts are smaller than the preallocation), fdatasyncs it
    under ``FS_SYNC_DATA`` and renames it onto the final name; ``abort``
    closes and unlinks it, so no partial file is ever visible."""

    def __init__(self, plugin: FSStoragePlugin, path: str, full: str, tmp: str, fd: int, fd_direct: int) -> None:
        self._plugin = plugin
        self._path = path
        self._final = full
        self._tmp = tmp
        self._fd = fd
        self._fd_direct = fd_direct
        self._closed = False
        self.supports_fused_digest = plugin._fastio is not None
        self._hwm = 0
        # threads using the fds now: a cancelled part's thread may still be
        # writing, so abort closes the fds (whose numbers the process may
        # reuse) only once none is
        self._active = 0
        self._idle = threading.Condition()

    @contextlib.contextmanager
    def _using_fds(self) -> Iterator[None]:
        with self._idle:
            if self._closed:
                raise OSError(errno.EBADF, "striped write already closed", self._tmp)
            self._active += 1
        try:
            yield
        finally:
            with self._idle:
                self._active -= 1
                self._idle.notify_all()

    async def write_part(self, index: int, offset: int, buf, want_digest: bool = False):
        view = memoryview(buf).cast("B")
        self._hwm = max(self._hwm, offset + view.nbytes)
        engine = self._plugin._fastio

        def attempt():
            failpoint("storage.fs.part.write", path=self._path, part=index)
            with self._using_fds():
                if engine is not None:
                    return engine.pwrite_part(self._fd, self._fd_direct, offset, view, want_digest)
                pos = 0
                while pos < view.nbytes:
                    pos += os.pwrite(self._fd, view[pos:], offset + pos)
                return None

        return await self._plugin._retry(
            attempt, f"write {self._path} [part {index}]", breaker=get_breaker("fs")
        )

    async def complete(self) -> None:
        durable = knobs.is_fs_sync_data()

        def commit() -> None:
            failpoint("storage.fs.write.sync", path=self._path)
            with self._using_fds():
                if os.fstat(self._fd).st_size != self._hwm:
                    os.ftruncate(self._fd, self._hwm)
                if durable:
                    os.fdatasync(self._fd)
            self._close_fd()
            os.replace(self._tmp, self._final)

        # the commit retries its transients like a whole-file write's sync
        # (the JAX package's handle does not retry it); the fd stays open
        # until the commit succeeds, and abort closes it otherwise
        try:
            await self._plugin._retry(commit, f"commit {self._path}", breaker=get_breaker("fs"))
        except BaseException:
            # shielded: a take that cancels this write while it aborts
            # (another object failed too) waits for the abort's task, so
            # the temp file is gone before the take raises
            await asyncio.shield(self.abort())
            raise

    def _close_fd(self) -> None:
        """Close the fds once no thread uses them (at most
        ``stripe.WAIT_DEADLINE_S`` of waiting)."""
        with self._idle:
            self._idle.wait_for(lambda: self._active == 0, timeout=stripe.WAIT_DEADLINE_S)
            if self._closed:
                return
            self._closed = True
        if self._fd_direct >= 0:
            os.close(self._fd_direct)
        os.close(self._fd)

    async def abort(self) -> None:
        def cleanup() -> None:
            self._close_fd()
            _unlink_quiet(self._tmp)

        await self._plugin._off_loop(cleanup)
