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
serve retention, verification and dedup.  Not ported: striped part
handles, the retry policy, the circuit breaker, failpoints and mmap
reads.

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
import errno
import os
import shutil
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Tuple

import numpy as np

from .. import _csrc, knobs, obs
from ..io_types import ReadIO, StoragePlugin, WriteIO
from ..utils.checksums import crc32_fast
from . import fastio


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


def _destination(into: Any, length: int) -> Any:
    """``into`` when it is a writable buffer of ``length`` bytes, else a
    fresh uninitialised one (np.empty: zeroing memory the read is about
    to overwrite costs a full extra pass)."""
    if into is not None:
        view = memoryview(into).cast("B")
        if not view.readonly and view.nbytes == length:
            return into
    return np.empty(length, dtype=np.uint8)


@obs.instrument_storage("fs")
class FSStoragePlugin(StoragePlugin):
    def __init__(self, root: str) -> None:
        self.root = root
        # probed once here: the library (built on first use; raises when
        # it cannot be built), the FASTIO knob, O_DIRECT support of root
        self._fastio: Optional[fastio.FastIOEngine] = None
        if knobs.fastio_enabled():
            self._fastio = fastio.create_engine(_csrc.enabled_lib(), root)
        self.supports_fused_digest = self._fastio is not None
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
            os.replace(tmp, full)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
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
        write_io.digests = await self._off_loop(
            self._write_sync, self._full(write_io.path), write_io.buf,
            write_io.durable, write_io.want_digest,
        )

    def _read_sync(self, full: str, byte_range, into=None) -> Any:
        if byte_range is None:
            start, length = 0, os.stat(full).st_size
        else:
            start, length = byte_range[0], byte_range[1] - byte_range[0]
        out = _destination(into, length)
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
        read_io.buf = await self._off_loop(
            self._read_sync, self._full(read_io.path), read_io.byte_range,
            read_io.into,
        )

    async def delete(self, path: str) -> None:
        await self._off_loop(os.remove, self._full(path))

    async def stat(self, path: str) -> int:
        return (await self._off_loop(os.stat, self._full(path))).st_size

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
