"""Local filesystem storage plugin.

Counterpart of ``torchsnapshot_tpu/storage/fs.py`` without its native
fast-I/O engine, retry policy, circuit breaker and failpoints.  The
commit discipline is the same: every write lands in a unique sibling
temp file and is ``os.replace``d onto its final name, so a failed write
never leaves a partial file a reader would trust; a durable write
(the ``.snapshot_metadata`` commit point) is fdatasync'd and its
directory chain fsync'd.  Syscalls run on the plugin's own thread pool,
off the scheduler's event loop.
"""

from __future__ import annotations

import asyncio
import os
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import knobs
from ..io_types import ReadIO, StoragePlugin, WriteIO


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


class FSStoragePlugin(StoragePlugin):
    def __init__(self, root: str) -> None:
        self.root = root
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

    def _write_sync(self, full: str, buf, durable: bool) -> None:
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = _tmp_name(full)
        try:
            with open(tmp, "wb") as f:
                f.write(memoryview(buf).cast("B"))
                if durable:
                    f.flush()
                    os.fdatasync(f.fileno())
            os.replace(tmp, full)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if durable:
            _fsync_dir_chain(os.path.dirname(full), self.root)

    async def write(self, write_io: WriteIO) -> None:
        await self._off_loop(
            self._write_sync, self._full(write_io.path), write_io.buf,
            write_io.durable,
        )

    @staticmethod
    def _read_sync(full: str, byte_range, into=None) -> np.ndarray:
        with open(full, "rb") as f:
            if byte_range is None:
                start, length = 0, os.fstat(f.fileno()).st_size
            else:
                start, length = byte_range[0], byte_range[1] - byte_range[0]
                f.seek(start)
            if into is not None and memoryview(into).nbytes == length:
                out = into  # the caller's buffer (pinned tile memory)
            else:
                # np.empty, not bytearray: zeroing memory the read is
                # about to overwrite costs a full extra pass
                out = np.empty(length, dtype=np.uint8)
            view = memoryview(out).cast("B")
            got = 0
            while got < length:
                n = f.readinto(view[got:])
                if not n:
                    raise OSError(
                        5, f"short read: {got} of {length} bytes", full
                    )
                got += n
            return out

    async def read(self, read_io: ReadIO) -> None:
        read_io.buf = await self._off_loop(
            self._read_sync, self._full(read_io.path), read_io.byte_range,
            read_io.into,
        )

    async def close(self) -> None:
        self._executor.shutdown(wait=False)
