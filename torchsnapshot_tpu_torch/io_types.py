"""Core I/O contracts: cost-annotated deferred work items + storage ABC.

Counterpart of ``torchsnapshot_tpu/io_types.py``:

- ``BufferStager``: deferred "produce the bytes" (device→host copy +
  serialize), annotated with its peak host-memory cost so the scheduler
  can admit work under a budget.
- ``BufferConsumer``: the read-side dual — "consume these bytes"
  (deserialize + place into the target tensor/object).
- ``WriteReq``/``ReadReq`` bind a storage path to a stager/consumer;
  ``ReadReq`` carries an optional byte range for ranged reads and the
  payload's recorded crc32, checked by ``check_read_crc`` under the
  VERIFY_ON_RESTORE knob.
- ``StoragePlugin``: async write/read/delete/stat/link_from/close
  against a backend.

On the GPU the stager's device→host copy is a ``cudaMemcpyAsync`` into
pinned host memory on a side copy stream, waited on by an event in a
worker thread (see ``preparers/array.py``).
"""

from __future__ import annotations

import abc
import asyncio
import concurrent.futures
from concurrent.futures import Executor
from dataclasses import dataclass, field
from typing import Any, Callable, Coroutine, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class Future(Generic[T]):
    """A placeholder for a value produced after read execution completes."""

    __slots__ = ("obj",)

    def __init__(self, obj: Optional[T] = None) -> None:
        self.obj = obj

    def set(self, obj: T) -> None:
        self.obj = obj


class BufferStager(abc.ABC):
    @abc.abstractmethod
    async def stage_buffer(self, executor: Optional[Executor] = None) -> Any:
        """Produce the bytes to write (bytes / memoryview / uint8 array).
        Heavy host work runs on ``executor``."""

    @abc.abstractmethod
    def get_staging_cost_bytes(self) -> int:
        """Peak host memory consumed while the staged buffer is alive."""


class BufferConsumer(abc.ABC):
    @abc.abstractmethod
    async def consume_buffer(
        self, buf: Any, executor: Optional[Executor] = None
    ) -> None:
        """Deserialize ``buf`` and place the result into its target."""

    @abc.abstractmethod
    def get_consuming_cost_bytes(self) -> int:
        """Peak host memory consumed while the read buffer is alive."""

    def read_buffer(self, nbytes: int) -> Any:
        """A writable host buffer of ``nbytes`` the storage may read this
        request's bytes into (it then hands that same object to
        ``consume_buffer``), or None for a buffer of the storage's own.
        Asked for when the read starts, so only reads in flight hold
        one."""
        return None


@dataclass
class WriteReq:
    path: str
    buffer_stager: BufferStager
    # (sink, byte_range | None): after staging, each sink receives the
    # crc32 of its slice of the staged buffer (None = whole buffer);
    # preparers point these at manifest entry/shard ``crc32`` fields.
    # The batcher re-ranges sinks when it folds requests into a slab.
    checksum_sinks: Optional[
        List[Tuple[Callable[[int], None], Optional[Tuple[int, int]]]]
    ] = None
    # receives the staged object's [crc32, adler32, size]
    digest_sink: Optional[Callable[[List[int]], None]] = None
    # incremental takes: (base snapshot url, that base's object digest
    # (crc32, adler32, size) at this same location).  When the staged
    # object's digest equals it, the write becomes
    # ``StoragePlugin.link_from`` (a hardlink on fs): two independent
    # checksums and the exact length, so one crc32 collision cannot link
    # stale content
    dedup: Optional[Tuple[str, Tuple[int, int, int]]] = None
    # the staged object's (crc32, adler32, size), set by the take's digest
    # sink before the write is chosen; read by the dedup check
    object_digest: Optional[Tuple[int, int, int]] = None
    # the base snapshot's codec frame table for this location (None: the
    # base stored it raw).  The port cannot decode frames, so a request
    # whose base object is encoded is written, never linked
    dedup_codec: Optional[dict] = None


def check_read_crc(read_req: "ReadReq", buf: Any) -> None:
    """VERIFY_ON_RESTORE: fail when a whole-payload read does not match
    its recorded checksum (the scheduler's request-level check and the
    batcher's per-member slice check)."""
    from .utils.checksums import crc32_fast

    expected = read_req.expected_crc32
    actual = crc32_fast(memoryview(buf).cast("B"))
    if actual != expected:
        raise RuntimeError(
            f"checksum mismatch reading {read_req.path!r} "
            f"(range {read_req.byte_range}): recorded crc32={expected}, "
            f"read crc32={actual} — the payload changed after commit"
        )


@dataclass
class ReadReq:
    path: str
    buffer_consumer: BufferConsumer
    byte_range: Optional[List[int]] = None  # [start, end)
    # the recorded crc32 when this read covers one payload exactly (a
    # whole entry or chunk, never a tile); checked before consume when
    # the VERIFY_ON_RESTORE knob is on
    expected_crc32: Optional[int] = None
    # restore ordering (``restore(priority=)``): lower values are admitted
    # first, stable within a class.  An ordering hint only
    priority: int = 0


@dataclass
class WriteIO:
    path: str
    buf: Any  # bytes | memoryview | uint8 array
    # fdatasync'd, with the directory chain fsync'd too: set for the
    # commit-point write (.snapshot_metadata) only
    durable: bool = False
    # the scheduler deferred this buffer's digest to the write: a plugin
    # with ``supports_fused_digest`` computes (crc32, adler32) of the
    # bytes in the pass that writes them and sets ``digests``; one that
    # leaves it None has the scheduler compute them after the write
    want_digest: bool = False
    digests: Optional[Tuple[int, int]] = None


@dataclass
class ReadIO:
    path: str
    byte_range: Optional[List[int]] = None
    buf: Any = field(default=None)  # filled by the plugin
    # a writable buffer of exactly the read's length: a plugin may read
    # into it and set ``buf = into`` (consumers test ``buf is into``)
    into: Any = None


def run_in_fresh_loop(coro: Coroutine) -> Any:
    """Run ``coro`` to completion from sync code, also when the calling
    thread already runs an event loop (then on a private loop in a
    helper thread)."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        return pool.submit(asyncio.run, coro).result()


class StoragePlugin(abc.ABC):
    # whether ``write`` honours ``WriteIO.want_digest``
    supports_fused_digest = False

    @abc.abstractmethod
    async def write(self, write_io: WriteIO) -> None: ...

    @abc.abstractmethod
    async def read(self, read_io: ReadIO) -> None: ...

    async def delete(self, path: str) -> None:
        """Remove one object; FileNotFoundError if absent."""
        raise NotImplementedError

    async def stat(self, path: str) -> int:
        """Object size in bytes; FileNotFoundError if absent.  The default
        reads the whole object; plugins override with a metadata call."""
        read_io = ReadIO(path=path)
        await self.read(read_io)
        return memoryview(read_io.buf).cast("B").nbytes

    async def link_from(self, base_url: str, path: str) -> None:
        """Make ``path`` under this plugin's root hold the bytes of
        ``path`` under ``base_url`` without moving them through this
        process where the backend can (fs: a hardlink).  The result is
        this snapshot's own: deleting the base leaves it intact.
        NotImplementedError (or any error) makes the caller write the
        bytes instead."""
        raise NotImplementedError

    async def close(self) -> None:
        pass

    def sync_write(self, write_io: WriteIO) -> None:
        run_in_fresh_loop(self.write(write_io))

    def sync_read(self, read_io: ReadIO) -> None:
        run_in_fresh_loop(self.read(read_io))

    def sync_delete(self, path: str) -> None:
        run_in_fresh_loop(self.delete(path))

    def sync_stat(self, path: str) -> int:
        return run_in_fresh_loop(self.stat(path))

    def sync_close(self) -> None:
        run_in_fresh_loop(self.close())
