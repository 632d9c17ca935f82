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
  against a backend, and ``begin_striped_write`` for a plugin that takes
  an object as concurrent parts (``StripedWriteHandle``,
  ``storage/stripe.py``).
- A stager that can produce its bytes part by part (``part_plan``,
  ``stage_part``, ``release_source``) lets the scheduler overlap a large
  object's staging and writes within the object.
- Buffer ownership: a stager whose ``stage_buffer`` returns a buffer of
  its own making, which nothing else refers to or will write, sets
  ``stages_private_buffer`` (a CUDA tensor's pinned copy, a slab K1
  packed).  The scheduler carries that to the write as
  ``WriteIO.owned``, and a plugin with ``adopts_private_buffers``
  (``memory://``) keeps such a buffer as the stored object instead of
  copying it.  A view of a caller's array is never private.
- ``ReadIO.want_mmap`` asks a plugin with ``supports_mmap_read`` for a
  zero-copy read: a buffer over a private file-backed mapping, which
  ``is_mmap_backed`` recognises (through numpy views, memoryviews and
  tensors made over them).

On the GPU the stager's device→host copy is a ``cudaMemcpyAsync`` into
pinned host memory on a side copy stream, waited on by an event in a
worker thread (see ``preparers/array.py``).
"""

from __future__ import annotations

import abc
import asyncio
import bisect
import concurrent.futures
import mmap as _mmap
import threading
import weakref
from concurrent.futures import Executor
from dataclasses import dataclass, field
from typing import Any, Callable, Coroutine, Dict, Generic, List, Optional, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


class Future(Generic[T]):
    """A placeholder for a value produced after read execution completes."""

    __slots__ = ("obj",)

    def __init__(self, obj: Optional[T] = None) -> None:
        self.obj = obj

    def set(self, obj: T) -> None:
        self.obj = obj


class BufferStager(abc.ABC):
    # byte-shuffle stride the codec applies before compressing this
    # stager's bytes (``codec.filter_for_dtype``; 0: no filter)
    codec_filter_stride: int = 0
    # ``stage_buffer`` returns a buffer this stager made, that nothing
    # else refers to or will write: its write is ``WriteIO.owned``
    stages_private_buffer: bool = False

    @abc.abstractmethod
    async def stage_buffer(self, executor: Optional[Executor] = None) -> Any:
        """Produce the bytes to write (bytes / memoryview / uint8 array).
        Heavy host work runs on ``executor``."""

    @abc.abstractmethod
    def get_staging_cost_bytes(self) -> int:
        """Peak host memory consumed while the staged buffer is alive."""

    # part streaming: the defaults stage whole
    def part_plan(self, part_size_bytes: int) -> Optional[List[Tuple[int, int]]]:
        """``[start, end)`` spans that exactly tile the staged bytes (the
        last may be short), known before staging, or None when this
        stager stages whole only."""
        return None

    async def stage_part(
        self, span: Tuple[int, int], executor: Optional[Executor] = None
    ) -> Any:
        """The bytes of one span of ``part_plan``, independent of the
        other parts' buffers."""
        raise NotImplementedError

    def release_source(self) -> None:
        """Drop the staging source after the last ``stage_part`` call,
        whether it succeeded or not."""


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
        Asked for when a read that is not mapped starts, whole or ranged,
        so only reads in flight hold one; a consumer tests honour by
        identity."""
        return None

    def provides_read_buffer(self) -> bool:
        """Whether a ranged read must land in ``read_buffer``'s buffer
        (pinned tiles): such a read is never served mapped.  A consumer
        that only offers a buffer leaves the scheduler's mapping as it
        is."""
        return False


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
    # base stored it raw); a linked object's table is carried verbatim
    # into this snapshot's ``codecs`` through ``codec_sink``
    dedup_codec: Optional[dict] = None
    # receives the object's codec frame table when the write encodes it
    # (codec.py); writes without a sink are never encoded
    codec_sink: Optional[Callable[[dict], None]] = None
    # content-addressed takes (``cas.CasWriteContext``): the staged bytes
    # go to the chunk pool as content-keyed chunks and the object's chunk
    # table to the context's sink; never combined with ``dedup`` or a codec
    cas: Optional[Any] = None


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
    # ``buf`` is the take's private staged copy (its stager's
    # ``stages_private_buffer``) and nothing reads or writes it once this
    # write returns: a plugin with ``adopts_private_buffers`` may keep
    # it as the stored object; any other plugin ignores the flag
    owned: bool = False


@dataclass
class ReadIO:
    path: str
    byte_range: Optional[List[int]] = None
    buf: Any = field(default=None)  # filled by the plugin
    # a writable buffer of exactly the read's length: a plugin may read
    # into it and set ``buf = into`` (consumers test ``buf is into``)
    into: Any = None
    # zero-copy request: a plugin with ``supports_mmap_read`` may serve the
    # read as a uint8 array over a private, writable file-backed mapping
    # (writes to it never reach the file); callers test honour with
    # ``is_mmap_backed(buf)``.  Never set together with ``into``
    want_mmap: bool = False


# address ranges of the live mappings ``register_mapping`` was given:
# torch.frombuffer keeps no Python reference to its buffer, so a tensor
# over a mapping is recognised by where its memory lies
_MAPS_LOCK = threading.Lock()
_MAP_STARTS: List[int] = []
_MAP_ENDS: Dict[int, int] = {}


def _unregister(start: int) -> None:
    with _MAPS_LOCK:
        if _MAP_ENDS.pop(start, None) is not None:
            del _MAP_STARTS[bisect.bisect_left(_MAP_STARTS, start)]


def register_mapping(arr: np.ndarray) -> None:
    """Record the memory of ``arr`` (a uint8 array over an ``mmap.mmap``)
    as mapped for as long as ``arr`` lives."""
    start = arr.ctypes.data
    if not arr.nbytes:
        return
    with _MAPS_LOCK:
        if start in _MAP_ENDS:
            return
        bisect.insort(_MAP_STARTS, start)
        _MAP_ENDS[start] = start + arr.nbytes
    weakref.finalize(arr, _unregister, start)


def _in_mapping(ptr: int) -> bool:
    with _MAPS_LOCK:
        i = bisect.bisect_right(_MAP_STARTS, ptr) - 1
        return i >= 0 and ptr < _MAP_ENDS[_MAP_STARTS[i]]


def is_mmap_backed(buf: Any) -> bool:
    """True when ``buf`` is (a view over) an ``mmap.mmap``: walks numpy's
    ``.base`` and memoryview's ``.obj`` chain, and takes a tensor by the
    address of its memory (inside a registered mapping)."""
    o = buf
    for _ in range(8):  # ownership chains are shallow; bound the walk
        if o is None:
            return False
        if isinstance(o, _mmap.mmap):
            return True
        if hasattr(o, "data_ptr") and hasattr(o, "untyped_storage"):
            return o.numel() > 0 and _in_mapping(o.data_ptr())
        o = o.obj if isinstance(o, memoryview) else getattr(o, "base", None)
    return False


def resolve_read_destination(into: Any, length: int) -> Any:
    """The buffer a ``length``-byte read lands in: ``into`` itself when it
    is a writable buffer of exactly that length (callers test honour by
    identity), else a fresh uninitialised one (zeroing memory the read
    is about to overwrite would cost a full extra pass)."""
    if into is not None:
        try:
            v = memoryview(into).cast("B")
            if not v.readonly and v.nbytes == length:
                return into
        except (TypeError, ValueError):
            pass
    return np.empty(length, dtype=np.uint8)


async def run_on(executor: Optional[Executor], fn: Callable[..., T], *args: Any) -> T:
    """``fn(*args)`` on a thread of ``executor``, awaited; inline on the
    calling (loop) thread when there is no executor."""
    if executor is None:
        return fn(*args)
    return await asyncio.get_running_loop().run_in_executor(executor, fn, *args)


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


class StripedWriteHandle(abc.ABC):
    """One striped write of one object, from
    ``StoragePlugin.begin_striped_write``.  Parts may be written
    concurrently and in any order; then exactly one of ``complete`` (the
    atomic publish) or ``abort`` (leaves nothing behind) ends it.  Retry,
    failpoints and the breaker act inside ``write_part``, so a transient
    re-sends one part."""

    # whether write_part honours ``want_digest`` by digesting the part in
    # the pass that writes it
    supports_fused_digest: bool = False
    # the smallest part the backend takes in any position but the last
    # (0: no floor); an encoded frame below it is stored raw
    min_part_bytes: int = 0

    @abc.abstractmethod
    async def write_part(
        self, index: int, offset: int, buf: Any, want_digest: bool = False
    ) -> Optional[Tuple[int, int]]:
        """Write ``buf`` at byte ``offset`` as part ``index``; returns its
        (crc32, adler32) when ``want_digest`` and the handle fuses
        digests, else None."""

    @abc.abstractmethod
    async def complete(self) -> None:
        """Publish the assembled object atomically."""

    @abc.abstractmethod
    async def abort(self) -> None:
        """Tear down without publishing; idempotent, never raises over
        the failure that caused it."""


class StoragePlugin(abc.ABC):
    # whether ``write`` honours ``WriteIO.want_digest``
    supports_fused_digest = False
    # whether ``begin_striped_write`` is implemented (ranged reads need
    # no flag: every plugin honours ``ReadIO.byte_range``)
    supports_striped_write = False
    # whether the striped handles honour ``want_digest``, known before a
    # handle exists
    supports_fused_part_digest = False
    # whether ``read`` honours ``ReadIO.want_mmap``
    supports_mmap_read = False
    # whether ``write`` keeps an ``owned`` buffer as the stored object
    # (no copy; ``want_digest`` digests it where it lies): the scheduler
    # writes such a buffer whole, never striped or part-streamed
    adopts_private_buffers = False
    # stricter: every read this plugin serves stays off the heap (a local
    # file map that never declines); the read scheduler admits mapped
    # reads outside the budget, and never stripes them, on this flag only
    mmap_budget_exempt = False

    async def begin_striped_write(self, path: str, total_size: int) -> StripedWriteHandle:
        """Open a striped write of at most ``total_size`` bytes to
        ``path``; called only when ``supports_striped_write``."""
        raise NotImplementedError

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
