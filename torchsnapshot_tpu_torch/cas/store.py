"""The chunk pool of a content-addressed snapshot root.

Counterpart of ``torchsnapshot_tpu/cas/store.py``, byte for byte on
disk.  A chunk is an immutable byte range of a staged storage object,
named by its content key ``<crc32>-<adler32>-<size>`` (hex, hex,
decimal): two independent checksums and the exact length, so one 32-bit
collision cannot alias two chunks.  Chunks live at ``objects/<kk>/<key>``
under the pool root (``<manager-root>/cas`` by default), shared by every
step that references them; ``index.py`` counts the references.

Write side: a take digests each staged object in ``chunk_size`` spans
(fixed boundaries, so an unchanged slice of a mutated tensor keeps its
key) and writes only the chunks the committed index does not hold.
``cas_streamed_write`` does the same part by part while later parts
stage, so an unchanged part releases its admission window as soon as
its digest resolves.  Chunks are cut from the raw staged bytes and the
manifest's crc32s stay the raw ones.

Read side: ``chunked_read`` maps a raw byte range onto the chunks it
overlaps and reads them in parallel into one buffer (``into`` when it
fits, as striped and framed reads do).  Every semaphore wait here has
the stripe engine's deadline (``stripe.WAIT_DEADLINE_S``).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from .. import obs
from ..io_types import ReadIO, StoragePlugin, WriteIO, resolve_read_destination
from ..resilience.failpoints import failpoint
from ..storage.stripe import Slot, part_concurrency, plan_parts
from ..utils.checksums import digest

CHUNK_DIR = "objects"


def chunk_key(dig: Tuple[int, int, int]) -> str:
    """Content key of a chunk digest ``(crc32, adler32, size)``."""
    crc, adler, size = dig
    return f"{crc:08x}-{adler:08x}-{int(size)}"


def key_size(key: str) -> int:
    """The exact byte length a key's content has (part of the key)."""
    return int(key.rsplit("-", 1)[1])


def chunk_location(key: str) -> str:
    # a two-hex-character fan-out keeps any one directory small
    return f"{CHUNK_DIR}/{key[:2]}/{key}"


def make_table(chunk_size: int, size: int, keys: List[str]) -> Dict[str, Any]:
    """The metadata's chunk table of one storage object: its raw bytes are
    the concatenation of ``keys``' chunks, tiled at ``chunk_size`` (the
    last one short)."""
    return {"chunk_size": int(chunk_size), "size": int(size), "keys": list(keys)}


def validate_table(table: Any) -> bool:
    """Structural check: a table that fails it is treated as absent (the
    object is read as plain storage, and fails there, never assembling
    garbage)."""
    if not isinstance(table, dict):
        return False
    try:
        chunk_size = int(table["chunk_size"])
        size = int(table["size"])
        keys = table["keys"]
    except (KeyError, TypeError, ValueError):
        return False
    if chunk_size <= 0 or size < 0 or not isinstance(keys, list):
        return False
    spans = plan_parts(size, chunk_size)
    if len(keys) != len(spans):
        return False
    for key, (lo, hi) in zip(keys, spans):
        try:
            if key_size(str(key)) != hi - lo:
                return False
        except (ValueError, IndexError):
            return False
    return True


def diff_tables(
    old: Optional[Dict[str, Any]], new: Dict[str, Any]
) -> Tuple[List[int], List[int]]:
    """Positional chunk delta of two tables of one object: ``(changed,
    reused)`` indexes into ``new["keys"]``.  A chunk is reused only when
    ``old`` holds the same key at the same offset; ``old=None`` or a
    different chunk size marks every chunk changed."""
    keys = list(new["keys"])
    if old is None or int(old.get("chunk_size", -1)) != int(new["chunk_size"]):
        return list(range(len(keys))), []
    old_keys = list(old["keys"])
    changed: List[int] = []
    reused: List[int] = []
    for i, key in enumerate(keys):
        (reused if i < len(old_keys) and old_keys[i] == key else changed).append(i)
    return changed, reused


def record_root(snapshot_path: str, cas_root: str) -> str:
    """The pool root as a snapshot's metadata records it: ``../<name>``
    when the pool is a sibling of the snapshot directory (the manager
    layout, so a moved checkpoint tree keeps restoring), else verbatim."""
    snap = snapshot_path.rstrip("/")
    root = cas_root.rstrip("/")
    parent = snap.rsplit("/", 1)[0] if "/" in snap else ""
    if parent and root.startswith(parent + "/"):
        rest = root[len(parent) + 1:]
        if rest and "/" not in rest:
            return f"../{rest}"
    return root


def resolve_root(snapshot_path: str, recorded: str) -> str:
    """The inverse of ``record_root`` at read time."""
    if recorded.startswith("../"):
        snap = snapshot_path.rstrip("/")
        parent = snap.rsplit("/", 1)[0] if "/" in snap else ""
        return f"{parent}/{recorded[3:]}" if parent else recorded[3:]
    return recorded


class ChunkStore:
    """Plugin-backed access to one pool root: paths and idempotent chunk
    I/O only (what to write, skip or delete is the callers')."""

    def __init__(self, root: str, storage: Optional[StoragePlugin] = None) -> None:
        self.root = root.rstrip("/")
        self._storage = storage

    @property
    def storage(self) -> StoragePlugin:
        if self._storage is None:
            from ..storage import url_to_storage_plugin

            self._storage = url_to_storage_plugin(self.root)
        return self._storage

    async def has(self, key: str) -> bool:
        try:
            return await self.storage.stat(chunk_location(key)) == key_size(key)
        except FileNotFoundError:
            return False

    async def put(self, key: str, buf: Any) -> bool:
        """Store ``buf`` under ``key`` unless an intact copy is already
        there; True when bytes were written.  Two puts of one key are
        safe: both write the same content, and the plugin publishes
        atomically (temp file and rename on fs)."""
        failpoint("cas.chunk.put", key=key)
        if await self.has(key):
            return False
        await self.storage.write(WriteIO(path=chunk_location(key), buf=buf))
        return True

    async def read_chunk(
        self, key: str, byte_range: Optional[Tuple[int, int]] = None, into: Any = None
    ) -> Any:
        rio = ReadIO(
            path=chunk_location(key),
            byte_range=list(byte_range) if byte_range else None,
            into=into,
        )
        await self.storage.read(rio)
        return rio.buf

    async def stat(self, key: str) -> int:
        return await self.storage.stat(chunk_location(key))

    async def delete(self, key: str) -> None:
        await self.storage.delete(chunk_location(key))

    def sync_close(self) -> None:
        if self._storage is not None:
            self._storage.sync_close()
            self._storage = None


@dataclass
class CasWriteContext:
    """What one write request needs to go through the pool, attached by
    the take and read by the scheduler.  ``known_keys`` is the committed
    index's live key set at the take's start (orphan-marked chunks are
    left out: one may be swept while the take runs, so its content is
    written again).  ``sink`` receives the object's chunk table."""

    store: ChunkStore
    known_keys: Set[str]
    chunk_size: int
    sink: Callable[[Dict[str, Any]], None]
    # chunks written by this take, shared by its requests: repeats within
    # a take (tied weights, equal slabs) are written once
    written_this_take: Set[str] = field(default_factory=set)


def _digest_piece(piece: Any) -> Tuple[int, int, int]:
    v = memoryview(piece).cast("B")
    return (*digest(v), v.nbytes)


class _Tally:
    """The cas.* counters, and the bytes one write moved or shared."""

    def __init__(self) -> None:
        self.written = 0
        self.shared = 0

    def wrote(self, n: int) -> None:
        self.written += n
        obs.counter(obs.CAS_BYTES_WRITTEN).inc(n)
        obs.counter(obs.CAS_CHUNKS_WRITTEN).inc()

    def share(self, n: int) -> None:
        self.shared += n
        obs.counter(obs.CAS_BYTES_SHARED).inc(n)
        obs.counter(obs.CAS_CHUNKS_SHARED).inc()


async def _digest_on(executor: Any, piece: Any) -> Tuple[int, int, int]:
    if executor is None:
        return _digest_piece(piece)
    return await asyncio.get_running_loop().run_in_executor(executor, _digest_piece, piece)


async def _gather_all(aws: List[Any]) -> None:
    """Run every task to its end, then raise the first error."""
    results = await asyncio.gather(*aws, return_exceptions=True)
    errs = [r for r in results if isinstance(r, BaseException)]
    if errs:
        raise errs[0]


async def chunked_write(
    ctx: CasWriteContext, path: str, buf: Any, executor: Any = None
) -> Tuple[Dict[str, Any], int, int]:
    """Store a whole-staged buffer as chunks: digest each span (on
    ``executor``), write the chunks no committed step holds, hand the
    table to ``ctx.sink``.  Returns ``(table, bytes_written,
    bytes_shared)``."""
    view = memoryview(buf).cast("B")
    total = view.nbytes
    spans = plan_parts(total, ctx.chunk_size)
    keys: List[Optional[str]] = [None] * len(spans)
    sem = asyncio.Semaphore(part_concurrency())
    tally = _Tally()

    with obs.span("cas/chunked_write", path=path, bytes=total, chunks=len(spans)):

        async def one(idx: int, lo: int, hi: int) -> None:
            piece = view[lo:hi]
            key = keys[idx] = chunk_key(await _digest_on(executor, piece))
            if key in ctx.known_keys or key in ctx.written_this_take:
                tally.share(hi - lo)
                return
            ctx.written_this_take.add(key)
            async with Slot(sem, f"chunk {idx} of {path!r} waiting for a slot"):
                with obs.span("cas/put_chunk", key=key, bytes=hi - lo):
                    did_write = await ctx.store.put(key, piece)
            # not written: durable already (an uncommitted earlier take, or
            # a rank racing this one), so shared
            (tally.wrote if did_write else tally.share)(hi - lo)

        await _gather_all([one(i, lo, hi) for i, (lo, hi) in enumerate(spans)])
    table = make_table(ctx.chunk_size, total, keys)
    ctx.sink(table)
    return table, tally.written, tally.shared


async def cas_streamed_write(
    ctx: CasWriteContext,
    path: str,
    stager: Any,
    spans: List[Tuple[int, int]],
    executor: Any,
    *,
    window_parts: int,
    on_part_staged: Optional[Callable[[int], None]] = None,
    on_part_done: Optional[Callable[[int], None]] = None,
    on_part_shared: Optional[Callable[[int], None]] = None,
) -> List[Tuple[int, int, int]]:
    """Stage, digest and store one object part by part through the pool
    (the chunk twin of ``stripe.streamed_part_write``): part N is staged
    and digested (the key is the dedup lookup, so before any write), then
    skipped or stored while later parts stage; at most ``window_parts``
    parts are held at once.  ``spans`` tile the object at
    ``ctx.chunk_size``.  Returns the parts' raw digests in order, for the
    caller to fold into the object's."""
    total = spans[-1][1]
    digests: List[Optional[Tuple[int, int, int]]] = [None] * len(spans)
    keys: List[Optional[str]] = [None] * len(spans)
    window = asyncio.Semaphore(window_parts)
    m_phase_stage = obs.histogram(obs.PHASE_STAGE_S)
    m_phase_write = obs.histogram(obs.PHASE_WRITE_S)
    tally = _Tally()

    def shared(n: int) -> None:
        tally.share(n)
        if on_part_shared is not None:
            on_part_shared(n)
        if on_part_done is not None:
            on_part_done(0)

    with obs.span("cas/stream_write", path=path, bytes=total, chunks=len(spans)):

        async def one(idx: int, span: Tuple[int, int]) -> None:
            lo, hi = span
            async with Slot(window, f"part {idx} of {path!r} waiting for window credit"):
                t_stage = time.perf_counter()
                failpoint("scheduler.stage.part", path=path, part=idx)
                with obs.span("cas/stage_part", path=path, part=idx, bytes=hi - lo):
                    piece = await stager.stage_part(span, executor)
                m_phase_stage.observe(time.perf_counter() - t_stage)
                if on_part_staged is not None:
                    on_part_staged(hi - lo)
                dig = digests[idx] = await _digest_on(executor, piece)
                key = keys[idx] = chunk_key(dig)
                if key in ctx.known_keys or key in ctx.written_this_take:
                    # in the pool already: the part is dropped here and its
                    # window credit returns without a storage operation
                    shared(hi - lo)
                    return
                ctx.written_this_take.add(key)
                t0 = time.perf_counter()
                with obs.span("cas/put_chunk", key=key, part=idx, bytes=hi - lo):
                    did_write = await ctx.store.put(key, piece)
                m_phase_write.observe(time.perf_counter() - t0)
                if not did_write:
                    shared(hi - lo)
                    return
                tally.wrote(hi - lo)
                if on_part_done is not None:
                    on_part_done(hi - lo)

        try:
            # a failed take leaves its written chunks unreferenced: orphans
            # the two-phase GC reclaims
            await _gather_all([one(i, s) for i, s in enumerate(spans)])
        finally:
            stager.release_source()
    ctx.sink(make_table(ctx.chunk_size, total, keys))
    return [d for d in digests if d is not None]


async def chunked_read(
    store: ChunkStore,
    path: str,
    table: Dict[str, Any],
    byte_range: Optional[List[int]] = None,
    into: Any = None,
) -> Any:
    """Bytes ``[start, end)`` of a chunk-referenced object's raw stream:
    parallel ranged reads of the chunks that overlap it, assembled into
    one buffer (``into`` itself when it fits: callers test identity)."""
    chunk_size = int(table["chunk_size"])
    size = int(table["size"])
    keys = table["keys"]
    start, end = (0, size) if byte_range is None else (int(byte_range[0]), int(byte_range[1]))
    if not 0 <= start <= end <= size:
        raise ValueError(
            f"byte range [{start}, {end}) outside chunked object {path!r} of size {size}"
        )
    length = end - start
    out = resolve_read_destination(into, length)
    out_view = memoryview(out).cast("B")
    sem = asyncio.Semaphore(part_concurrency())

    with obs.span("cas/chunked_read", path=path, bytes=length):

        async def one(idx: int) -> None:
            clo = idx * chunk_size
            chi = min(clo + chunk_size, size)
            lo, hi = max(start, clo), min(end, chi)
            dst = out_view[lo - start:hi - start]
            rng = None if (lo, hi) == (clo, chi) else (lo - clo, hi - clo)
            async with Slot(sem, f"chunk {idx} of {path!r} waiting for a slot"):
                buf = await store.read_chunk(keys[idx], rng, into=dst)
            if buf is not dst:
                got = memoryview(buf).cast("B")
                if got.nbytes != hi - lo:
                    raise IOError(
                        f"chunk {keys[idx]} of {path!r} returned {got.nbytes} "
                        f"bytes, wanted {hi - lo}"
                    )
                dst[:] = got

        if length:
            await _gather_all(
                [one(i) for i in range(start // chunk_size, (end - 1) // chunk_size + 1)]
            )
    return out
