"""Budgeted async execution engine for write/read pipelines.

Counterpart of ``torchsnapshot_tpu/scheduler.py``, same discipline:

- Write path: ``ready_for_staging → staging → ready_for_io → io →
  done``, returned as a ``PendingIOWork`` whose I/O drains on its own
  loop thread: ``take`` waits for all of it, ``async_take`` for staging
  at most (none after the eager copies of ``host_offload.py``).  A request is admitted to staging iff its cost fits the
  remaining host-memory budget, or nothing else is in flight (progress
  for oversized items).  The budget is debited by the declared staging
  cost, corrected to the staged size, and credited when the write lands.
- Concurrent storage operations are capped per process.
- Read path: admit reads under the consuming-cost budget and chain each
  completed read into a consume task; under VERIFY_ON_RESTORE a read
  that covers one payload is checked against its recorded crc32 before
  it is consumed.  A consumer may hand the storage a buffer of its own
  to read into (pinned tile memory, ``BufferConsumer.read_buffer``).
- WRITE_CHECKSUMS off: no digests are computed at staging.
- Digests: a whole-buffer write to a plugin that fuses digests
  (``supports_fused_digest``, the fs plugin's fast-I/O engine) gets its
  (crc32, adler32) from the pass that writes it; a slab folds the
  per-member digests its stager recorded while packing; everything else
  is digested at staging in one native pass per piece.  Every digest
  lands before the write pipeline completes, so before any manifest is
  serialised (the commit waits for the pipeline, ``async_take``'s too).

The pipelines run on a dedicated event-loop thread; heavy work (device
copies, checksums, deserialization) runs on a thread pool.  The codec,
content-addressed store and striping of the JAX package are not ported.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from . import knobs, obs
from .io_types import (
    ReadIO,
    ReadReq,
    StoragePlugin,
    WriteIO,
    WriteReq,
    check_read_crc,
)
from .utils.checksums import combine_piece_digests, crc32_fast, digest

logger = logging.getLogger(__name__)

_MAX_PER_RANK_MEMORY_BUDGET_BYTES = 32 * 1024 * 1024 * 1024
_AVAILABLE_MEMORY_MULTIPLIER = 0.6


def _available_memory_bytes() -> int:
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def get_process_memory_budget_bytes(local_process_count: int = 1) -> int:
    """Host-memory budget for staging: the knob, else 60% of available
    memory split over the host's processes, capped at 32 GiB."""
    override = knobs.get_per_rank_memory_budget_bytes()
    if override is not None:
        return override
    budget = int(
        _available_memory_bytes() * _AVAILABLE_MEMORY_MULTIPLIER
        / max(1, local_process_count)
    )
    return min(budget, _MAX_PER_RANK_MEMORY_BUDGET_BYTES)


def _buf_nbytes(buf: Any) -> int:
    return 0 if buf is None else memoryview(buf).cast("B").nbytes


def apply_checksum_sinks(
    buf: Any, wr: WriteReq, precomputed: Optional[Dict[Tuple[int, int], Tuple[int, int, int]]] = None
) -> None:
    """Feed each sink the crc32 of its byte range of the staged buffer
    and the digest sink the whole object's [crc32, adler32, size].  Each
    piece is read once (one native pass gives both digests), and a piece
    in ``precomputed`` ({(start, end): (crc32, adler32, size)}, recorded
    by a stager that digested the bytes as it packed them) is not read
    at all.  When the sink ranges exactly tile the buffer (a slab), the
    object digest folds from the per-piece values instead of another
    pass."""
    view = memoryview(buf).cast("B")
    pre = precomputed or {}
    sinks = list(wr.checksum_sinks or ())
    spans = [(0, view.nbytes) if rng is None else tuple(rng) for _, rng in sinks]
    ordered = sorted(set(spans))
    can_fold = (
        wr.digest_sink is not None
        and bool(spans)
        and len(ordered) == len(spans)
        and ordered[0][0] == 0
        and ordered[-1][1] == view.nbytes
        and all(a[1] == b[0] for a, b in zip(ordered, ordered[1:]))
    )
    pieces = {}
    for (sink, _), span in zip(sinks, spans):
        hit = pre.get(span)
        if hit is not None and hit[2] == span[1] - span[0]:
            crc, adler = hit[0], hit[1]
        elif can_fold:
            crc, adler = digest(view[span[0]:span[1]])
        else:
            crc = crc32_fast(view[span[0]:span[1]])
        sink(crc)
        if can_fold:
            pieces[span] = (crc, adler, span[1] - span[0])
    if wr.digest_sink is None:
        return
    if can_fold:
        wr.digest_sink(list(combine_piece_digests([pieces[s] for s in ordered])))
    else:
        wr.digest_sink([*digest(view), view.nbytes])


def _defers_digest(
    wr: WriteReq, nbytes: int, storage: StoragePlugin, precomputed: Any
) -> bool:
    """Whether the digest of this staged buffer is left to its write: the
    plugin fuses digests, every sink covers the whole buffer, and the
    stager recorded no piece digests (a slab folds those instead)."""
    return (
        storage.supports_fused_digest
        and precomputed is None
        and all(
            rng is None or tuple(rng) == (0, nbytes) for _, rng in wr.checksum_sinks or ()
        )
    )


class _LoopThread:
    """A dedicated event-loop thread."""

    def __init__(self, name: str) -> None:
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self.loop.run_forever, name=name, daemon=True
        )
        self._thread.start()

    def submit(self, coro: Awaitable) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def shutdown(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join()
        self.loop.close()


class _Budget:
    def __init__(self, total: int) -> None:
        self.total = total
        self.used = 0

    def fits(self, cost: int) -> bool:
        return self.used + cost <= self.total


class _WritePipeline:
    __slots__ = ("write_req", "staging_cost", "buf", "buf_size", "defer_digest")

    def __init__(self, write_req: WriteReq) -> None:
        self.write_req = write_req
        self.staging_cost = write_req.buffer_stager.get_staging_cost_bytes()
        self.buf = None
        self.buf_size = 0
        self.defer_digest = False


async def _execute_write_pipelines(
    pipelines: List[_WritePipeline],
    storage: StoragePlugin,
    budget: _Budget,
    executor: ThreadPoolExecutor,
    stats: dict,
    staging_done: threading.Event,
) -> None:
    ready_for_staging = deque(pipelines)
    ready_for_io: deque = deque()
    staging_tasks: set = set()
    io_tasks: set = set()
    io_concurrency = knobs.get_max_per_rank_io_concurrency()
    checksums = knobs.write_checksums_enabled()
    loop = asyncio.get_running_loop()

    async def stage_one(p: _WritePipeline) -> _WritePipeline:
        with obs.span("pipeline/staging", path=p.write_req.path):
            p.buf = await p.write_req.buffer_stager.stage_buffer(executor)
            p.buf_size = _buf_nbytes(p.buf)
            wr = p.write_req
            if (wr.checksum_sinks or wr.digest_sink) and checksums:
                precomputed = getattr(wr.buffer_stager, "piece_digests", None)
                if _defers_digest(wr, p.buf_size, storage, precomputed):
                    # digested in the pass that writes the bytes (write_one)
                    p.defer_digest = True
                else:
                    await loop.run_in_executor(
                        executor, apply_checksum_sinks, p.buf, wr, precomputed
                    )
        return p

    async def write_one(p: _WritePipeline) -> _WritePipeline:
        wr = p.write_req
        with obs.span("pipeline/io", path=wr.path, bytes=p.buf_size):
            wio = WriteIO(path=wr.path, buf=p.buf, want_digest=p.defer_digest)
            await storage.write(wio)
        if p.defer_digest:
            if wio.digests is None:
                # the plugin did not fuse: the same values, one more pass
                await loop.run_in_executor(executor, apply_checksum_sinks, p.buf, wr)
            else:
                crc, adler = wio.digests
                for sink, _ in wr.checksum_sinks or ():
                    sink(crc)
                if wr.digest_sink is not None:
                    wr.digest_sink([crc, adler, p.buf_size])
        return p

    def admit(p: _WritePipeline) -> None:
        budget.used += p.staging_cost
        staging_tasks.add(asyncio.ensure_future(stage_one(p)))

    try:
        while ready_for_staging or staging_tasks or ready_for_io or io_tasks:
            if not (ready_for_staging or staging_tasks):
                staging_done.set()
            # admit every pending request that fits (largest first); when
            # nothing fits and nothing is in flight, admit the largest
            for _ in range(len(ready_for_staging)):
                p = ready_for_staging.popleft()
                if budget.fits(p.staging_cost):
                    admit(p)
                else:
                    ready_for_staging.append(p)
            if ready_for_staging and not (staging_tasks or io_tasks or ready_for_io):
                admit(ready_for_staging.popleft())
            while ready_for_io and len(io_tasks) < io_concurrency:
                io_tasks.add(asyncio.ensure_future(write_one(ready_for_io.popleft())))
            if not staging_tasks and not io_tasks:
                continue
            done, _ = await asyncio.wait(
                staging_tasks | io_tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                p = task.result()
                if task in staging_tasks:
                    staging_tasks.discard(task)
                    # correct the declared cost to the staged size
                    budget.used -= p.staging_cost - p.buf_size
                    obs.counter(obs.BYTES_STAGED).inc(p.buf_size)
                    ready_for_io.append(p)
                else:
                    io_tasks.discard(task)
                    stats["bytes_written"] += p.buf_size
                    obs.counter(obs.BYTES_WRITTEN).inc(p.buf_size)
                    budget.used -= p.buf_size
                    p.buf = None
    except BaseException:
        for t in staging_tasks | io_tasks:
            t.cancel()
        raise
    finally:
        staging_done.set()


class PendingIOWork:
    """Handle for a write pipeline whose I/O may still be draining
    (the JAX package's ``PendingIOWork``).  ``sync_complete`` waits for
    the rest, raises the pipeline's error if it failed, and stops its
    threads; the pipeline starts at construction or, when deferred, on
    the first ``sync_complete`` (the thread that commits pays for it)."""

    def __init__(
        self,
        starter: Callable[[], concurrent.futures.Future],
        loop_thread: _LoopThread,
        executor: ThreadPoolExecutor,
        stats: dict,
        rank: int,
        start_now: bool,
    ) -> None:
        self._starter = starter
        self._loop_thread = loop_thread
        self._executor = executor
        self._stats = stats
        self._rank = rank
        self._fut: Optional[concurrent.futures.Future] = starter() if start_now else None

    def sync_complete(self) -> int:
        """Wait for every write; returns the bytes written."""
        if self._fut is None:
            self._fut = self._starter()
        try:
            self._fut.result()
        finally:
            self._executor.shutdown(wait=True)
            self._loop_thread.shutdown()
        dt = max(time.monotonic() - self._stats["begin_ts"], 1e-9)
        gb = self._stats["bytes_written"] / 1e9
        logger.info(
            "rank %d: wrote %.3f GB in %.2fs (%.2f GB/s)", self._rank, gb, dt, gb / dt
        )
        return self._stats["bytes_written"]


def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
    wait_for_staging: bool = True,
) -> PendingIOWork:
    """Stage and write every request under the memory budget.  With
    ``wait_for_staging`` it returns once every request is staged (the
    I/O drains in the background); without, it returns at once and the
    whole pipeline starts on the first ``sync_complete`` — for requests
    already made independent of the caller's state.  Largest-first
    staging keeps the budget packed and starts the biggest device copies
    earliest."""
    executor = ThreadPoolExecutor(
        max_workers=knobs.get_staging_threads(), thread_name_prefix="tsnp-torch-staging"
    )
    pipelines = sorted(
        (_WritePipeline(wr) for wr in write_reqs),
        key=lambda p: p.staging_cost,
        reverse=True,
    )
    stats = {"bytes_written": 0, "begin_ts": time.monotonic()}
    staging_done = threading.Event()
    loop_thread = _LoopThread("tsnp-torch-write-loop")
    budget = _Budget(memory_budget_bytes)

    def start() -> concurrent.futures.Future:
        return loop_thread.submit(
            _execute_write_pipelines(
                pipelines, storage, budget, executor, stats, staging_done
            )
        )

    pending = PendingIOWork(start, loop_thread, executor, stats, rank, wait_for_staging)
    if wait_for_staging:
        staging_done.wait()
        if pending._fut.done() and pending._fut.exception() is not None:
            pending.sync_complete()  # raises
    return pending


class _ReadPipeline:
    __slots__ = ("read_req", "consuming_cost", "buf")

    def __init__(self, read_req: ReadReq) -> None:
        self.read_req = read_req
        self.consuming_cost = read_req.buffer_consumer.get_consuming_cost_bytes()
        self.buf = None


async def _execute_read_pipelines(
    pipelines: List[_ReadPipeline],
    storage: StoragePlugin,
    budget: _Budget,
    executor: ThreadPoolExecutor,
) -> None:
    ready_for_io = deque(pipelines)
    io_tasks: set = set()
    consume_tasks: set = set()
    io_concurrency = knobs.get_max_per_rank_io_concurrency()
    verify = knobs.verify_on_restore()

    async def read_one(p: _ReadPipeline) -> _ReadPipeline:
        rr = p.read_req
        with obs.span("pipeline/io", path=rr.path, op="read"):
            into = None
            if rr.byte_range is not None:
                into = rr.buffer_consumer.read_buffer(
                    rr.byte_range[1] - rr.byte_range[0]
                )
            read_io = ReadIO(path=rr.path, byte_range=rr.byte_range, into=into)
            await storage.read(read_io)
            p.buf = read_io.buf
        return p

    async def consume_one(p: _ReadPipeline) -> _ReadPipeline:
        with obs.span("pipeline/consume", path=p.read_req.path):
            if p.read_req.expected_crc32 is not None and verify:
                # before consume: a mismatch leaves the target untouched
                await asyncio.get_running_loop().run_in_executor(
                    executor, check_read_crc, p.read_req, p.buf
                )
            await p.read_req.buffer_consumer.consume_buffer(p.buf, executor)
            p.buf = None
        return p

    def admit(p: _ReadPipeline) -> None:
        budget.used += p.consuming_cost
        io_tasks.add(asyncio.ensure_future(read_one(p)))

    try:
        while ready_for_io or io_tasks or consume_tasks:
            for _ in range(len(ready_for_io)):
                if len(io_tasks) >= io_concurrency:
                    break
                p = ready_for_io.popleft()
                if budget.fits(p.consuming_cost):
                    admit(p)
                else:
                    ready_for_io.append(p)
            if ready_for_io and not io_tasks and not consume_tasks:
                admit(ready_for_io.popleft())
            if not io_tasks and not consume_tasks:
                continue
            done, _ = await asyncio.wait(
                io_tasks | consume_tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                p = task.result()
                if task in io_tasks:
                    io_tasks.discard(task)
                    obs.counter(obs.BYTES_READ).inc(_buf_nbytes(p.buf))
                    consume_tasks.add(asyncio.ensure_future(consume_one(p)))
                else:
                    consume_tasks.discard(task)
                    budget.used -= p.consuming_cost
    except BaseException:
        for t in io_tasks | consume_tasks:
            t.cancel()
        raise


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> int:
    """Execute read requests under the memory budget; returns the bytes
    the consumers were declared to need."""
    executor = ThreadPoolExecutor(
        max_workers=knobs.get_staging_threads(), thread_name_prefix="tsnp-torch-consume"
    )
    pipelines = [_ReadPipeline(rr) for rr in read_reqs]
    loop_thread = _LoopThread("tsnp-torch-read-loop")
    t0 = time.monotonic()
    try:
        loop_thread.submit(
            _execute_read_pipelines(
                pipelines, storage, _Budget(memory_budget_bytes), executor
            )
        ).result()
    finally:
        executor.shutdown(wait=True)
        loop_thread.shutdown()
    total = sum(p.consuming_cost for p in pipelines)
    dt = max(time.monotonic() - t0, 1e-9)
    logger.info(
        "rank %d: read %.3f GB in %.2fs (%.2f GB/s)",
        rank, total / 1e9, dt, total / 1e9 / dt,
    )
    return total
