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
- Incremental takes: a request whose staged digest equals its ``dedup``
  digest (the base snapshot's object at the same location) is linked
  from the base (``StoragePlugin.link_from``) instead of written; its
  bytes count in ``deduped_bytes`` and ``bytes_deduped``.  A link that
  fails falls back to the write.
- Read path: reads are stable-sorted by ``priority`` (all zero, the
  common case, keeps the order untouched), admitted under the
  consuming-cost budget, and each completed read chains into a consume
  task; under VERIFY_ON_RESTORE a read that covers one payload is
  checked against its recorded crc32 before it is consumed.  A consumer
  may hand the storage a buffer of its own to read into (pinned tile
  memory, ``BufferConsumer.read_buffer``).
- WRITE_CHECKSUMS off: no digests are computed at staging.
- Digests: a whole-buffer write to a plugin that fuses digests
  (``supports_fused_digest``, the fs plugin's fast-I/O engine) gets its
  (crc32, adler32) from the pass that writes it, unless it carries a
  ``dedup`` digest (link or write is decided on the digest, so it must
  exist first); a slab folds the per-member digests of its pieces;
  everything else is digested at staging in one native pass per piece.
  Every digest lands before the write pipeline completes, so before any
  manifest is serialised (the commit waits for the pipeline,
  ``async_take``'s too).

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

from . import knobs
from .io_types import (
    ReadIO,
    ReadReq,
    StoragePlugin,
    WriteIO,
    WriteReq,
    check_read_crc,
)
from .obs import metrics as obs_metrics
from .obs import tracer as obs_tracer
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
    plugin fuses digests, no dedup decision waits on the digest, every
    sink covers the whole buffer, and the stager recorded no piece
    digests (a slab folds those instead)."""
    return (
        storage.supports_fused_digest
        and wr.dedup is None
        and precomputed is None
        and all(
            rng is None or tuple(rng) == (0, nbytes) for _, rng in wr.checksum_sinks or ()
        )
    )


async def _link_unchanged(p: "_WritePipeline", storage: StoragePlugin) -> bool:
    """Link the request's object from its base snapshot when its staged
    digest equals the base's; True when linked.  A failed link (a plugin
    without ``link_from``, the base object gone) is logged and the
    caller writes the bytes: dedup never decides correctness."""
    wr = p.write_req
    if wr.dedup is None or wr.dedup_codec is not None or wr.object_digest != wr.dedup[1]:
        return False
    try:
        await storage.link_from(wr.dedup[0], wr.path)
    except Exception as e:  # noqa: BLE001 — any failure writes instead
        logger.info("dedup link for %r failed (%r); writing it", wr.path, e)
        return False
    p.deduped = True
    return True


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
    __slots__ = ("write_req", "staging_cost", "buf", "buf_size", "defer_digest", "deduped")

    def __init__(self, write_req: WriteReq) -> None:
        self.write_req = write_req
        self.staging_cost = write_req.buffer_stager.get_staging_cost_bytes()
        self.buf = None
        self.buf_size = 0
        self.defer_digest = False
        self.deduped = False


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
    # observability, as the JAX package's write loop: counters, gauges and
    # the phase clocks are always on (one locked add per transition);
    # spans exist only under the TRACE knob.  Budget-admission spans open
    # per request at pipeline start and close at admission; a flow id
    # recorded at staging completion links each staging span to its
    # storage-I/O span (the Perfetto arrow).  Stage seconds end once the
    # host holds the bytes (the stagers wait on the device-to-host
    # copy's event inside stage_buffer).
    m_staged = obs_metrics.counter(obs_metrics.BYTES_STAGED)
    m_written = obs_metrics.counter(obs_metrics.BYTES_WRITTEN)
    m_deduped = obs_metrics.counter(obs_metrics.BYTES_DEDUPED)
    m_budget = obs_metrics.gauge(obs_metrics.BUDGET_BYTES_IN_USE)
    m_ioq = obs_metrics.gauge(obs_metrics.IO_QUEUE_DEPTH)
    m_phase_stage = obs_metrics.histogram(obs_metrics.PHASE_STAGE_S)
    m_phase_write = obs_metrics.histogram(obs_metrics.PHASE_WRITE_S)
    tracer = obs_tracer.get_tracer()
    adm_spans: dict = {}
    flow_ids: dict = {}
    if obs_tracer.ENABLED:
        for p in pipelines:
            adm_spans[id(p)] = tracer.begin(
                "pipeline/budget_admission", path=p.write_req.path, bytes=p.staging_cost
            )

    async def stage_one(p: _WritePipeline) -> _WritePipeline:
        with obs_tracer.span(
            "pipeline/staging", path=p.write_req.path, cost=p.staging_cost
        ) as sp:
            t_stage = time.perf_counter()
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
            m_phase_stage.observe(time.perf_counter() - t_stage)
            if sp is not None:
                sp.attrs["bytes"] = p.buf_size
                sp.flow_out = flow_ids[id(p)] = obs_tracer.next_flow_id()
        return p

    async def write_one(p: _WritePipeline) -> _WritePipeline:
        wr = p.write_req
        with obs_tracer.span("pipeline/io", path=wr.path, bytes=p.buf_size) as sp:
            if sp is not None:
                fid = flow_ids.pop(id(p), None)
                if fid is not None:
                    sp.flow_in = fid
            t_write = time.perf_counter()
            try:
                if await _link_unchanged(p, storage):
                    return p
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
            finally:
                m_phase_write.observe(time.perf_counter() - t_write)
        return p

    def admit(p: _WritePipeline) -> None:
        budget.used += p.staging_cost
        m_budget.set(budget.used)
        sp = adm_spans.pop(id(p), None)
        if sp is not None:
            tracer.end(sp, fire_event=True)
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
            m_ioq.set(len(ready_for_io))
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
                    m_budget.set(budget.used)
                    m_staged.inc(p.buf_size)
                    ready_for_io.append(p)
                    m_ioq.set(len(ready_for_io))
                else:
                    io_tasks.discard(task)
                    if p.deduped:  # a linked object moved no bytes
                        stats["deduped_bytes"] += p.buf_size
                        m_deduped.inc(p.buf_size)
                    else:
                        stats["bytes_written"] += p.buf_size
                        m_written.inc(p.buf_size)
                    budget.used -= p.buf_size
                    m_budget.set(budget.used)
                    p.buf = None
    except BaseException:
        for t in staging_tasks | io_tasks:
            t.cancel()
        raise
    finally:
        staging_done.set()
        # requests never admitted (error or cancel) close their admission
        # spans here, so the trace has no dangling opens
        for sp in adm_spans.values():
            sp.attrs["error"] = True
            tracer.end(sp, fire_event=True)
        adm_spans.clear()


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
            "rank %d: wrote %.3f GB in %.2fs (%.2f GB/s), linked %.3f GB unchanged",
            self._rank, gb, dt, gb / dt, self._stats["deduped_bytes"] / 1e9,
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
    stats = {"bytes_written": 0, "deduped_bytes": 0, "begin_ts": time.monotonic()}
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
    # the write loop's instruments, direction-suffixed: an async_take's
    # background drain can overlap a restore in this process.  Consume
    # seconds end once the host-to-device copies and kernels K2/K6 are
    # enqueued (a budgeted tile waits for its copy: its pinned buffer is
    # reused).
    m_read = obs_metrics.counter(obs_metrics.BYTES_READ)
    m_budget = obs_metrics.gauge(obs_metrics.BUDGET_BYTES_IN_USE_READ)
    m_ioq = obs_metrics.gauge(obs_metrics.IO_QUEUE_DEPTH_READ)
    m_phase_read = obs_metrics.histogram(obs_metrics.PHASE_READ_S)
    m_phase_consume = obs_metrics.histogram(obs_metrics.PHASE_CONSUME_S)
    tracer = obs_tracer.get_tracer()
    adm_spans: dict = {}
    if obs_tracer.ENABLED:
        for p in pipelines:
            adm_spans[id(p)] = tracer.begin(
                "pipeline/budget_admission", path=p.read_req.path, bytes=p.consuming_cost
            )

    async def read_one(p: _ReadPipeline) -> _ReadPipeline:
        rr = p.read_req
        with obs_tracer.span(
            "pipeline/io", path=rr.path, cost=p.consuming_cost, op="read"
        ) as sp:
            t_read = time.perf_counter()
            try:
                into = None
                if rr.byte_range is not None:
                    into = rr.buffer_consumer.read_buffer(
                        rr.byte_range[1] - rr.byte_range[0]
                    )
                read_io = ReadIO(path=rr.path, byte_range=rr.byte_range, into=into)
                await storage.read(read_io)
                p.buf = read_io.buf
                if sp is not None:
                    sp.attrs["bytes"] = _buf_nbytes(p.buf)
            finally:
                m_phase_read.observe(time.perf_counter() - t_read)
        return p

    async def consume_one(p: _ReadPipeline) -> _ReadPipeline:
        with obs_tracer.span(
            "pipeline/consume", path=p.read_req.path, cost=p.consuming_cost
        ) as sp:
            if sp is not None:
                sp.attrs["bytes"] = _buf_nbytes(p.buf)
            t_consume = time.perf_counter()
            if p.read_req.expected_crc32 is not None and verify:
                # before consume: a mismatch leaves the target untouched
                await asyncio.get_running_loop().run_in_executor(
                    executor, check_read_crc, p.read_req, p.buf
                )
            await p.read_req.buffer_consumer.consume_buffer(p.buf, executor)
            p.buf = None
            m_phase_consume.observe(time.perf_counter() - t_consume)
        return p

    def admit(p: _ReadPipeline) -> None:
        budget.used += p.consuming_cost
        m_budget.set(budget.used)
        sp = adm_spans.pop(id(p), None)
        if sp is not None:
            tracer.end(sp, fire_event=True)
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
            m_ioq.set(len(ready_for_io))
            if not io_tasks and not consume_tasks:
                continue
            done, _ = await asyncio.wait(
                io_tasks | consume_tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                p = task.result()
                if task in io_tasks:
                    io_tasks.discard(task)
                    m_read.inc(_buf_nbytes(p.buf))
                    consume_tasks.add(asyncio.ensure_future(consume_one(p)))
                else:
                    consume_tasks.discard(task)
                    budget.used -= p.consuming_cost
                    m_budget.set(budget.used)
    except BaseException:
        for t in io_tasks | consume_tasks:
            t.cancel()
        raise
    finally:
        for sp in adm_spans.values():
            sp.attrs["error"] = True
            tracer.end(sp, fire_event=True)
        adm_spans.clear()


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> int:
    """Execute read requests under the memory budget, lower ``priority``
    first (a stable sort: the order within a class is kept); returns the
    bytes the consumers were declared to need."""
    executor = ThreadPoolExecutor(
        max_workers=knobs.get_staging_threads(), thread_name_prefix="tsnp-torch-consume"
    )
    if any(rr.priority for rr in read_reqs):
        read_reqs = sorted(read_reqs, key=lambda rr: rr.priority)
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
