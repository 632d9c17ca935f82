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
- Copies (``sync_execute_copy_reqs``: the tier promoter) and writes of
  already-staged buffers (``sync_execute_buffer_writes``: the continuous
  loop's replication, optionally through a transport's ``device_move``)
  are admitted under the same budget with the same progress rule.
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

- Striping (``storage/stripe.py``): a staged object of at least
  ``STRIPE_MIN_OBJECT_SIZE_BYTES`` is written as concurrent parts
  through the plugin's striped handle, its digest fused into the part
  writes where the handles fuse (``supports_fused_part_digest``).  An
  object whose stager can produce parts (``part_plan``: host arrays and
  offloaded leaves, never slabs, whose members carry interior checksum
  ranges) and has no dedup decision pending is part-streamed instead: it
  reserves a window of ``_STREAM_WINDOW_PARTS`` parts from the budget,
  and each part is staged, digested and written while later parts
  stage.  Reads of at least the threshold fan out as parallel ranged
  part reads (the size of a whole-object read from a cheap ``stat``).
- Codec (``codec.py``), resolved once per run: a request with a
  ``codec_sink`` is encoded after its raw digests, part by part on the
  staging executor (frames of the stripe part size), and its frame
  table goes to the sink; storage I/O and the budget then see stored
  bytes.  A read of an object with a frame table (``codec_tables``)
  reads and decodes the frames that cover its raw range.  A request
  linked from an incremental base that stored it encoded carries the
  base's frame table verbatim.
- Content-addressed takes (``cas/``): a request with a ``cas`` context
  is never encoded and never defers its digests (the keys are raw
  digests, needed before any write).  A whole-staged one goes through
  ``chunked_write``, which writes only the chunks the pool lacks; one
  whose stager has a part plan at the chunk size, at the stripe
  threshold or above, streams chunk by chunk (``cas_streamed_write``) in
  a window of ``_STREAM_WINDOW_PARTS`` chunks.  Written chunks count in
  ``bytes_written``, skipped ones in ``bytes_deduped``.  A read of an
  object with a chunk table (``cas_reads``) assembles its raw range from
  the pool; chunked objects are never encoded or striped.
- Mapped reads: with the ``MMAP`` knob on a plugin that is
  ``mmap_budget_exempt`` (fs), a raw read with no buffer of its
  consumer's, no frame table and no chunk table asks for a map
  (``ReadIO.want_mmap``), is admitted at cost 0 and is never striped; a
  read the plugin declines to map is debited its cost once it lands.
  Consumers build tensors over the mapped pages with no host copy.
- Copies (``sync_execute_copy_reqs``): whole objects from one plugin to
  another under the staging budget, each admitted by its size; the tier
  promoter and peer replication ride on it, through host buffers only.
- Failpoints ``scheduler.stage``, ``scheduler.write`` and
  ``scheduler.read`` fire per request, ``scheduler.stage.part`` and
  ``scheduler.codec.encode`` per part.

The pipelines run on a dedicated event-loop thread; heavy work (device
copies, checksums, encodes, deserialization) runs on a thread pool.
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

import numpy as np

from . import codec as codec_mod
from . import knobs
from .cas import store as cas_store
from .io_types import (
    ReadIO,
    ReadReq,
    StoragePlugin,
    WriteIO,
    WriteReq,
    check_read_crc,
    is_mmap_backed,
)
from .obs import metrics as obs_metrics
from .obs import tracer as obs_tracer
from .resilience.failpoints import failpoint
from .storage import stripe
from .utils.checksums import combine_piece_digests, crc32_fast, digest

logger = logging.getLogger(__name__)

# parts of one streamed object in flight (staged and not yet written):
# this many parts are the object's whole budget reservation
_STREAM_WINDOW_PARTS = 4

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
    wr: WriteReq, nbytes: int, storage: StoragePlugin, precomputed: Any, will_encode: bool
) -> bool:
    """Whether the digest of this staged buffer is left to its write: the
    plugin fuses digests (its striped handles do, for an object that will
    stripe), no dedup decision waits on the digest, the write stores the
    raw bytes (a fused digest of frames would not be the raw digest),
    every sink covers the whole buffer, and the stager recorded no piece
    digests (a slab folds those instead)."""
    fuses = (
        storage.supports_fused_part_digest
        if stripe.write_eligible(nbytes, storage)
        else storage.supports_fused_digest
    )
    return (
        fuses
        and not will_encode
        and wr.dedup is None
        and wr.cas is None
        and precomputed is None
        and all(
            rng is None or tuple(rng) == (0, nbytes) for _, rng in wr.checksum_sinks or ()
        )
    )


def _dedup_matches(wr: WriteReq) -> bool:
    return wr.dedup is not None and wr.object_digest == wr.dedup[1]


async def _link_unchanged(p: "_WritePipeline", storage: StoragePlugin) -> bool:
    """Link the request's object from its base snapshot when its raw
    digest equals the base's; True when linked.  The linked object is a
    copy of the base's stored bytes, so a base object stored encoded
    brings its frame table along, verbatim.  A failed link (a plugin
    without ``link_from``, the base object gone) is logged and the
    caller writes the raw bytes: dedup never decides correctness."""
    wr = p.write_req
    if not _dedup_matches(wr):
        return False
    try:
        await storage.link_from(wr.dedup[0], wr.path)
    except Exception as e:  # noqa: BLE001 — any failure writes instead
        logger.info("dedup link for %r failed (%r); writing it", wr.path, e)
        return False
    if wr.codec_sink is not None and wr.dedup_codec is not None:
        wr.codec_sink(dict(wr.dedup_codec))
    p.deduped = True
    return True


async def _encode_staged_buffer(
    buf: Any, wr: WriteReq, spec: "codec_mod.WriteSpec", executor: ThreadPoolExecutor
) -> Any:
    """The compress stage of a whole-staged write: the staged buffer's
    parts (the stripe part size) encoded concurrently on the staging
    executor, assembled into the stored byte stream; the frame table,
    with the stored bytes' digest, goes to the request's codec sink."""
    view = memoryview(buf).cast("B")
    raw_size = view.nbytes
    if raw_size == 0:
        return buf  # nothing to encode: stays a raw object without a table
    part_size = knobs.get_stripe_part_size_bytes()
    spans = stripe.plan_parts(raw_size, part_size)
    stride = wr.buffer_stager.codec_filter_stride
    frames = await asyncio.gather(*(
        codec_mod.encode_frame_async(view[lo:hi], spec, stride, executor, path=wr.path, part=i)
        for i, (lo, hi) in enumerate(spans)
    ))
    frame_lens = [len(f) for f in frames]
    out = np.empty(sum(frame_lens), dtype=np.uint8)
    pos = 0
    for i, n in enumerate(frame_lens):
        out[pos : pos + n] = np.frombuffer(frames[i], dtype=np.uint8)
        frames[i] = None  # peak memory: raw + stored, not raw + 2 x stored
        pos += n
    stored_digest = None
    if knobs.write_checksums_enabled():
        crc, adler = await asyncio.get_running_loop().run_in_executor(executor, digest, out)
        stored_digest = [crc, adler, out.nbytes]
    wr.codec_sink(codec_mod.make_table(spec.codec, part_size, raw_size, frame_lens, stored_digest))
    return out


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
    __slots__ = (
        "write_req", "staging_cost", "admission_cost", "stream_spans", "buf", "buf_size",
        "defer_digest", "deduped", "cas_written", "cas_shared",
    )

    def __init__(self, write_req: WriteReq) -> None:
        self.write_req = write_req
        self.staging_cost = write_req.buffer_stager.get_staging_cost_bytes()
        # what admission debits: the staging cost, or a window of parts
        # for a part-streamed object
        self.admission_cost = self.staging_cost
        # the part spans of a part-streamed object
        self.stream_spans: Optional[List[Tuple[int, int]]] = None
        self.buf = None
        self.buf_size = 0
        self.defer_digest = False
        self.deduped = False
        # a chunked object's bytes written to the pool and found there
        self.cas_written = 0
        self.cas_shared = 0


def _plan_streams(pipelines: List[_WritePipeline], storage: StoragePlugin) -> None:
    """Mark the part-streamed pipelines: a stager with a part plan, a
    plugin with striped handles, an object over the stripe threshold,
    only whole-object checksum sinks (slab members want the assembled
    buffer) and no dedup decision pending (link or write needs the
    object's digest before any byte moves).  A chunked object streams in
    chunk-size parts at the same threshold, with no plugin capability
    needed (each chunk is a whole-object write)."""
    part_size = knobs.get_stripe_part_size_bytes()
    stream_floor = knobs.get_stripe_min_object_size_bytes()
    for p in pipelines:
        wr = p.write_req
        if wr.cas is not None:
            if (
                stream_floor is not None
                and p.staging_cost >= stream_floor
                and all(rng is None for _, rng in wr.checksum_sinks or ())
            ):
                spans = wr.buffer_stager.part_plan(wr.cas.chunk_size)
                if spans and len(spans) > 1 and spans[-1][1] == p.staging_cost:
                    p.stream_spans = spans
                    p.admission_cost = min(
                        p.staging_cost, _STREAM_WINDOW_PARTS * wr.cas.chunk_size
                    )
            continue
        if (
            wr.dedup is None
            and stripe.write_eligible(p.staging_cost, storage)
            and all(rng is None for _, rng in wr.checksum_sinks or ())
        ):
            spans = wr.buffer_stager.part_plan(part_size)
            if spans and len(spans) > 1 and spans[-1][1] == p.staging_cost:
                p.stream_spans = spans
                p.admission_cost = min(p.staging_cost, _STREAM_WINDOW_PARTS * part_size)


def _feed_digest_sinks(wr: WriteReq, crc: int, adler: int, size: int) -> None:
    for sink, _ in wr.checksum_sinks or ():
        sink(crc)
    if wr.digest_sink is not None:
        wr.digest_sink([crc, adler, size])


async def _execute_write_pipelines(
    pipelines: List[_WritePipeline],
    storage: StoragePlugin,
    budget: _Budget,
    executor: ThreadPoolExecutor,
    stats: dict,
    staging_done: threading.Event,
) -> None:
    # resolved once per run: CODEC=raw makes the layer vanish
    codec_spec = codec_mod.resolve_write_spec()
    _plan_streams(pipelines, storage)
    ready_for_staging = deque(pipelines)
    ready_for_io: deque = deque()
    staging_tasks: set = set()
    io_tasks: set = set()
    stream_tasks: set = set()
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
    m_phase_encode = obs_metrics.histogram(obs_metrics.PHASE_ENCODE_S)
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
        wr = p.write_req
        with obs_tracer.span("pipeline/staging", path=wr.path, cost=p.staging_cost) as sp:
            t_stage = time.perf_counter()
            failpoint("scheduler.stage", path=wr.path)
            p.buf = await wr.buffer_stager.stage_buffer(executor)
            p.buf_size = _buf_nbytes(p.buf)
            # chunk keys are raw digests: a chunked object is never encoded
            will_encode = codec_spec is not None and wr.codec_sink is not None and wr.cas is None
            if (wr.checksum_sinks or wr.digest_sink) and checksums:
                precomputed = getattr(wr.buffer_stager, "piece_digests", None)
                if _defers_digest(wr, p.buf_size, storage, precomputed, will_encode):
                    # digested in the pass that writes the bytes (write_one)
                    p.defer_digest = True
                else:
                    await loop.run_in_executor(
                        executor, apply_checksum_sinks, p.buf, wr, precomputed
                    )
            m_phase_stage.observe(time.perf_counter() - t_stage)
            if will_encode and not _dedup_matches(wr):
                # digests above are the raw bytes'; from here on storage
                # and the budget see the stored frames.  A request that
                # will link skips the encode
                t_enc = time.perf_counter()
                p.buf = await _encode_staged_buffer(p.buf, wr, codec_spec, executor)
                p.buf_size = _buf_nbytes(p.buf)
                m_phase_encode.observe(time.perf_counter() - t_enc)
            if sp is not None:
                sp.attrs["bytes"] = p.buf_size
                sp.flow_out = flow_ids[id(p)] = obs_tracer.next_flow_id()
        return p

    async def write_buf(p: _WritePipeline) -> None:
        wr = p.write_req
        if stripe.write_eligible(p.buf_size, storage):
            d = await stripe.striped_write(storage, wr.path, p.buf, want_digests=p.defer_digest)
            fused = None if d is None else (d[0], d[1])
        else:
            wio = WriteIO(path=wr.path, buf=p.buf, want_digest=p.defer_digest)
            await storage.write(wio)
            fused = wio.digests
        if p.defer_digest:
            if fused is None:
                # the plugin did not fuse: the same values, one more pass
                await loop.run_in_executor(executor, apply_checksum_sinks, p.buf, wr)
            else:
                _feed_digest_sinks(wr, fused[0], fused[1], p.buf_size)

    async def write_one(p: _WritePipeline) -> _WritePipeline:
        wr = p.write_req
        with obs_tracer.span("pipeline/io", path=wr.path, bytes=p.buf_size) as sp:
            if sp is not None:
                fid = flow_ids.pop(id(p), None)
                if fid is not None:
                    sp.flow_in = fid
            t_write = time.perf_counter()
            try:
                failpoint("scheduler.write", path=wr.path)
                if wr.cas is not None:
                    # only the chunks the pool lacks move; the chunk table,
                    # not a per-step object, reaches the manifest
                    _, p.cas_written, p.cas_shared = await cas_store.chunked_write(
                        wr.cas, wr.path, p.buf, executor
                    )
                elif not await _link_unchanged(p, storage):
                    await write_buf(p)
            finally:
                m_phase_write.observe(time.perf_counter() - t_write)
        return p

    async def stream_one(p: _WritePipeline) -> _WritePipeline:
        """Part-streamed write through the stripe engine: budget, retries,
        failpoints and metrics act per part inside it."""
        wr = p.write_req
        want = bool(wr.checksum_sinks or wr.digest_sink) and checksums

        def on_part_done(n: int) -> None:
            stats["bytes_written"] += n
            m_written.inc(n)

        with obs_tracer.span(
            "pipeline/stream", path=wr.path, bytes=p.staging_cost, parts=len(p.stream_spans)
        ):
            # the per-request failpoints fire for streamed objects too
            failpoint("scheduler.stage", path=wr.path)
            failpoint("scheduler.write", path=wr.path)
            if wr.cas is not None:
                # a chunk found in the pool reports 0 bytes written and
                # counts as deduped
                digests = await cas_store.cas_streamed_write(
                    wr.cas, wr.path, wr.buffer_stager, p.stream_spans, executor,
                    window_parts=_STREAM_WINDOW_PARTS, on_part_staged=m_staged.inc,
                    on_part_done=on_part_done, on_part_shared=m_deduped.inc,
                )
            else:
                digests = await stripe.streamed_part_write(
                    storage, wr.path, wr.buffer_stager, p.stream_spans, executor,
                    window_parts=_STREAM_WINDOW_PARTS, on_part_staged=m_staged.inc,
                    on_part_done=on_part_done, want_digests=want,
                    codec_spec=codec_spec if wr.codec_sink is not None else None,
                    filter_stride=wr.buffer_stager.codec_filter_stride, codec_sink=wr.codec_sink,
                )
        if want and digests:
            _feed_digest_sinks(wr, *combine_piece_digests(digests))
        return p

    def admit(p: _WritePipeline) -> None:
        budget.used += p.admission_cost
        m_budget.set(budget.used)
        sp = adm_spans.pop(id(p), None)
        if sp is not None:
            tracer.end(sp, fire_event=True)
        if p.stream_spans is not None:
            stream_tasks.add(asyncio.ensure_future(stream_one(p)))
        else:
            staging_tasks.add(asyncio.ensure_future(stage_one(p)))

    try:
        while ready_for_staging or staging_tasks or stream_tasks or ready_for_io or io_tasks:
            # a streamed object's source is read until its last part
            # stages, so staging is done only when its stream is
            if not (ready_for_staging or staging_tasks or stream_tasks):
                staging_done.set()
            # admit every pending request that fits (largest first); when
            # nothing fits and nothing is in flight, admit the largest
            for _ in range(len(ready_for_staging)):
                p = ready_for_staging.popleft()
                if budget.fits(p.admission_cost):
                    admit(p)
                else:
                    ready_for_staging.append(p)
            if ready_for_staging and not (staging_tasks or stream_tasks or io_tasks or ready_for_io):
                admit(ready_for_staging.popleft())
            while ready_for_io and len(io_tasks) < io_concurrency:
                io_tasks.add(asyncio.ensure_future(write_one(ready_for_io.popleft())))
            m_ioq.set(len(ready_for_io))
            if not staging_tasks and not io_tasks and not stream_tasks:
                continue
            done, _ = await asyncio.wait(
                staging_tasks | io_tasks | stream_tasks, return_when=asyncio.FIRST_COMPLETED
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
                elif task in stream_tasks:
                    # bytes were counted per part; the window returns
                    stream_tasks.discard(task)
                    budget.used -= p.admission_cost
                    m_budget.set(budget.used)
                else:
                    io_tasks.discard(task)
                    if p.write_req.cas is not None:
                        # what moved; the chunks found in the pool are the dedup
                        stats["bytes_written"] += p.cas_written
                        m_written.inc(p.cas_written)
                        m_deduped.inc(p.cas_shared)
                    elif p.deduped:  # a linked object moved no bytes
                        stats["deduped_bytes"] += p.buf_size
                        m_deduped.inc(p.buf_size)
                    else:
                        stats["bytes_written"] += p.buf_size
                        m_written.inc(p.buf_size)
                    budget.used -= p.buf_size
                    m_budget.set(budget.used)
                    p.buf = None
    except BaseException:
        for t in staging_tasks | io_tasks | stream_tasks:
            t.cancel()
        # let the cancelled writes and the cleanups they spawned (a striped
        # handle's shielded abort unlinks its temp file) finish before the
        # loop stops
        others = asyncio.all_tasks() - {asyncio.current_task()}
        if others:
            await asyncio.wait(others, timeout=stripe.WAIT_DEADLINE_S)
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


async def _execute_copy_pipelines(
    paths: List[str],
    src_storage: StoragePlugin,
    dst_storage: StoragePlugin,
    budget: _Budget,
    io_concurrency: int,
    counter_name: str,
) -> int:
    """Copy whole objects src → dst, each admitted under the host-memory
    budget by its size (an in-flight copy holds its whole payload; an
    object larger than the budget is admitted alone, the write path's
    progress rule)."""
    m_copied = obs_metrics.counter(counter_name)
    sem = asyncio.Semaphore(io_concurrency)
    cond = asyncio.Condition()

    async def one(path: str) -> int:
        nbytes = await src_storage.stat(path)
        async with cond:
            await cond.wait_for(lambda: budget.used == 0 or budget.fits(nbytes))
            budget.used += nbytes
        try:
            async with sem:
                with obs_tracer.span("tier/promote_object", path=path, bytes=nbytes):
                    read_io = ReadIO(path=path)
                    await src_storage.read(read_io)
                    await dst_storage.write(WriteIO(path=path, buf=read_io.buf))
            m_copied.inc(nbytes)
            return nbytes
        finally:
            async with cond:
                budget.used -= nbytes
                cond.notify_all()

    return sum(await asyncio.gather(*(one(p) for p in paths)))


def sync_execute_copy_reqs(
    paths: List[str],
    src_storage: StoragePlugin,
    dst_storage: StoragePlugin,
    memory_budget_bytes: int,
    counter_name: Optional[str] = None,
) -> int:
    """Copy the named objects from ``src_storage`` to ``dst_storage``
    under the staging memory budget; returns the bytes copied.  The
    engine of the tier promoter (write-back payloads to the durable
    tier) and of peer replication (``counter_name`` the replication
    counter).  Host buffers only: it never touches the card."""
    if not paths:
        return 0
    loop_thread = _LoopThread("tsnp-torch-copy-loop")
    try:
        return loop_thread.submit(
            _execute_copy_pipelines(
                paths, src_storage, dst_storage, _Budget(memory_budget_bytes),
                knobs.get_max_per_rank_io_concurrency(),
                counter_name or obs_metrics.BYTES_PROMOTED,
            )
        ).result()
    finally:
        loop_thread.shutdown()


async def _execute_buffer_writes(
    items: List[Tuple[str, Any]],
    dst_storage: StoragePlugin,
    budget: _Budget,
    io_concurrency: int,
    counter_name: str,
    failpoint_site: Optional[str] = None,
    span_label: str = "scheduler/buffer_write",
    transport: Any = None,
) -> int:
    """Write staged ``(path, buf)`` pairs to ``dst_storage``, each
    admitted under the host-memory budget by its size (the buffers exist
    either way; admission bounds how many a slow or retrying target holds
    in flight, each of which the plugin may buffer again), an object
    larger than the budget alone: the copy pipeline's progress rule.

    ``transport`` routes each payload through the engine's fabric leg
    (``Transport.device_move``, on a worker thread) before its write; a
    failed move writes the original staged bytes and advances
    ``transport.fallbacks``, so a replica never depends on the fabric."""
    m_written = obs_metrics.counter(counter_name)
    sem = asyncio.Semaphore(io_concurrency)
    cond = asyncio.Condition()

    async def one(path: str, buf: Any) -> int:
        nbytes = _buf_nbytes(buf)
        async with cond:
            await cond.wait_for(lambda: budget.used == 0 or budget.fits(nbytes))
            budget.used += nbytes
        try:
            if failpoint_site is not None:
                failpoint(failpoint_site, path=path)
            out = buf
            if transport is not None:
                from .transport import count_fallback

                try:
                    out = await asyncio.get_running_loop().run_in_executor(
                        None, transport.device_move, buf
                    )
                except Exception as e:  # noqa: BLE001 — the fabric leg costs speed, never the replica
                    count_fallback("buffer-write", e)
                    out = buf
            async with sem:
                with obs_tracer.span(span_label, path=path, bytes=nbytes):
                    await dst_storage.write(WriteIO(path=path, buf=out))
            m_written.inc(nbytes)
            return nbytes
        finally:
            async with cond:
                budget.used -= nbytes
                cond.notify_all()

    return sum(await asyncio.gather(*(one(p, b) for p, b in items)))


def sync_execute_buffer_writes(
    items: List[Tuple[str, Any]],
    dst_storage: StoragePlugin,
    memory_budget_bytes: int,
    counter_name: str,
    failpoint_site: Optional[str] = None,
    span_label: str = "scheduler/buffer_write",
    loop_thread: Optional[_LoopThread] = None,
    transport: Any = None,
) -> int:
    """Write staged ``(path, buf)`` pairs concurrently under the staging
    memory budget; returns the bytes written.  The continuous loop's
    replication engine (``continuous/loop.py``): each step's delta
    chunks reach the local and peer stores as budgeted background
    writes.  ``loop_thread`` lets a per-step caller keep one event-loop
    thread alive across calls; without it one is made and shut down
    here, as the copy engine does."""
    if not items:
        return 0
    own_loop = loop_thread is None
    lt = loop_thread or _LoopThread("tsnp-torch-buffer-loop")
    try:
        return lt.submit(
            _execute_buffer_writes(
                items, dst_storage, _Budget(memory_budget_bytes),
                knobs.get_max_per_rank_io_concurrency(), counter_name, failpoint_site,
                span_label, transport,
            )
        ).result()
    finally:
        if own_loop:
            lt.shutdown()


class _ReadPipeline:
    __slots__ = ("read_req", "consuming_cost", "admission_cost", "use_mmap", "buf")

    def __init__(self, read_req: ReadReq) -> None:
        self.read_req = read_req
        self.consuming_cost = read_req.buffer_consumer.get_consuming_cost_bytes()
        # what admission debits: the consuming cost, 0 for a mapped read
        # (file-backed, reclaimable pages hold no heap the budget guards)
        self.admission_cost = self.consuming_cost
        self.use_mmap = False
        self.buf = None


async def _execute_read_pipelines(
    pipelines: List[_ReadPipeline],
    storage: StoragePlugin,
    budget: _Budget,
    executor: ThreadPoolExecutor,
    codec_tables: Optional[Dict[str, Any]] = None,
    cas_reads: Optional[Tuple[Any, Dict[str, Any]]] = None,
) -> None:
    cas_tables = cas_reads[1] if cas_reads is not None else {}
    # keyed on the strict flag: a plugin that may decline into a heap
    # buffer keeps its budgeted, striped reads.  Frames and chunks need a
    # transform, and a consumer's own buffer (a pinned tile) wants the
    # bytes there, so those reads copy
    if knobs.mmap_enabled() and getattr(storage, "mmap_budget_exempt", False):
        for p in pipelines:
            rr = p.read_req
            if (
                not (rr.byte_range is not None and rr.buffer_consumer.provides_read_buffer())
                and not (codec_tables and rr.path in codec_tables)
                and rr.path not in cas_tables
            ):
                p.use_mmap = True
                p.admission_cost = 0
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

    # a striped whole-object read needs the object's length: a stat,
    # but never the base class's, which reads the object
    cheap_stat = type(storage).stat is not StoragePlugin.stat

    async def read_mapped(p: _ReadPipeline, sp: Any) -> Any:
        """One map serves any size (striping would only buy page-cache
        copies).  A read the plugin declines to map is heap: it is
        debited its cost now (a transient overshoot stalls admission
        until its consume credits it back)."""
        rr = p.read_req
        read_io = ReadIO(path=rr.path, byte_range=rr.byte_range, want_mmap=True)
        await storage.read(read_io)
        mapped = is_mmap_backed(read_io.buf)
        if _buf_nbytes(read_io.buf) and not mapped:
            p.admission_cost = p.consuming_cost
            budget.used += p.admission_cost
            m_budget.set(budget.used)
        if sp is not None:
            sp.attrs["mmap"] = mapped
        return read_io.buf

    async def read_bytes(p: _ReadPipeline, sp: Any) -> Any:
        rr = p.read_req
        if p.use_mmap:
            return await read_mapped(p, sp)
        into = None
        if rr.byte_range is not None:
            into = rr.buffer_consumer.read_buffer(rr.byte_range[1] - rr.byte_range[0])
        ctable = cas_tables.get(rr.path)
        if ctable is not None:
            # no per-step object exists: the raw range is assembled from
            # the pool (chunked objects are never encoded or striped)
            if sp is not None:
                sp.attrs["cas"] = True
            return await cas_store.chunked_read(
                cas_reads[0], rr.path, ctable, byte_range=rr.byte_range, into=into
            )
        table = codec_tables.get(rr.path) if codec_tables else None
        if table is not None:
            # the range is raw: read and decode the frames that cover it
            # (frames are the parts, so this subsumes striping)
            if sp is not None:
                sp.attrs["codec"] = table.get("codec")
            return await codec_mod.framed_read(
                storage, rr.path, table, byte_range=rr.byte_range, into=into, executor=executor
            )
        if rr.byte_range is not None:
            offset, length = rr.byte_range[0], rr.byte_range[1] - rr.byte_range[0]
        elif cheap_stat and stripe.read_eligible(p.consuming_cost):
            offset, length = 0, await storage.stat(rr.path)
        else:
            offset, length = 0, 0
        if stripe.read_eligible(length):
            if sp is not None:
                sp.attrs["striped"] = True
            return await stripe.striped_read(
                storage, rr.path, offset=offset, length=length, into=into
            )
        read_io = ReadIO(path=rr.path, byte_range=rr.byte_range, into=into)
        await storage.read(read_io)
        return read_io.buf

    async def read_one(p: _ReadPipeline) -> _ReadPipeline:
        rr = p.read_req
        with obs_tracer.span(
            "pipeline/io", path=rr.path, cost=p.consuming_cost, op="read"
        ) as sp:
            t_read = time.perf_counter()
            try:
                failpoint("scheduler.read", path=rr.path)
                p.buf = await read_bytes(p, sp)
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
        budget.used += p.admission_cost
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
                if budget.fits(p.admission_cost):
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
                    budget.used -= p.admission_cost
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
    codec_tables: Optional[Dict[str, Any]] = None,
    cas_reads: Optional[Tuple[Any, Dict[str, Any]]] = None,
    publish_first: Optional[set] = None,
) -> int:
    """Execute read requests under the memory budget, lower ``priority``
    first (a stable sort: the order within a class is kept); returns the
    bytes the consumers were declared to need.  ``codec_tables``:
    location → frame table of the objects stored encoded (the
    metadata's ``codecs``); ``cas_reads``: ``(ChunkStore, {location →
    chunk table})`` of the objects stored as chunk references.  Byte
    ranges of either stay raw above this call.  ``publish_first``: the
    locations this rank reads for its fan-out siblings
    (``topology/fanout.py``), first within each priority class, so a
    sibling's wait is bounded by those reads alone."""
    executor = ThreadPoolExecutor(
        max_workers=knobs.get_staging_threads(), thread_name_prefix="tsnp-torch-consume"
    )
    if publish_first:
        read_reqs = sorted(
            read_reqs, key=lambda rr: (rr.priority, 0 if rr.path in publish_first else 1)
        )
    elif any(rr.priority for rr in read_reqs):
        read_reqs = sorted(read_reqs, key=lambda rr: rr.priority)
    pipelines = [_ReadPipeline(rr) for rr in read_reqs]
    loop_thread = _LoopThread("tsnp-torch-read-loop")
    t0 = time.monotonic()
    try:
        loop_thread.submit(
            _execute_read_pipelines(
                pipelines, storage, _Budget(memory_budget_bytes), executor, codec_tables,
                cas_reads,
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
