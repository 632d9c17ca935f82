"""The stripe engine: part-parallel writes and reads of large objects.

Counterpart of ``torchsnapshot_tpu/storage/stripe.py``.  An object of at
least ``STRIPE_MIN_OBJECT_SIZE_BYTES`` (128 MiB by default) moves as
parts of ``STRIPE_PART_SIZE_BYTES`` (64 MiB), driven concurrently:

- **writes** (``striped_write``) go through the plugin's
  ``begin_striped_write`` handle: offset-parallel part writes into a
  preallocated temp file on fs, ranged copies on ``memory://``; retry,
  failpoints (``storage.<backend>.part.write``) and the breaker act per
  part, so a transient re-sends one part;
- **streamed writes** (``streamed_part_write``) stage a part and send it
  while later parts are still staging; the object reserves a window of
  parts from the budget, not its whole size.  With a codec each part is
  encoded between its raw digest and its write;
- **reads** (``striped_read``) fan out as parallel ranged
  ``StoragePlugin.read`` calls into one buffer (the ``into`` buffer when
  it fits), which every plugin supports.

A failed part (after its own retries) aborts the handle, which leaves
no part or temp file behind.  Every wait here (a part slot, window
credit, a frame's offset, an abort) has the deadline ``WAIT_DEADLINE_S``.
Spans ``stripe/*`` and the ``storage.stripe.*`` counters and part
latency histograms record the engine's work.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import Executor
from typing import Any, Awaitable, Callable, List, Optional, Tuple

from .. import knobs, obs
from ..io_types import ReadIO, StoragePlugin, resolve_read_destination, run_on
from ..resilience.failpoints import failpoint
from ..utils.checksums import combine_piece_digests, digest

# the longest one part waits for a slot, for window credit, for its
# frame's storage offset, or for its handle's abort
WAIT_DEADLINE_S = 600.0


def plan_parts(total: int, part_size: Optional[int] = None) -> List[Tuple[int, int]]:
    """``[start, end)`` spans of ``part_size`` tiling ``total`` bytes (the
    last one short when the size does not divide)."""
    if part_size is None:
        part_size = knobs.get_stripe_part_size_bytes()
    if total <= 0:
        return []
    return [(lo, min(lo + part_size, total)) for lo in range(0, total, part_size)]


def write_eligible(nbytes: int, storage: StoragePlugin) -> bool:
    """Whether a write of ``nbytes`` to ``storage`` stripes: striping on,
    the object at the threshold or above (two parts at least, by the
    knob's floor), and a plugin with a striped handle."""
    min_bytes = knobs.get_stripe_min_object_size_bytes()
    return (
        min_bytes is not None
        and nbytes >= min_bytes
        and getattr(storage, "supports_striped_write", False)
    )


def read_eligible(nbytes: int) -> bool:
    """Reads stripe on size alone: ranged reads are universal."""
    min_bytes = knobs.get_stripe_min_object_size_bytes()
    return min_bytes is not None and nbytes >= min_bytes


def part_concurrency() -> int:
    """Parts of one object in flight, below the per-process I/O cap so
    one object cannot hold every storage slot."""
    return max(2, min(knobs.get_max_per_rank_io_concurrency(), 8))


def _backend_name(storage: StoragePlugin) -> str:
    return getattr(storage, "obs_backend", type(storage).__name__)


async def _bounded(aw: Awaitable, what: str) -> Any:
    try:
        return await asyncio.wait_for(aw, WAIT_DEADLINE_S)
    except asyncio.TimeoutError:
        raise TimeoutError(f"stripe engine: {what} took over {WAIT_DEADLINE_S} s") from None


class Slot:
    """``async with Slot(sem, what)``: a slot of ``sem``, acquired within
    ``WAIT_DEADLINE_S`` (``TimeoutError`` naming ``what`` past it)."""

    def __init__(self, sem: asyncio.Semaphore, what: str) -> None:
        self._sem = sem
        self._what = what

    async def __aenter__(self) -> None:
        await _bounded(self._sem.acquire(), self._what)

    async def __aexit__(self, *exc: Any) -> None:
        self._sem.release()


async def _abort_quiet(handle: Any) -> None:
    """Abort is cleanup: it never raises over the failure that caused
    it."""
    try:
        await _bounded(handle.abort(), "a handle's abort")
    except Exception as e:  # noqa: BLE001
        obs.swallowed_exception("stripe.abort", e)


def _part_digest(piece: Any) -> Tuple[int, int, int]:
    v = memoryview(piece).cast("B")
    return (*digest(v), v.nbytes)


async def striped_write(
    storage: StoragePlugin,
    path: str,
    buf: Any,
    *,
    on_part_done: Optional[Callable[[int], None]] = None,
    want_digests: bool = False,
) -> Optional[Tuple[int, int, int]]:
    """Write a staged buffer as concurrent parts.  ``on_part_done(n)``
    runs on the loop as each part lands.  With ``want_digests`` each part
    write digests its part in the same pass and the folded (crc32,
    adler32, size) of the object is returned; None when a part could not
    (the caller then digests the buffer in one pass)."""
    view = memoryview(buf).cast("B")
    total = view.nbytes
    spans = plan_parts(total)
    backend = _backend_name(storage)
    m_part_lat = obs.histogram(obs.STRIPE_PART_WRITE_LATENCY_S)
    sem = asyncio.Semaphore(part_concurrency())
    digests: List[Optional[Tuple[int, int, int]]] = [None] * len(spans)

    with obs.span("stripe/write", backend=backend, path=path, bytes=total, parts=len(spans)):
        handle = await storage.begin_striped_write(path, total)
        fuse = want_digests and handle.supports_fused_digest

        async def one(idx: int, lo: int, hi: int) -> None:
            async with Slot(sem, f"part {idx} of {path!r} waiting for a slot"):
                t0 = time.perf_counter()
                with obs.span("stripe/write_part", path=path, part=idx, bytes=hi - lo):
                    d = await handle.write_part(idx, lo, view[lo:hi], want_digest=fuse)
                    if fuse and d is not None:
                        digests[idx] = (d[0], d[1], hi - lo)
                dt = time.perf_counter() - t0
                m_part_lat.observe(dt)
                obs.record_storage_io(backend, "write", hi - lo, dt)
                obs.counter(obs.STRIPE_PARTS_WRITTEN).inc()
                obs.counter(obs.STRIPE_BYTES_WRITTEN).inc(hi - lo)
                if on_part_done is not None:
                    on_part_done(hi - lo)

        try:
            # settle every part before the handle's fate is decided: a
            # cancelled part's thread could still be writing during abort
            results = await asyncio.gather(
                *(one(i, lo, hi) for i, (lo, hi) in enumerate(spans)), return_exceptions=True
            )
            errs = [r for r in results if isinstance(r, BaseException)]
            if errs:
                raise errs[0]
        except BaseException:
            # an outer cancellation aborts too; the abort is shielded from
            # it, and counted before it runs
            obs.counter(obs.STRIPE_ABORTS).inc()
            await asyncio.shield(_abort_quiet(handle))
            raise
        await handle.complete()
        obs.counter(obs.STRIPE_WRITES).inc()
    if want_digests and all(d is not None for d in digests):
        return combine_piece_digests(digests)
    return None


class _ByteGate:
    """Strict-FIFO byte credit of the stream window.  A part takes its raw
    size before staging and gives it back in up to two steps: what its
    encoded frame does not need once the frame exists, the rest when its
    write lands.  A waiter never overtakes an earlier one, so parts are
    admitted in index order.  An acquire waits at most
    ``WAIT_DEADLINE_S``."""

    __slots__ = ("_free", "_waiters")

    def __init__(self, capacity: int) -> None:
        self._free = capacity
        self._waiters: deque = deque()

    async def acquire(self, n: int) -> None:
        if self._free >= n and not self._waiters:
            self._free -= n
            return
        fut = asyncio.get_running_loop().create_future()
        entry = (fut, n)
        self._waiters.append(entry)
        try:
            await _bounded(asyncio.shield(fut), f"window credit of {n} bytes")
        except BaseException:
            if fut.done() and not fut.cancelled():
                # granted while the wait ended: give it back
                self.release(n)
            else:
                fut.cancel()
                try:
                    self._waiters.remove(entry)
                except ValueError:
                    pass
            raise

    def release(self, n: int) -> None:
        self._free += n
        while self._waiters and self._waiters[0][1] <= self._free:
            fut, need = self._waiters.popleft()
            if fut.done():  # cancelled while queued
                continue
            self._free -= need
            fut.set_result(None)


async def streamed_part_write(
    storage: StoragePlugin,
    path: str,
    stager: Any,
    spans: List[Tuple[int, int]],
    executor: Optional[Executor],
    *,
    window_parts: int,
    on_part_staged: Optional[Callable[[int], None]] = None,
    on_part_done: Optional[Callable[[int], None]] = None,
    want_digests: bool = False,
    codec_spec: Any = None,
    filter_stride: int = 0,
    codec_sink: Optional[Callable[[dict], None]] = None,
) -> Optional[List[Tuple[int, int, int]]]:
    """Stage part N and send it while parts N+1... stage.  The bytes in
    flight (staged and not yet written) are capped at ``window_parts``
    full parts, which is the scheduler's budget reservation for the
    object.  Returns the ordered per-part raw (crc32, adler32, size)
    digests with ``want_digests``, else None.

    With ``codec_spec`` (``codec.WriteSpec``) each part is encoded on the
    staging executor after its raw digest; a frame's storage offset is
    the end of the frame before it (a forward cascade that settles as
    encodes finish), the handle is opened at the raw size plus one header
    a part and trimmed on complete, and the frame table (with the digest
    of the stored bytes) goes to ``codec_sink``."""
    backend = _backend_name(storage)
    total = spans[-1][1]
    m_part_lat = obs.histogram(obs.STRIPE_PART_WRITE_LATENCY_S)
    # streamed parts skip the scheduler's stage/write phases: the part is
    # the phase unit here
    m_phase_stage = obs.histogram(obs.PHASE_STAGE_S)
    m_phase_encode = obs.histogram(obs.PHASE_ENCODE_S)
    m_phase_write = obs.histogram(obs.PHASE_WRITE_S)
    gate = _ByteGate(window_parts * max(hi - lo for lo, hi in spans))
    digests: List[Optional[Tuple[int, int, int]]] = [None] * len(spans)
    loop = asyncio.get_running_loop()
    if codec_spec is not None:
        from .. import codec as codec_mod

        ub_total = total + len(spans) * codec_mod.FRAME_HEADER_BYTES
        enc_digests: List[Optional[Tuple[int, int, int]]] = [None] * len(spans)
        frame_lens: List[int] = [0] * len(spans)
        starts: List[asyncio.Future] = [loop.create_future() for _ in spans]
        starts[0].set_result(0)
    else:
        ub_total = total

    async def digest_of(piece: Any) -> Tuple[int, int, int]:
        return await run_on(executor, _part_digest, piece)

    with obs.span(
        "stripe/stream_write", backend=backend, path=path, bytes=total, parts=len(spans),
        codec=getattr(codec_spec, "codec", None),
    ):
        handle = await storage.begin_striped_write(path, ub_total)
        # a fused digest would hash the stored frames: under a codec the
        # raw digest is taken before encoding instead
        fuse = want_digests and codec_spec is None and handle.supports_fused_digest

        async def one(idx: int, span: Tuple[int, int]) -> None:
            lo, hi = span
            await gate.acquire(hi - lo)
            held = hi - lo
            try:
                flow_id = None
                t_stage = time.perf_counter()
                failpoint("scheduler.stage.part", path=path, part=idx)
                with obs.span("stripe/stage_part", path=path, part=idx, bytes=hi - lo) as stage_sp:
                    piece = await stager.stage_part(span, executor)
                    if stage_sp is not None:
                        flow_id = stage_sp.flow_out = obs.next_flow_id()
                m_phase_stage.observe(time.perf_counter() - t_stage)
                if on_part_staged is not None:
                    on_part_staged(hi - lo)
                if want_digests and not fuse:
                    digests[idx] = await digest_of(piece)
                offset = lo
                if codec_spec is not None:
                    t_enc = time.perf_counter()
                    frame = await codec_mod.encode_frame_async(
                        memoryview(piece).cast("B"), codec_spec, filter_stride, executor,
                        path=path, part=idx,
                        min_frame_bytes=handle.min_part_bytes if idx + 1 < len(spans) else 0,
                    )
                    m_phase_encode.observe(time.perf_counter() - t_enc)
                    del piece
                    frame_lens[idx] = len(frame)
                    # the raw part is gone: give back what the frame does
                    # not need
                    early = held - min(held, len(frame))
                    if early:
                        gate.release(early)
                        held -= early
                    if want_digests:
                        enc_digests[idx] = await digest_of(frame)
                    offset = await _bounded(
                        asyncio.shield(starts[idx]), f"the offset of part {idx} of {path!r}"
                    )
                    if idx + 1 < len(spans):
                        starts[idx + 1].set_result(offset + len(frame))
                    piece = frame
                nbytes = memoryview(piece).cast("B").nbytes
                t0 = time.perf_counter()
                with obs.span("stripe/write_part", path=path, part=idx, bytes=nbytes) as write_sp:
                    if write_sp is not None and flow_id is not None:
                        write_sp.flow_in = flow_id
                    d = await handle.write_part(idx, offset, piece, want_digest=fuse)
                dt = time.perf_counter() - t0
                m_phase_write.observe(dt)
                if fuse:
                    # a part the handle did not digest: one separate pass
                    digests[idx] = (d[0], d[1], hi - lo) if d is not None else await digest_of(piece)
                m_part_lat.observe(dt)
                obs.record_storage_io(backend, "write", nbytes, dt)
                obs.counter(obs.STRIPE_PARTS_WRITTEN).inc()
                obs.counter(obs.STRIPE_BYTES_WRITTEN).inc(nbytes)
                del piece
                if on_part_done is not None:
                    on_part_done(nbytes)
            except BaseException as e:
                # keep the offset cascade flowing, or the next part waits
                # for a start that never comes
                if codec_spec is not None and idx + 1 < len(spans) and not starts[idx + 1].done():
                    starts[idx + 1].set_exception(
                        RuntimeError(f"part {idx} of {path!r} failed upstream: {e!r}")
                    )
                raise
            finally:
                gate.release(held)

        try:
            try:
                results = await asyncio.gather(
                    *(one(i, s) for i, s in enumerate(spans)), return_exceptions=True
                )
            finally:
                stager.release_source()
                if codec_spec is not None:
                    # settle the cascade so no future logs "exception never
                    # retrieved"
                    for f in starts:
                        if not f.done():
                            f.cancel()
                        elif not f.cancelled():
                            f.exception()
            errs = [r for r in results if isinstance(r, BaseException)]
            if errs:
                raise errs[0]
        except BaseException:
            obs.counter(obs.STRIPE_ABORTS).inc()
            await asyncio.shield(_abort_quiet(handle))
            raise
        await handle.complete()
        obs.counter(obs.STRIPE_WRITES).inc()
        obs.counter(obs.STRIPE_STREAMED_WRITES).inc()
    if codec_spec is not None and codec_sink is not None:
        stored_digest = None
        if want_digests and all(d is not None for d in enc_digests):
            stored_digest = list(combine_piece_digests(enc_digests))
        codec_sink(codec_mod.make_table(
            codec_spec.codec, spans[0][1] - spans[0][0], total, frame_lens, stored_digest,
        ))
    return [d for d in digests if d is not None] if want_digests else None


async def striped_read(
    storage: StoragePlugin,
    path: str,
    *,
    offset: int,
    length: int,
    into: Any = None,
) -> Any:
    """``[offset, offset + length)`` as concurrent ranged part reads into
    one buffer: ``into`` when it is a writable buffer of ``length``
    bytes (callers test honour by identity), else a fresh one.  Each
    part is a plain ``storage.read``, with the plugin's own retries and
    failpoints."""
    spans = plan_parts(length)
    backend = _backend_name(storage)
    m_part_lat = obs.histogram(obs.STRIPE_PART_READ_LATENCY_S)
    sem = asyncio.Semaphore(part_concurrency())
    out = resolve_read_destination(into, length)
    out_view = memoryview(out).cast("B")

    with obs.span("stripe/read", backend=backend, path=path, bytes=length, parts=len(spans)):

        async def one(idx: int, lo: int, hi: int) -> None:
            async with Slot(sem, f"part {idx} of {path!r} waiting for a slot"):
                dst = out_view[lo:hi]
                t0 = time.perf_counter()
                with obs.span("stripe/read_part", path=path, part=idx, bytes=hi - lo):
                    rio = ReadIO(path=path, byte_range=[offset + lo, offset + hi], into=dst)
                    await storage.read(rio)
                    if rio.buf is not dst:
                        got = memoryview(rio.buf).cast("B")
                        if got.nbytes != hi - lo:
                            raise IOError(
                                f"striped read {path} part {idx} [{offset + lo}:{offset + hi}] "
                                f"returned {got.nbytes} bytes"
                            )
                        dst[:] = got
                m_part_lat.observe(time.perf_counter() - t0)
                obs.counter(obs.STRIPE_PARTS_READ).inc()
                obs.counter(obs.STRIPE_BYTES_READ).inc(hi - lo)

        await asyncio.gather(*(one(i, lo, hi) for i, (lo, hi) in enumerate(spans)))
        obs.counter(obs.STRIPE_READS).inc()
    return out
