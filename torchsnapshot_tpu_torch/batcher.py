"""Small-write coalescing (slabs) and ranged-read merging.

Counterpart of ``torchsnapshot_tpu/batcher.py``, with the same slab
layout rules, so the two packages lay out the same state identically.
Write requests below the slab threshold whose manifest records carry a
byte range are packed into slab objects; the records are re-pointed at
``(slab_location, byte_range)``.  On read, ranged reads of one location
merge into one spanning read whose consumer feeds each member, at the
lowest ``priority`` of its members.

CUDA members slab apart from host members.  A slab whose members are all
CUDA tensors packs on the device with kernel K1 and reaches the host in
one copy; on restore, members whose templates are CUDA tensors unpack
on the device with kernel K2 from one host-to-device copy, on the
stream current when the read was planned; when every member of a merged
read does, the span is read into a pinned buffer the consumer leases
(``ops/transfer.py``), so that copy is one asynchronous DMA.  Neither
path falls back: a kernel failure fails the take or restore.  What
routes a member to the host path instead is a decision made at plan
time, BEFORE any launch — a host template, a cast pair K2 does not take,
a template whose layout differs (``transfer.card_miss``) — and each such
decision is counted in ``read.unpack_misses.<reason>``.  Under
VERIFY_ON_RESTORE every member of a merged read checks its own slice
against its recorded crc32 before any member is written.
"""

from __future__ import annotations

import asyncio
import math
from concurrent.futures import Executor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import knobs, obs
from .io_types import BufferConsumer, BufferStager, ReadReq, WriteReq, check_read_crc, run_on
from .manifest import ArrayEntry, ChunkedArrayEntry, Entry, ObjectEntry, ShardedArrayEntry
from .ops import transfer
from .preparers.array import ArrayBufferConsumer, CudaTensorBufferStager, HostArrayBufferStager
from .serialization import BUFFER_PROTOCOL, string_to_dtype
from .utils.checksums import copy_digest

# host members this large are packed on the staging pool, off the loop
_PACK_OFFLOAD_MIN_BYTES = 256 * 1024


class BatchedBufferStager(BufferStager):
    """Stage member buffers into one slab: on the device with K1 when
    every member is a CUDA tensor, member by member on the host
    otherwise (the batcher never mixes the two in one slab)."""

    def __init__(self, stagers: List[Tuple[BufferStager, int]], total: int):
        self.stagers = stagers
        self.total = total
        self.on_device = all(
            isinstance(s, CudaTensorBufferStager) for s, _ in stagers
        )
        # K1's slab reaches the host in a pinned buffer of its own
        self.stages_private_buffer = self.on_device
        # the slab packed by ``offload()``, staged in place of the members
        self.packed: Optional[CudaTensorBufferStager] = None
        # (start, end) → (crc32, adler32, size) of each member packed on
        # the host, recorded during the pack
        self.piece_digests: Optional[Dict[Tuple[int, int], Tuple[int, int, int]]] = None

    def offload(self, on_device: bool) -> int:
        """Make the slab independent of the live members now (an async
        take's unblock point).  A device slab is packed by K1 on the
        caller's current stream — the slab is the device-side copy — or,
        ``on_device`` false, packed and copied to pinned host memory
        before this returns; host members take their defensive copies.
        Returns the bytes copied."""
        if not self.on_device:
            return sum(
                s.offload(on_device) for s, _ in self.stagers
                if isinstance(s, HostArrayBufferStager)
            )
        from .ops.device_pack import pack_slab

        tensors = [s.tensor for s, _ in self.stagers]
        with torch.cuda.device(tensors[0].device):
            packed = CudaTensorBufferStager(pack_slab(tensors))
            if on_device:
                packed.ready = torch.cuda.Event()
                packed.ready.record(torch.cuda.current_stream())
            else:
                packed.offload(on_device=False)
        self.packed, self.stagers = packed, []
        return self.total

    async def stage_buffer(self, executor: Optional[Executor] = None) -> memoryview:
        with obs.span(
            "pipeline/slab_pack", members=len(self.stagers), bytes=self.total
        ):
            if self.on_device:
                buf = await self._stage_device_packed(executor)
            else:
                buf = await self._stage_host_packed(executor)
        obs.counter(obs.SLABS_PACKED).inc()
        return buf

    async def _stage_device_packed(self, executor: Optional[Executor]) -> memoryview:
        from .ops.device_pack import pack_tensors_to_host

        if self.packed is not None:
            packed, self.packed = self.packed, None
            return await packed.stage_buffer(executor)
        tensors = [s.tensor for s, _ in self.stagers]
        producer = self.stagers[0][0].producer_stream
        slab = await run_on(executor, obs.stage_queued(pack_tensors_to_host, tensors, producer))
        if slab.nbytes != self.total:
            raise ValueError(f"packed {slab.nbytes} != expected {self.total}")
        self.stagers = []
        return memoryview(slab)

    async def _stage_host_packed(self, executor: Optional[Executor]) -> memoryview:
        """Members stage one at a time (peak memory is the slab plus one
        member, matching ``get_staging_cost_bytes``) and are copied into
        the slab with their (crc32, adler32) computed in the same pass;
        ``piece_digests`` records them, so the scheduler feeds the
        members' checksum sinks and folds the slab's digest without
        reading the slab again.  Members of at most ``NATIVE_MIN_BYTES``
        take a Python copy and zlib (a native call costs more there);
        with WRITE_CHECKSUMS off the pack is a plain copy."""
        want_digests = knobs.write_checksums_enabled()
        loop = asyncio.get_running_loop()
        slab = np.empty(self.total, dtype=np.uint8)
        view = memoryview(slab)
        pieces: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
        offset = 0
        for s, cost in self.stagers:
            member = memoryview(await s.stage_buffer(executor)).cast("B")
            if member.nbytes != cost:
                raise ValueError(f"member staged {member.nbytes} != {cost}")
            dst = view[offset:offset + cost]
            if not want_digests:
                dst[:] = member
            else:
                if executor is not None and cost >= _PACK_OFFLOAD_MIN_BYTES:
                    # a big copy leaves the loop thread free for other I/O
                    d = await loop.run_in_executor(
                        executor, obs.stage_queued(copy_digest, dst, member)
                    )
                else:
                    d = copy_digest(dst, member)
                pieces[(offset, offset + cost)] = (*d, cost)
            offset += cost
            # before the next member stages: one member alive at a time
            del member, dst
        if want_digests:
            self.piece_digests = pieces
        self.stagers = []
        return view

    def get_staging_cost_bytes(self) -> int:
        if self.on_device:
            return self.total
        return self.total + max((c for _, c in self.stagers), default=0)


def _byte_range_targets(entries: Dict[str, Entry]) -> Dict[str, Any]:
    """location → the manifest record whose (location, byte_range) must
    be re-pointed when its blob moves into a slab."""
    targets: Dict[str, Any] = {}
    for entry in entries.values():
        if isinstance(entry, (ArrayEntry, ObjectEntry)):
            targets[entry.location] = entry
        elif isinstance(entry, ChunkedArrayEntry):
            for chunk in entry.chunks:
                targets[chunk.location] = chunk
        elif isinstance(entry, ShardedArrayEntry):
            # small device shards (norms, sub-threshold boxes) ride slabs
            for shard in entry.shards:
                targets[shard.location] = shard
    return targets


def _device_key(wr: WriteReq) -> Optional[str]:
    s = wr.buffer_stager
    return str(s.tensor.device) if isinstance(s, CudaTensorBufferStager) else None


def batch_write_requests(
    entries: Dict[str, Entry], write_reqs: List[WriteReq], rank: int
) -> Tuple[Dict[str, Entry], List[WriteReq]]:
    """Coalesce small writes into ≥ slab-threshold objects."""
    threshold = knobs.get_slab_size_threshold_bytes()
    host_member_max = knobs.get_slab_host_member_max_bytes()
    targets = _byte_range_targets(entries)
    small: List[Tuple[WriteReq, int]] = []
    rest: List[WriteReq] = []
    for wr in write_reqs:
        cost = wr.buffer_stager.get_staging_cost_bytes()
        # big HOST members skip the slab (their pack is a pure extra
        # memcpy); CUDA members stay eligible at any size below the
        # threshold — the device pack turns N copies into one
        fits = 0 < cost < threshold and (
            cost < host_member_max or _device_key(wr) is not None
        )
        if wr.path in targets and fits:
            small.append((wr, cost))
        else:
            rest.append(wr)
    if len(small) < 2:
        return entries, write_reqs

    # CUDA members slab apart from host/object members, and per device:
    # K1 gathers from one device only.  Device groups come first, in
    # device order, then the host group — the JAX package's order.
    small.sort(key=lambda x: x[0].path)  # deterministic slab layout
    devices = sorted({k for wr, _ in small if (k := _device_key(wr)) is not None})
    groups = [
        [(wr, c) for wr, c in small if _device_key(wr) == dev] for dev in devices
    ] + [[(wr, c) for wr, c in small if _device_key(wr) is None]]
    slabs: List[List[Tuple[WriteReq, int]]] = []
    new_reqs = list(rest)
    for group in groups:
        if len(group) < 2:
            new_reqs.extend(wr for wr, _ in group)
            continue
        cur: List[Tuple[WriteReq, int]] = []
        cur_bytes = 0
        for wr, cost in group:
            cur.append((wr, cost))
            cur_bytes += cost
            if cur_bytes >= threshold:
                slabs.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            slabs.append(cur)

    for i, slab in enumerate(slabs):
        slab_location = f"{rank}/batched.{i}"
        offset = 0
        stagers: List[Tuple[BufferStager, int]] = []
        sinks = []
        for wr, cost in slab:
            record = targets[wr.path]
            record.location = slab_location
            record.byte_range = [offset, offset + cost]
            stagers.append((wr.buffer_stager, cost))
            # re-range the member's checksum sinks into slab coordinates
            for sink, rng in wr.checksum_sinks or ():
                lo = offset + (rng[0] if rng else 0)
                hi = offset + (rng[1] if rng else cost)
                sinks.append((sink, (lo, hi)))
            offset += cost
        new_reqs.append(
            WriteReq(
                path=slab_location,
                buffer_stager=BatchedBufferStager(stagers, offset),
                checksum_sinks=sinks or None,
            )
        )
    if len(new_reqs) == len(write_reqs):
        return entries, write_reqs
    return entries, new_reqs


def _device_unpack_target(req: ReadReq) -> Optional[torch.Tensor]:
    """The CUDA template K2 should write ``req``'s member into, or None
    for the host path (counting why, when it is a tensor read)."""
    c = req.buffer_consumer
    if not isinstance(c, ArrayBufferConsumer) or c.entry.serializer != BUFFER_PROTOCOL:
        return None
    out = c.obj_out
    if not isinstance(out, torch.Tensor):
        return None
    if out.device.type != "cuda":
        miss: Optional[str] = "host_template"
    else:
        numel = math.prod(int(d) for d in c.entry.shape)
        miss = transfer.card_miss(out, string_to_dtype(c.entry.dtype), numel)
    if miss is not None:
        obs.counter(f"{obs.READ_UNPACK_MISSES}.{miss}").inc()
        return None
    return out


class _MergedRangeConsumer(BufferConsumer):
    """Feed one spanning read into the original ranged consumers.  Made
    at plan time: each member's CUDA template for K2 (None: the host
    path) and the stream then current on each template's device are
    decided here."""

    def __init__(self, base: int, subs: List[Tuple[ReadReq, int, int]]):
        self.base = base
        self.subs = subs
        self._outs = [_device_unpack_target(req) for req, _, _ in subs]
        self._streams = {
            out.device: torch.cuda.current_stream(out.device) for out in self._outs if out is not None
        }
        self._lease = transfer.PinnedLease()

    def read_buffer(self, nbytes: int) -> Optional[np.ndarray]:
        if nbytes == 0 or any(out is None for out in self._outs):
            return None
        return self._lease.offer(nbytes)

    async def consume_buffer(
        self, buf: Any, executor: Optional[Executor] = None
    ) -> None:
        try:
            await self._consume(buf, self._lease.claim(buf), executor)
        finally:
            self._lease.release()

    async def _consume(
        self, buf: Any, pinned: Optional[torch.Tensor], executor: Optional[Executor]
    ) -> None:
        view = memoryview(buf).cast("B")
        if knobs.verify_on_restore():
            # the spanning read bypassed the scheduler's request-level
            # check: each member checks its own slice, all before any
            # member is written, so templates stay untouched on a mismatch
            for req, start, end in self.subs:
                if req.expected_crc32 is None:
                    continue
                piece = view[start - self.base:end - self.base]
                await run_on(executor, check_read_crc, req, piece)
        device_subs: Dict[torch.device, list] = {}
        host_subs = []
        for (req, start, end), out in zip(self.subs, self._outs):
            if out is None:
                host_subs.append((req, start, end))
            else:
                device_subs.setdefault(out.device, []).append((req, start, out))
        for subs in device_subs.values():
            await run_on(executor, self._device_unpack, view, pinned, subs)
        for req, start, end in host_subs:
            piece = view[start - self.base:end - self.base]
            await req.buffer_consumer.consume_buffer(piece, executor)

    def _device_unpack(self, view: memoryview, pinned: Optional[torch.Tensor], subs: list) -> None:
        """ONE host-to-device copy of the span these members cover (from
        ``pinned``, the read's pinned buffer, when it has one) and ONE K2
        launch writing each into its CUDA template in place, on the stream
        current when the read was planned."""
        from .ops.device_pack import unpack_slab_to_device

        lo = min(start for _, start, _ in subs)
        hi = max(
            start + _member_nbytes(req) for req, start, _ in subs
        )
        members = tuple(
            (start - lo, req.buffer_consumer.entry.dtype,
             tuple(req.buffer_consumer.entry.shape))
            for req, start, _ in subs
        )
        src = view if pinned is None else pinned
        outs = [out for _, _, out in subs]
        unpack_slab_to_device(
            src[lo - self.base:hi - self.base], members, outs, self._streams[outs[0].device]
        )
        for req, _, out in subs:
            req.buffer_consumer.fut.set(out)

    def get_consuming_cost_bytes(self) -> int:
        span = max(e for _, _, e in self.subs) - self.base
        return max(
            span,
            sum(
                req.buffer_consumer.get_consuming_cost_bytes()
                for req, _, _ in self.subs
            ),
        )


def _member_nbytes(req: ReadReq) -> int:
    return req.byte_range[1] - req.byte_range[0]


def batch_read_requests(read_reqs: List[ReadReq]) -> List[ReadReq]:
    """Merge ranged reads of the same location into one spanning read."""
    by_path: Dict[str, List[ReadReq]] = {}
    out: List[ReadReq] = []
    for rr in read_reqs:
        if rr.byte_range is not None:
            by_path.setdefault(rr.path, []).append(rr)
        else:
            out.append(rr)
    max_gap = 1 << 20  # don't span holes larger than 1MB between ranges
    for path, reqs in by_path.items():
        if len(reqs) == 1:
            out.append(reqs[0])
            continue
        reqs.sort(key=lambda r: r.byte_range[0])
        run: List[ReadReq] = []
        run_hi = 0

        def flush() -> None:
            if not run:
                return
            if len(run) == 1:
                out.append(run[0])
            else:
                lo = run[0].byte_range[0]
                hi = max(r.byte_range[1] for r in run)
                subs = [(r, r.byte_range[0], r.byte_range[1]) for r in run]
                out.append(
                    ReadReq(
                        path=path,
                        byte_range=[lo, hi],
                        buffer_consumer=_MergedRangeConsumer(lo, subs),
                        # as early as its most urgent member asks
                        priority=min(r.priority for r in run),
                    )
                )
            run.clear()

        for r in reqs:
            if run and r.byte_range[0] - run_hi > max_gap:
                flush()
            run_hi = r.byte_range[1] if not run else max(run_hi, r.byte_range[1])
            run.append(r)
        flush()
    return out
