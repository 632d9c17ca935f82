"""Array preparer: write/read planning for tensors and numpy arrays, plus
the chunked variant for big ones.

Counterpart of ``torchsnapshot_tpu/preparers/array.py``:

- A CUDA tensor stages through ``CudaTensorBufferStager`` (the port's
  ``JaxArrayBufferStager``): one ``cudaMemcpyAsync`` into pinned host
  memory on a side copy stream, ordered after the work that produced the
  tensor, completion awaited on an event in a worker thread.
- Host tensors and numpy arrays stage as zero-copy byte views, or as
  copies for an async take (``defensive_copy``).
- ``offload()`` on either stager makes it independent of the live
  tensor before ``async_take`` returns (see ``host_offload.py``): a
  device-side copy on the caller's stream for a CUDA tensor, a host
  copy for a host one.
- Restore writes INTO the template: ``template.copy_(...)`` casts, moves
  host→device and updates the caller's tensor in place.  The JAX package
  cannot do that (its arrays are immutable; it builds a new array and
  donates the template), which is why there is no donation here.  Under
  VERIFY_ON_RESTORE a whole-payload read is checked before it is copied
  anywhere, so a template stays untouched on a mismatch.
- Budgeted reads (``read_object(..., memory_budget_bytes=B)``): an array
  or chunk larger than ``B`` is read in byte-range tiles of at most ``B``
  bytes, each written into its range of the target as it lands, so host
  memory stays O(B).  Targets: a contiguous CPU tensor or numpy template
  (or, with no template, a fresh CPU tensor) — ``_HostTileTarget``; a
  contiguous CUDA template — ``_DeviceTileTarget``: tiles are read into
  pinned buffers, a tile of the template's dtype lands with one
  host-to-device copy, a cast tile with one copy and one K6 launch
  (``ops.device_pack.tile_update``).  Three differences from the JAX
  package's device path (``_DeviceTileAcc``): no donation (the tiles
  land in the caller's tensor, so device peak is the template plus the
  cast tiles in flight); on a failure (a storage error, or a crc
  mismatch under VERIFY_ON_RESTORE) the read raises, the template's
  contents are unspecified but it stays alive and can be passed to a
  retry, where the JAX path has already consumed it; and a read with no
  template onto the card goes tile by tile into a fresh CUDA tensor
  (``Snapshot.read_object`` makes it), never through a whole host copy.
  What cannot tile — a template of another shape or layout, or a cast
  pair K6 does not take — is decided at plan time, read whole, and
  counted in ``TILE_MISSES``.  Tiles are verified by ``_TileCrcFold``.
"""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import Executor
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import knobs, obs
from ..io_types import BufferConsumer, BufferStager, Future, ReadReq, WriteReq
from ..manifest import ArrayEntry, ChunkedArrayEntry, Shard
from ..serialization import (
    BUFFER_PROTOCOL,
    array_as_memoryview,
    dtype_itemsize,
    dtype_to_string,
    serialized_size_bytes,
    string_to_dtype,
    tensor_from_buffer,
)


# budgeted reads read whole, decided at plan time: a template whose shape
# or layout the tiles cannot land in, or a cast pair K6 does not take
TILE_MISSES = {"cast": 0, "layout": 0}
# the most pinned tile memory one budgeted read into a CUDA tensor held
# at once (set back to 0 by whoever reads it)
PINNED_TILES = {"high_water_bytes": 0}
_TILE_LOCK = threading.Lock()


def is_array_like(obj: Any) -> bool:
    return isinstance(obj, (torch.Tensor, np.ndarray))


def is_cuda_tensor(obj: Any) -> bool:
    return isinstance(obj, torch.Tensor) and obj.device.type == "cuda"


def array_nbytes(obj: Any) -> int:
    return obj.numel() * obj.element_size() if isinstance(obj, torch.Tensor) else obj.nbytes


def array_dtype_str(obj: Any) -> str:
    return dtype_to_string(obj.dtype)


def copy_to_host(t: torch.Tensor, after: Any) -> np.ndarray:
    """The bytes of CUDA tensor ``t`` in pinned host memory: one copy on a
    side stream that first waits on ``after`` (a stream or an event), so
    it reads ``t`` as the work before that point left it.  Blocks until
    the copy is done, so ``t`` may be freed when this returns."""
    host = torch.empty(array_nbytes(t), dtype=torch.uint8, pin_memory=True)
    stream = torch.cuda.Stream(device=t.device)
    if isinstance(after, torch.cuda.Event):
        stream.wait_event(after)
    else:
        stream.wait_stream(after)
    with torch.cuda.stream(stream):
        src = t.detach().contiguous().reshape(-1).view(torch.uint8)
        host.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return host.numpy()


class CudaTensorBufferStager(BufferStager):
    """Stage a CUDA tensor: one async D2H copy into pinned host memory on
    a side stream, then wait for its event in a worker thread.

    The copy stream waits on the stream that was current when the write
    was planned, so the bytes staged are the tensor's value at ``take``
    — work the caller queued before it, none queued after it returns.
    After ``offload()`` it stages from the device-side copy instead,
    waiting only on the event recorded after that copy."""

    def __init__(self, tensor: torch.Tensor) -> None:
        self.tensor = tensor
        self.nbytes = array_nbytes(tensor)
        self.producer_stream = torch.cuda.current_stream(tensor.device)
        self.ready: Any = self.producer_stream  # what staging waits on
        self.host: Optional[np.ndarray] = None  # staged before staging ran

    def offload(self, on_device: bool) -> int:
        """Make this stager independent of the live tensor, now: a copy on
        the device, enqueued on the caller's current stream (no host
        wait), or — ``on_device`` false — the D2H copy itself, waited
        for.  Returns the bytes copied."""
        if on_device:
            with torch.no_grad():
                self.tensor = self.tensor.clone(memory_format=torch.contiguous_format)
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(self.tensor.device))
        else:
            self.host = copy_to_host(self.tensor, self.ready)
            self.tensor = None
        return self.nbytes

    async def stage_buffer(self, executor: Optional[Executor] = None) -> memoryview:
        if self.host is not None:
            arr, self.host = self.host, None
        elif executor is not None:
            arr = await asyncio.get_running_loop().run_in_executor(
                executor, copy_to_host, self.tensor, self.ready
            )
        else:
            arr = copy_to_host(self.tensor, self.ready)
        self.tensor = None  # drop the reference as early as possible
        return memoryview(arr)

    def get_staging_cost_bytes(self) -> int:
        return self.nbytes


class HostArrayBufferStager(BufferStager):
    """Stage a host tensor or numpy array as a byte view.  A sync take
    holds the caller until the write completes, so the view is zero-copy;
    an async take (``defensive_copy``) copies, at staging or, through
    ``offload()``, before ``async_take`` returns."""

    def __init__(self, arr: Any, defensive_copy: bool = False) -> None:
        self.arr = arr
        self.defensive_copy = defensive_copy

    def offload(self, on_device: bool = True) -> int:
        """Take the defensive copy now; returns the bytes copied."""
        if not self.defensive_copy or self.arr is None:
            return 0
        self.arr = _host_copy(self.arr)
        self.defensive_copy = False
        return array_nbytes(self.arr)

    async def stage_buffer(self, executor: Optional[Executor] = None) -> memoryview:
        arr, self.arr = self.arr, None
        if self.defensive_copy:
            arr = _host_copy(arr)
        return array_as_memoryview(arr)

    def get_staging_cost_bytes(self) -> int:
        # the staged size: a slab lays its members out by this
        return array_nbytes(self.arr) if self.arr is not None else 0


def _host_copy(arr: Any) -> Any:
    if isinstance(arr, torch.Tensor):
        return arr.detach().clone(memory_format=torch.contiguous_format)
    return np.array(arr, copy=True, order="C")


def _stager_for(obj: Any, is_async: bool = False) -> BufferStager:
    if is_cuda_tensor(obj):
        return CudaTensorBufferStager(obj)
    if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
        raise TypeError(f"unsupported tensor device {obj.device}")
    return HostArrayBufferStager(obj, defensive_copy=is_async)


def materialize_into_template(src: torch.Tensor, obj_out: Any) -> Any:
    """Place restored host data into/onto the restore template.

    - tensor template: IN-PLACE ``copy_`` (casts and moves to the
      template's device) — the caller's tensor is updated, where the JAX
      package returns a new immutable array;
    - numpy template: in-place copy (with cast);
    - no template, or a non-array one: the host tensor itself.
    """
    if isinstance(obj_out, torch.Tensor):
        with torch.no_grad():
            obj_out.copy_(src.reshape(obj_out.shape))
        return obj_out
    if isinstance(obj_out, np.ndarray):
        np.copyto(
            obj_out, src.numpy().reshape(obj_out.shape), casting="unsafe"
        )
        return obj_out
    return src


class ArrayBufferConsumer(BufferConsumer):
    def __init__(self, entry: ArrayEntry, obj_out: Any, fut: Future) -> None:
        self.entry = entry
        self.obj_out = obj_out
        self.fut = fut

    def _consume(self, buf: Any) -> Any:
        src = tensor_from_buffer(buf, self.entry.dtype, tuple(self.entry.shape))
        if self.obj_out is None:
            # the tensor may share ``buf``'s memory: own it
            src = src.clone()
        return materialize_into_template(src, self.obj_out)

    async def consume_buffer(
        self, buf: Any, executor: Optional[Executor] = None
    ) -> None:
        if executor is not None:
            result = await asyncio.get_running_loop().run_in_executor(
                executor, self._consume, buf
            )
        else:
            result = self._consume(buf)
        self.fut.set(result)

    def get_consuming_cost_bytes(self) -> int:
        return serialized_size_bytes(self.entry.shape, self.entry.dtype)


def _numel(shape: List[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _plan_flat_tiles(
    c0: int, c1: int, itemsize: int, budget_bytes: int, base_byte: int = 0
) -> List[Tuple[int, int, List[int]]]:
    """Split the flat element range [c0, c1) into tiles of at most
    ``budget_bytes``: (t0, t1, byte_range) each, the byte range relative
    to the stored object (``base_byte``: the region's offset in it, for
    a chunk or a slab member)."""
    elems_per_tile = max(1, budget_bytes // itemsize)
    return [
        (
            t0,
            min(t0 + elems_per_tile, c1),
            [
                base_byte + (t0 - c0) * itemsize,
                base_byte + (min(t0 + elems_per_tile, c1) - c0) * itemsize,
            ],
        )
        for t0 in range(c0, c1, elems_per_tile)
    ]


class _TileCrcFold:
    """Integrity of a tiled region: a byte-range read cannot be checked
    alone against the recorded crc32 of the whole payload, so each tile
    contributes the crc32 of its RAW stored bytes (before any cast: an f32
    payload read into an f64 template still verifies against the stored
    bytes), and when the last tile has landed the values fold with
    ``crc32_combine`` in offset order (tiles complete out of order).
    Same VERIFY_ON_RESTORE gate as ``io_types.check_read_crc``.

    Tiles are written into the target BEFORE the fold can detect
    corruption (verifying first would need a region-sized buffer, which
    the budget exists to forbid): on a mismatch the read raises and the
    target's contents are unspecified."""

    def __init__(self, expected_crc32: Optional[int], what: str, then: Callable[[], None]) -> None:
        self.expected = expected_crc32
        self.what = what
        self.then = then
        self.want = expected_crc32 is not None and knobs.verify_on_restore()
        self.pieces: dict = {}  # tile start → (crc32, nbytes)

    def record(self, start: int, buf: Any) -> None:
        if not self.want:
            return
        from ..utils.checksums import crc32_fast

        view = memoryview(buf).cast("B")
        self.pieces[start] = (crc32_fast(view), view.nbytes)

    def finish(self) -> None:
        if self.want:
            from ..utils.checksums import crc32_combine

            actual = 0
            for start in sorted(self.pieces):
                crc, nbytes = self.pieces[start]
                actual = crc32_combine(actual, crc, nbytes)
            if actual != self.expected:
                raise RuntimeError(
                    f"crc32 mismatch for {self.what}: recorded "
                    f"crc32={self.expected}, assembled-from-tiles "
                    f"crc32={actual} — the payload changed after commit "
                    "(the target's contents are unspecified)"
                )
        self.then()


class _HostTileTarget:
    """Tiles land in a flat host tensor (a contiguous CPU tensor, or a
    numpy array's memory seen through ``torch.from_numpy``), cast to its
    dtype by ``copy_``."""

    def __init__(self, flat: torch.Tensor) -> None:
        self.flat = flat

    def read_buffer(self, nbytes: int) -> None:
        return None

    def write(self, start: int, end: int, buf: Any, dtype: str, pinned: Any) -> None:
        with torch.no_grad():
            self.flat[start:end].copy_(tensor_from_buffer(buf, dtype, (end - start,)))

    def release(self, into: Any) -> None:
        pass


class _DeviceTileTarget:
    """Tiles land in a contiguous CUDA tensor, in place.  Each tile is
    read into a pinned buffer of its own (``read_buffer``, asked for when
    its read starts, so the pinned memory in use is that of the reads in
    flight, which the scheduler keeps within the budget); a tile of the
    template's dtype then takes one host-to-device copy straight into its
    range, a cast tile one copy into a device tile and one K6 launch.
    Everything runs on one side stream that waits, at plan time, on the
    caller's current stream (work queued on the template before the read
    comes first); each tile waits for its own copies before its buffers
    are released, so the read is complete on the device when it
    returns."""

    def __init__(self, dst: torch.Tensor, stored: torch.dtype) -> None:
        self.dst = dst.detach()  # the template's storage, outside autograd
        self.flat = self.dst.view(-1)
        self.stored = stored
        self.stream = torch.cuda.Stream(device=dst.device)
        self.stream.wait_stream(torch.cuda.current_stream(dst.device))
        self.pinned_bytes = 0

    def read_buffer(self, nbytes: int) -> Tuple[np.ndarray, torch.Tensor]:
        pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        with _TILE_LOCK:
            self.pinned_bytes += nbytes
            PINNED_TILES["high_water_bytes"] = max(
                PINNED_TILES["high_water_bytes"], self.pinned_bytes
            )
        return pinned.numpy(), pinned

    def release(self, into: Tuple[np.ndarray, torch.Tensor]) -> None:
        with _TILE_LOCK:
            self.pinned_bytes -= into[1].numel()

    def write(self, start: int, end: int, buf: Any, dtype: str, pinned: Any) -> None:
        from ..ops.device_pack import tile_update

        if end == start:
            return
        # the pinned buffer the tile was read into, else the storage's own
        host = (
            pinned.view(self.stored) if pinned is not None
            else tensor_from_buffer(buf, dtype, (end - start,))
        )
        with torch.no_grad(), torch.cuda.stream(self.stream):
            if self.stored == self.dst.dtype:
                self.flat[start:end].copy_(host, non_blocking=True)
            else:
                tile = torch.empty(end - start, dtype=self.stored, device=self.dst.device)
                tile.copy_(host, non_blocking=True)
                tile_update(self.dst, start, tile)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()


def _tile_target(dtype: str, shape: List[int], obj_out: Any) -> Any:
    """Where a budgeted read of a ``dtype``/``shape`` payload tiles into,
    decided before any read: a host or device target, or None (read whole;
    a tensor or numpy template that cannot take tiles is counted in
    ``TILE_MISSES``).  No template: a fresh CPU tensor of the stored
    dtype."""
    stored = string_to_dtype(dtype)
    numel = _numel(shape)
    if obj_out is None:
        return _HostTileTarget(torch.empty(numel, dtype=stored))
    if isinstance(obj_out, np.ndarray):
        if not obj_out.flags["C_CONTIGUOUS"] or obj_out.size != numel:
            return _tile_miss("layout")
        try:
            flat = torch.from_numpy(obj_out.reshape(-1))
        except TypeError:
            return _tile_miss("cast")  # a dtype torch cannot view
        return _HostTileTarget(flat)
    if not isinstance(obj_out, torch.Tensor):
        return None
    if not obj_out.is_contiguous() or obj_out.numel() != numel:
        return _tile_miss("layout")
    if obj_out.device.type == "cpu":
        return _HostTileTarget(obj_out.detach().view(-1))
    if obj_out.device.type != "cuda":
        return _tile_miss("layout")
    from ..ops.device_pack import cast_supported

    if not cast_supported(stored, obj_out.dtype):
        return _tile_miss("cast")
    return _DeviceTileTarget(obj_out, stored)


def _tile_miss(reason: str) -> None:
    with _TILE_LOCK:
        TILE_MISSES[reason] += 1
    return None


def _tile_result(target: Any, obj_out: Any, shape: List[int]) -> Any:
    """What a tiled read returns: the template, else the fresh tensor."""
    if obj_out is not None:
        return obj_out
    return target.flat.reshape(tuple(shape))


class _TiledConsumer(BufferConsumer):
    """Consume one byte-range read into elements [start, end) of a tile
    target (a whole chunk, or one tile of a payload larger than the
    budget, with the fold that verifies the tiles together)."""

    def __init__(
        self,
        target: Any,
        elem_range: Tuple[int, int],
        countdown: "_Countdown",
        tile_bytes: int,
        dtype: str,
        crc_fold: Optional[_TileCrcFold] = None,
    ) -> None:
        self.target = target
        self.elem_range = elem_range
        self.countdown = countdown
        self.tile_bytes = tile_bytes
        self.dtype = dtype
        self.crc_fold = crc_fold
        self._into: Any = None  # (buffer, pinned tensor) from the target

    def read_buffer(self, nbytes: int) -> Any:
        self._into = self.target.read_buffer(nbytes)
        return None if self._into is None else self._into[0]

    def _land(self, buf: Any) -> None:
        start, end = self.elem_range
        if self.crc_fold is not None:
            self.crc_fold.record(start, buf)
        into, self._into = self._into, None
        try:
            pinned = into[1] if into is not None and buf is into[0] else None
            self.target.write(start, end, buf, self.dtype, pinned)
        finally:
            if into is not None:
                self.target.release(into)
        obs.counter(obs.TILES_READ).inc()

    async def consume_buffer(
        self, buf: Any, executor: Optional[Executor] = None
    ) -> None:
        if executor is not None:
            await asyncio.get_running_loop().run_in_executor(executor, self._land, buf)
        else:
            self._land(buf)
        self.countdown.step()

    def get_consuming_cost_bytes(self) -> int:
        return self.tile_bytes


class ArrayIOPreparer:
    @staticmethod
    def prepare_write(
        obj: Any, location: str, replicated: bool, is_async: bool = False
    ) -> Tuple[ArrayEntry, List[WriteReq]]:
        entry = ArrayEntry(
            location=location,
            serializer=BUFFER_PROTOCOL,
            dtype=array_dtype_str(obj),
            shape=list(obj.shape),
            replicated=replicated,
        )
        return entry, [
            WriteReq(
                path=location,
                buffer_stager=_stager_for(obj, is_async),
                checksum_sinks=[
                    (lambda c, e=entry: setattr(e, "crc32", c), None)
                ],
            )
        ]

    @staticmethod
    def prepare_read(
        entry: ArrayEntry,
        obj_out: Any = None,
        buffer_size_limit_bytes: Optional[int] = None,
    ) -> Tuple[List[ReadReq], Future]:
        fut: Future = Future()
        if (
            buffer_size_limit_bytes is not None
            and serialized_size_bytes(entry.shape, entry.dtype) > buffer_size_limit_bytes
        ):
            target = _tile_target(entry.dtype, entry.shape, obj_out)
            if target is not None:
                result = _tile_result(target, obj_out, entry.shape)
                tiles = _plan_flat_tiles(
                    0, _numel(entry.shape), dtype_itemsize(entry.dtype),
                    buffer_size_limit_bytes,
                    base_byte=entry.byte_range[0] if entry.byte_range else 0,
                )
                fold = _TileCrcFold(
                    entry.crc32, f"{entry.location} (tiled)", lambda: fut.set(result)
                )
                countdown = _Countdown(len(tiles), fold.finish)
                return [
                    ReadReq(
                        path=entry.location,
                        byte_range=byte_range,
                        buffer_consumer=_TiledConsumer(
                            target, (t0, t1), countdown,
                            byte_range[1] - byte_range[0], entry.dtype, fold,
                        ),
                    )
                    for t0, t1, byte_range in tiles
                ], fut
        return (
            [
                ReadReq(
                    path=entry.location,
                    byte_range=list(entry.byte_range) if entry.byte_range else None,
                    buffer_consumer=ArrayBufferConsumer(entry, obj_out, fut),
                    expected_crc32=entry.crc32,
                )
            ],
            fut,
        )


def _chunk_dim0(shape: List[int], dtype_str: str, max_chunk_bytes: int) -> List[Tuple[int, int]]:
    """Row ranges [(start, end), ...] with each chunk ≤ max_chunk_bytes."""
    if not shape or shape[0] == 0:
        return [(0, shape[0] if shape else 0)]
    row_bytes = serialized_size_bytes(shape[1:], dtype_str)
    rows_per_chunk = max(1, max_chunk_bytes // max(1, row_bytes))
    return [
        (r, min(r + rows_per_chunk, shape[0]))
        for r in range(0, shape[0], rows_per_chunk)
    ]


class ChunkedArrayIOPreparer:
    @staticmethod
    def prepare_write(
        obj: Any, location: str, replicated: bool,
        chunk_size_bytes: Optional[int] = None, is_async: bool = False,
    ) -> Tuple[ChunkedArrayEntry, List[WriteReq]]:
        dtype_str = array_dtype_str(obj)
        shape = list(obj.shape)
        ndim = len(shape)
        if chunk_size_bytes is None:
            chunk_size_bytes = knobs.get_max_chunk_size_bytes()
        chunks: List[Shard] = []
        write_reqs: List[WriteReq] = []
        for r0, r1 in _chunk_dim0(shape, dtype_str, chunk_size_bytes):
            chunk_location = f"{location}_{r0}_{r1}"
            chunks.append(
                Shard(
                    offsets=[r0] + [0] * (ndim - 1),
                    sizes=[r1 - r0] + shape[1:],
                    location=chunk_location,
                )
            )
            write_reqs.append(
                WriteReq(
                    path=chunk_location,
                    buffer_stager=_stager_for(obj[r0:r1], is_async),
                    checksum_sinks=[
                        (lambda c, s=chunks[-1]: setattr(s, "crc32", c), None)
                    ],
                )
            )
        entry = ChunkedArrayEntry(
            dtype=dtype_str, shape=shape, chunks=chunks, replicated=replicated
        )
        return entry, write_reqs

    @staticmethod
    def prepare_read(
        entry: ChunkedArrayEntry,
        obj_out: Any = None,
        buffer_size_limit_bytes: Optional[int] = None,
    ) -> Tuple[List[ReadReq], Future]:
        if buffer_size_limit_bytes is not None:
            target = _tile_target(entry.dtype, entry.shape, obj_out)
            if target is not None:
                return _read_chunks_into(
                    entry, target, _tile_result(target, obj_out, entry.shape),
                    buffer_size_limit_bytes,
                )
        fut: Future = Future()
        dtype = string_to_dtype(entry.dtype)
        # host assembly buffer: the template itself when it is a host
        # tensor of the stored dtype, else a fresh one copied over last
        # (always a fresh one under VERIFY_ON_RESTORE, so a later chunk's
        # mismatch leaves the template untouched)
        if (
            isinstance(obj_out, torch.Tensor)
            and obj_out.device.type == "cpu"
            and obj_out.dtype == dtype
            and obj_out.is_contiguous()
            and list(obj_out.shape) == list(entry.shape)
            and not knobs.verify_on_restore()
        ):
            host_buf = obj_out
        else:
            host_buf = torch.empty(tuple(entry.shape), dtype=dtype)

        def on_done() -> None:
            if host_buf is obj_out:
                fut.set(obj_out)
            else:
                fut.set(materialize_into_template(host_buf, obj_out))

        countdown = _Countdown(len(entry.chunks), on_done)
        read_reqs = [
            ReadReq(
                path=chunk.location,
                byte_range=list(chunk.byte_range) if chunk.byte_range else None,
                buffer_consumer=_ChunkConsumer(
                    host_buf, chunk, entry.dtype, countdown
                ),
                expected_crc32=chunk.crc32,
            )
            for chunk in entry.chunks
        ]
        return read_reqs, fut


def _read_chunks_into(
    entry: ChunkedArrayEntry, target: Any, result: Any, limit: int
) -> Tuple[List[ReadReq], Future]:
    """A budgeted read of a chunked entry: a chunk is a dim-0 row range,
    so a contiguous flat element range; one at most ``limit`` bytes is
    read whole (verified before it lands), a larger one in tiles whose
    fold verifies it after the last lands."""
    fut: Future = Future()
    itemsize = dtype_itemsize(entry.dtype)
    row = _numel(entry.shape[1:])
    outer = _Countdown(len(entry.chunks), lambda: fut.set(result))
    read_reqs: List[ReadReq] = []
    for chunk in entry.chunks:
        c0 = chunk.offsets[0] * row
        c1 = c0 + chunk.sizes[0] * row
        base = chunk.byte_range[0] if chunk.byte_range else 0
        nbytes = (c1 - c0) * itemsize
        if nbytes <= limit:
            read_reqs.append(ReadReq(
                path=chunk.location,
                byte_range=[base, base + nbytes],
                buffer_consumer=_TiledConsumer(target, (c0, c1), outer, nbytes, entry.dtype),
                expected_crc32=chunk.crc32,
            ))
            continue
        tiles = _plan_flat_tiles(c0, c1, itemsize, limit, base_byte=base)
        fold = _TileCrcFold(chunk.crc32, f"{chunk.location} (tiled)", outer.step)
        inner = _Countdown(len(tiles), fold.finish)
        read_reqs.extend(
            ReadReq(
                path=chunk.location,
                byte_range=byte_range,
                buffer_consumer=_TiledConsumer(
                    target, (t0, t1), inner, byte_range[1] - byte_range[0],
                    entry.dtype, fold,
                ),
            )
            for t0, t1, byte_range in tiles
        )
    return read_reqs, fut


class _Countdown:
    """Run ``on_zero`` after N consume steps (consumers complete on the
    scheduler's single loop thread, so a plain counter suffices)."""

    def __init__(self, n: int, on_zero) -> None:
        self.n = n
        self.on_zero = on_zero
        if n == 0:
            on_zero()

    def step(self) -> None:
        self.n -= 1
        if self.n == 0:
            self.on_zero()


class _ChunkConsumer(BufferConsumer):
    def __init__(self, host_buf: torch.Tensor, chunk: Shard, dtype: str, countdown: _Countdown):
        self.host_buf = host_buf
        self.chunk = chunk
        self.dtype = dtype
        self.countdown = countdown

    def _copy(self, buf: Any) -> None:
        r0 = self.chunk.offsets[0]
        r1 = r0 + self.chunk.sizes[0]
        src = tensor_from_buffer(buf, self.dtype, tuple(self.chunk.sizes))
        self.host_buf[r0:r1].copy_(src)

    async def consume_buffer(
        self, buf: Any, executor: Optional[Executor] = None
    ) -> None:
        if executor is not None:
            await asyncio.get_running_loop().run_in_executor(
                executor, self._copy, buf
            )
        else:
            self._copy(buf)
        self.countdown.step()

    def get_consuming_cost_bytes(self) -> int:
        return serialized_size_bytes(self.chunk.sizes, self.dtype)
