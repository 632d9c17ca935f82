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
  donates the template), which is why there is no donation here.
- The budgeted tiled-read path (tiles streamed into a host buffer or a
  device accumulator) is not ported yet: an array larger than the read
  budget is read whole.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import Executor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import knobs
from ..io_types import BufferConsumer, BufferStager, Future, ReadReq, WriteReq
from ..manifest import ArrayEntry, ChunkedArrayEntry, Shard
from ..serialization import (
    BUFFER_PROTOCOL,
    array_as_memoryview,
    dtype_to_string,
    serialized_size_bytes,
    string_to_dtype,
    tensor_from_buffer,
)


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
        entry: ArrayEntry, obj_out: Any = None
    ) -> Tuple[List[ReadReq], Future]:
        fut: Future = Future()
        return (
            [
                ReadReq(
                    path=entry.location,
                    byte_range=list(entry.byte_range) if entry.byte_range else None,
                    buffer_consumer=ArrayBufferConsumer(entry, obj_out, fut),
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
        entry: ChunkedArrayEntry, obj_out: Any = None
    ) -> Tuple[List[ReadReq], Future]:
        fut: Future = Future()
        dtype = string_to_dtype(entry.dtype)
        # host assembly buffer: the template itself when it is a host
        # tensor of the stored dtype, else a fresh one copied over last
        if (
            isinstance(obj_out, torch.Tensor)
            and obj_out.device.type == "cpu"
            and obj_out.dtype == dtype
            and obj_out.is_contiguous()
            and list(obj_out.shape) == list(entry.shape)
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
            )
            for chunk in entry.chunks
        ]
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
