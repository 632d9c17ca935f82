"""IO preparers: turn checkpointable objects into (Entry, WriteReqs) on
save and (ReadReqs, Future) on load.

Counterpart of ``torchsnapshot_tpu/preparers/__init__.py``.  Dispatch:

- primitives → inlined ``PrimitiveEntry`` (no storage I/O)
- ``DTensor``s → sharded preparer (``ShardedArrayEntry``, the format of
  the JAX package's multi-device ``jax.Array``s)
- plain tensors and ``nn.Parameter``s (CPU or CUDA) and numpy arrays →
  array preparer (chunked above the MAX_CHUNK_SIZE_BYTES knob); any
  other ``torch.Tensor`` subclass is refused by name
- everything else → object preparer (safe codec, pickle behind a knob)
"""

from __future__ import annotations

import fnmatch
from typing import Any, List, Optional, Sequence, Tuple

import torch

from .. import knobs
from ..io_types import Future, ReadReq, WriteReq
from ..manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    Shard,
    ShardedArrayEntry,
    is_primitive_type,
)
from .array import ArrayIOPreparer, ChunkedArrayIOPreparer, array_nbytes, is_array_like
from .object import ObjectIOPreparer
from .sharded import ShardedArrayIOPreparer, is_dtensor


def path_is_replicated(logical_path: str, replicated_globs: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(logical_path, g) for g in replicated_globs)


def estimate_write_bytes(obj: Any) -> int:
    """A leaf's write load, known without staging: what a rank's
    non-sharded state weighs in the sharded-box balance."""
    if is_primitive_type(obj):
        return 0
    if is_array_like(obj):
        return array_nbytes(obj)
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    return 0


def check_tensor_type(obj: Any, logical_path: str) -> None:
    """Refuse, at planning, a tensor subclass the format has no record
    for (a ``DTensor`` has one: the sharded preparer)."""
    if (
        isinstance(obj, torch.Tensor)
        and type(obj) not in (torch.Tensor, torch.nn.Parameter)
        and not is_dtensor(obj)
    ):
        raise TypeError(
            f"{logical_path!r}: tensor subclass {type(obj).__module__}."
            f"{type(obj).__qualname__} cannot be snapshotted; pass a plain "
            "tensor (or a DTensor)"
        )


def prepare_write(
    obj: Any,
    logical_path: str,
    rank: int,
    replicated: bool = False,
    chunk_size_bytes: Optional[int] = None,
    is_async_snapshot: bool = False,
    world: int = 1,
    writer_loads: Optional[List[int]] = None,
) -> Tuple[Entry, List[WriteReq]]:
    """Plan the write of one leaf.  Storage paths: ``replicated/`` for
    replicated entries, ``<rank>/`` for per-rank ones, ``sharded/`` for
    a DTensor's boxes (never replicated: its replicas are its mesh's,
    each box written once by the writer ``writer_loads`` elects, see
    ``preparers/sharded.py``).  An async snapshot plans defensive copies
    of host arrays (the caller may mutate them once ``async_take``
    returns)."""
    if is_primitive_type(obj):
        return PrimitiveEntry.from_object(obj, replicated=replicated), []
    check_tensor_type(obj, logical_path)
    if is_dtensor(obj):
        return ShardedArrayIOPreparer.prepare_write(
            obj, logical_path, rank, world, writer_loads, is_async_snapshot
        )
    namespace = "replicated" if replicated else str(rank)
    location = f"{namespace}/{logical_path}"
    if is_array_like(obj):
        if chunk_size_bytes is None:
            chunk_size_bytes = knobs.get_max_chunk_size_bytes()
        if array_nbytes(obj) > chunk_size_bytes:
            return ChunkedArrayIOPreparer.prepare_write(
                obj, location, replicated, chunk_size_bytes, is_async_snapshot
            )
        return ArrayIOPreparer.prepare_write(obj, location, replicated, is_async_snapshot)
    return ObjectIOPreparer.prepare_write(obj, location, replicated)


def prepare_read(
    entry: Entry,
    obj_out: Optional[Any] = None,
    buffer_size_limit_bytes: Optional[int] = None,
) -> Tuple[List[ReadReq], Future]:
    """Plan the read of one entry; ``obj_out`` is the restore template
    (restored in place when it is a tensor or numpy array).  With
    ``buffer_size_limit_bytes``, an array or chunk larger than it is read
    in byte-range tiles of at most that size (see ``preparers/array.py``)."""
    if isinstance(entry, PrimitiveEntry):
        fut: Future = Future()
        fut.set(entry.get_value())
        return [], fut
    if is_dtensor(obj_out) and isinstance(entry, (ArrayEntry, ChunkedArrayEntry)):
        # a dense array into a DTensor: its one box (or its chunks' boxes)
        # read through the sharded path, into the template's local box
        shards = entry.chunks if isinstance(entry, ChunkedArrayEntry) else [
            Shard(offsets=[0] * len(entry.shape), sizes=list(entry.shape), location=entry.location,
                  byte_range=entry.byte_range, crc32=entry.crc32)
        ]
        entry = ShardedArrayEntry(dtype=entry.dtype, shape=list(entry.shape), shards=shards)
    if isinstance(entry, ChunkedArrayEntry):
        return ChunkedArrayIOPreparer.prepare_read(entry, obj_out, buffer_size_limit_bytes)
    if isinstance(entry, ArrayEntry):
        return ArrayIOPreparer.prepare_read(entry, obj_out, buffer_size_limit_bytes)
    if isinstance(entry, ShardedArrayEntry):
        return ShardedArrayIOPreparer.prepare_read(entry, obj_out, buffer_size_limit_bytes)
    if isinstance(entry, ObjectEntry):
        return ObjectIOPreparer.prepare_read(entry)
    raise TypeError(f"cannot prepare read for entry type {type(entry).__name__}")
