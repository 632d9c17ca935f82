"""IO preparers: turn checkpointable objects into (Entry, WriteReqs) on
save and (ReadReqs, Future) on load.

Counterpart of ``torchsnapshot_tpu/preparers/__init__.py``.  Dispatch:

- primitives → inlined ``PrimitiveEntry`` (no storage I/O)
- tensors (CPU or CUDA) and numpy arrays → array preparer (chunked
  above the MAX_CHUNK_SIZE_BYTES knob)
- everything else → object preparer (safe codec, pickle behind a knob)

Sharded arrays (the JAX package's multi-device ``jax.Array``s) are not
ported; a ``ShardedArrayEntry`` found on restore raises.
"""

from __future__ import annotations

import fnmatch
from typing import Any, List, Optional, Sequence, Tuple

from .. import knobs
from ..io_types import Future, ReadReq, WriteReq
from ..manifest import (
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    ObjectEntry,
    PrimitiveEntry,
    is_primitive_type,
)
from .array import ArrayIOPreparer, ChunkedArrayIOPreparer, array_nbytes, is_array_like
from .object import ObjectIOPreparer


def path_is_replicated(logical_path: str, replicated_globs: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(logical_path, g) for g in replicated_globs)


def prepare_write(
    obj: Any,
    logical_path: str,
    rank: int,
    replicated: bool = False,
    chunk_size_bytes: Optional[int] = None,
    is_async_snapshot: bool = False,
) -> Tuple[Entry, List[WriteReq]]:
    """Plan the write of one leaf.  Storage paths: ``replicated/`` for
    replicated entries, ``<rank>/`` for per-rank ones.  An async snapshot
    plans defensive copies of host arrays (the caller may mutate them
    once ``async_take`` returns)."""
    if is_primitive_type(obj):
        return PrimitiveEntry.from_object(obj, replicated=replicated), []
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
    if isinstance(entry, ChunkedArrayEntry):
        return ChunkedArrayIOPreparer.prepare_read(entry, obj_out, buffer_size_limit_bytes)
    if isinstance(entry, ArrayEntry):
        return ArrayIOPreparer.prepare_read(entry, obj_out, buffer_size_limit_bytes)
    if isinstance(entry, ObjectEntry):
        return ObjectIOPreparer.prepare_read(entry)
    raise TypeError(
        f"cannot prepare read for entry type {type(entry).__name__} in the "
        "PyTorch port (sharded arrays are not ported)"
    )
