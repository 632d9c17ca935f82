"""Snapshot integrity audit: ``verify_snapshot`` / ``Snapshot.verify``.

Counterpart of ``torchsnapshot_tpu/verify.py``, with the same checks and
the same ``VerifyResult``:

- **shallow** (default): one ``stat`` per stored object.  Every location
  the manifest references must exist and be at least as large as the
  entries claim (a slab: the largest ``byte_range`` end of its members;
  an array: its serialized size), or exactly the size the objects table
  records.  No payload is read.
- **deep**: every payload with a recorded crc32 is read again and
  compared (``corrupt`` on a mismatch); an entry whose payloads all
  verified is not read a second time, every other array or object entry
  is read through the restore machinery with no template.

Primitive entries live in the metadata and are checked by parsing.  A
snapshot committed degraded lists the paths lost with a dead rank under
``degraded`` (excluded from the audit; ``complete`` is then false).  An
object stored compressed or as content-addressed chunks raises
``EncodedPayloadError``, as a restore of it does: the port decodes
neither yet (ROADMAP queue A item 5), and such an object is never
counted as verified.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .event import Event
from .event_handlers import log_event
from .io_types import ReadIO, run_in_fresh_loop
from .manifest import Entry, PrimitiveEntry, ShardedArrayEntry, is_container_entry
from .manifest_ops import get_manifest_for_rank
from .preparers import prepare_read
from .scheduler import get_process_memory_budget_bytes, sync_execute_read_reqs
from .serialization import serialized_size_bytes
from .utils.checksums import crc32_fast

logger = logging.getLogger(__name__)

# stats and deep reads in flight at once
_STAT_CONCURRENCY = 16


@dataclass
class VerifyResult:
    """Audit outcome.  ``ok`` iff every check passed; ``complete`` also
    needs that the commit lost nothing to a dead rank (``degraded``)."""

    objects_checked: int = 0
    entries_checked: int = 0
    missing: List[str] = field(default_factory=list)
    # (location, expected_min_bytes, actual_bytes)
    truncated: List[Tuple[str, int, int]] = field(default_factory=list)
    # (logical path or location, error)
    unreadable: List[Tuple[str, str]] = field(default_factory=list)
    # (location, recorded_crc32, actual_crc32): deep mode only
    corrupt: List[Tuple[str, int, int]] = field(default_factory=list)
    degraded: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.missing or self.truncated or self.unreadable or self.corrupt)

    @property
    def complete(self) -> bool:
        return self.ok and not self.degraded

    def raise_if_failed(self) -> None:
        if not self.ok:
            raise RuntimeError(f"snapshot verification failed: {self}")

    def __str__(self) -> str:
        deg = f", {len(self.degraded)} degraded path(s)" if self.degraded else ""
        if self.ok:
            return f"OK ({self.objects_checked} objects, {self.entries_checked} entries{deg})"
        parts = []
        if self.missing:
            parts.append(f"missing={self.missing[:5]}")
        if self.truncated:
            parts.append(f"truncated={self.truncated[:5]}")
        if self.unreadable:
            parts.append(f"unreadable={self.unreadable[:5]}")
        if self.corrupt:
            parts.append(f"corrupt={self.corrupt[:5]}")
        return "FAILED " + ", ".join(parts) + deg


def _expected_extents(manifest: Dict[str, Entry]) -> Dict[str, int]:
    """location → the least byte size the manifest implies for it (0: an
    existence check only, where no size follows from the entry)."""
    extents: Dict[str, int] = {}

    def claim(location: str, nbytes: Optional[int]) -> None:
        extents[location] = max(extents.get(location, 0), nbytes or 0)

    for entry in manifest.values():
        loc = getattr(entry, "location", None)
        shape, dtype = getattr(entry, "shape", None), getattr(entry, "dtype", None)
        if isinstance(loc, str):
            br = getattr(entry, "byte_range", None)
            if br:
                claim(loc, int(br[1]))
            elif shape is not None and dtype is not None:
                claim(loc, serialized_size_bytes(shape, dtype))
            else:
                claim(loc, None)
        for attr in ("shards", "chunks"):
            for piece in getattr(entry, attr, None) or ():
                if piece.byte_range:
                    claim(piece.location, int(piece.byte_range[1]))
                elif dtype is not None:
                    claim(piece.location, serialized_size_bytes(piece.sizes, dtype))
                else:
                    claim(piece.location, None)
    return extents


def _stat_all(storage: Any, locations: List[str]) -> List[Tuple[str, Any]]:
    """[(location, size or the exception)], gathered in one event loop."""

    async def gather():
        sem = asyncio.Semaphore(_STAT_CONCURRENCY)

        async def one(loc: str):
            async with sem:
                try:
                    return loc, await storage.stat(loc)
                except Exception as e:  # noqa: BLE001 — reported per object
                    return loc, e

        return await asyncio.gather(*(one(loc) for loc in locations))

    return run_in_fresh_loop(gather())


def _crc_targets(manifest: Dict[str, Entry]) -> List[Tuple[str, Optional[List[int]], int]]:
    """(location, byte_range, recorded crc32) of every payload the
    manifest holds a checksum for, each once."""
    targets = []
    seen = set()

    def add(loc: str, byte_range: Any, crc: int) -> None:
        key = (loc, tuple(byte_range or ()))
        if key not in seen:
            seen.add(key)
            targets.append((loc, byte_range, crc))

    for entry in manifest.values():
        loc = getattr(entry, "location", None)
        crc = getattr(entry, "crc32", None)
        if isinstance(loc, str) and crc is not None:
            add(loc, getattr(entry, "byte_range", None), crc)
        for attr in ("shards", "chunks"):
            for piece in getattr(entry, attr, None) or ():
                if piece.crc32 is not None:
                    add(piece.location, piece.byte_range, piece.crc32)
    return targets


def _check_crcs(
    storage: Any, manifest: Dict[str, Entry], result: VerifyResult, extents: Dict[str, int]
) -> set:
    """Deep mode: read every checksummed payload again and compare its
    crc32.  Returns the ``(location, byte_range)`` keys that verified.
    Reads are admitted under the process staging budget (each holds its
    whole payload), one oversized payload alone."""
    targets = _crc_targets(manifest)
    if not targets:
        return set()
    budget_cap = get_process_memory_budget_bytes()

    def size_of(loc: str, byte_range: Any) -> int:
        return int(byte_range[1]) - int(byte_range[0]) if byte_range else extents.get(loc, 0)

    async def gather():
        sem = asyncio.Semaphore(_STAT_CONCURRENCY)
        in_use = 0
        budget_free = asyncio.Condition()

        async def one(loc: str, byte_range: Any, crc: int):
            nonlocal in_use
            nbytes = size_of(loc, byte_range)
            async with budget_free:
                await budget_free.wait_for(lambda: in_use == 0 or in_use + nbytes <= budget_cap)
                in_use += nbytes
            try:
                async with sem:
                    read_io = ReadIO(path=loc, byte_range=list(byte_range) if byte_range else None)
                    await storage.read(read_io)
                    return loc, byte_range, crc, crc32_fast(memoryview(read_io.buf).cast("B")), None
            except Exception as e:  # noqa: BLE001 — reported per payload
                return loc, byte_range, crc, None, e
            finally:
                async with budget_free:
                    in_use -= nbytes
                    budget_free.notify_all()

        return await asyncio.gather(*(one(*t) for t in targets))

    verified = set()
    for loc, byte_range, crc, actual, err in run_in_fresh_loop(gather()):
        if err is not None:
            # a missing object is already reported by the stat pass
            if not isinstance(err, FileNotFoundError):
                result.unreadable.append((loc, f"crc read: {err!r}"))
        elif actual != crc:
            result.corrupt.append((loc, crc, actual))
        else:
            verified.add((loc, tuple(byte_range or ())))
    return verified


def _fully_crc_verified(entry: Entry, verified: set) -> bool:
    """Whether the entry has a payload and every payload verified."""
    keys = []
    loc = getattr(entry, "location", None)
    if isinstance(loc, str):
        keys.append((loc, tuple(getattr(entry, "byte_range", None) or ())))
    for attr in ("shards", "chunks"):
        for piece in getattr(entry, attr, None) or ():
            keys.append((piece.location, tuple(piece.byte_range or ())))
    return bool(keys) and all(k in verified for k in keys)


def verify_snapshot(snapshot: Any, deep: bool = False, rank: Optional[int] = None) -> VerifyResult:
    """Audit one rank's view of ``snapshot`` (a ``Snapshot`` or a path;
    default rank: this process's)."""
    if isinstance(snapshot, str):
        from .snapshot import Snapshot

        snapshot = Snapshot(snapshot)
    if rank is None:
        rank = snapshot._coordinator.rank
    with log_event(Event("verify", {"path": snapshot.path, "deep": deep, "rank": rank})):
        return _verify_impl(snapshot, deep, rank)


def _verify_impl(snapshot: Any, deep: bool, rank: int) -> VerifyResult:
    from .snapshot import _entry_locations, _refuse_encoded, _storage_for

    result = VerifyResult()
    metadata = snapshot.metadata
    manifest = dict(get_manifest_for_rank(metadata, rank))
    _refuse_encoded(metadata, (loc for e in manifest.values() for loc in _entry_locations(e)))
    # paths lost with a dead rank are absent by contract; the same view
    # rule as restore's decides which of them this rank's audit would read
    degraded_meta = metadata.degraded or {}
    result.degraded = sorted(
        p for p, e in manifest.items()
        if p in degraded_meta
        and not is_container_entry(e)
        and (
            rank == degraded_meta[p].get("origin_rank")
            or isinstance(e, ShardedArrayEntry)
            or bool(getattr(e, "replicated", False))
        )
    )
    for p in result.degraded:
        del manifest[p]
    storage = _storage_for(snapshot.path, snapshot._storage_options)
    try:
        extents = _expected_extents(manifest)
        # the objects table records exact sizes
        exact_sizes = {
            loc: rec[2]
            for loc, rec in (metadata.objects or {}).items()
            if isinstance(rec, (list, tuple)) and len(rec) == 3
        }
        for location, outcome in _stat_all(storage, sorted(extents)):
            if isinstance(outcome, FileNotFoundError):
                result.missing.append(location)
            elif isinstance(outcome, BaseException):
                result.unreadable.append((location, f"stat: {outcome!r}"))
            else:
                result.objects_checked += 1
                exact = exact_sizes.get(location)
                if exact is not None and outcome != exact:
                    result.truncated.append((location, exact, outcome))
                elif outcome < extents[location]:
                    result.truncated.append((location, extents[location], outcome))

        crc_verified = _check_crcs(storage, manifest, result, extents) if deep else set()
        for lpath, entry in sorted(manifest.items()):
            if is_container_entry(entry):
                continue
            result.entries_checked += 1
            if isinstance(entry, PrimitiveEntry):
                try:
                    entry.get_value()
                except Exception as e:  # noqa: BLE001 — reported per entry
                    result.unreadable.append((lpath, repr(e)))
                continue
            if not deep or _fully_crc_verified(entry, crc_verified):
                continue
            try:
                read_reqs, fut = prepare_read(entry)
                sync_execute_read_reqs(
                    list(read_reqs), storage, get_process_memory_budget_bytes(), rank
                )
                if fut.obj is None:
                    raise RuntimeError("read produced no value")
            except Exception as e:  # noqa: BLE001 — reported per entry
                result.unreadable.append((lpath, repr(e)))
    finally:
        storage.sync_close()
    if not result.ok:
        logger.warning("snapshot %r verification: %s", snapshot.path, result)
    return result
