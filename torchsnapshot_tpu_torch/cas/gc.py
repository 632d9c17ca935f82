"""Two-phase refcounted GC of the chunk pool, and the commit-side index
update.

Counterpart of ``torchsnapshot_tpu/cas/gc.py``.  A chunk's life:

1. **written** by a take (or skipped: its content is pooled already);
2. **referenced**: rank 0 calls ``commit_refs`` strictly before the
   ``.snapshot_metadata`` marker, so the chunk is protected from then on;
3. **orphan-marked**: ``release_step`` (a delete) or ``run_gc``'s mark
   finds it with no committed ref and stamps ``orphaned_at``;
4. **swept**: past the grace window (``CAS_GC_GRACE_S``) the sweep checks
   every ref against the commit markers again, and only then deletes the
   bytes and the entry.  A chunk referenced again before that lives on.

The grace window is the concurrency story: a take that found a chunk
live commits its ref before a racing sweep may touch it, as long as the
window exceeds the take.  Takes never dedup against orphan-marked
chunks, so a sweep only ever races a resurrection.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import knobs, obs
from ..io_types import run_in_fresh_loop
from ..resilience.failpoints import failpoint
from .index import (
    ChunkIndex,
    ChunkIndexCorruptError,
    fsck,
    index_lock,
    norm_ref,
    snapshot_is_committed,
)
from .store import ChunkStore, chunk_location, key_size

logger = logging.getLogger(__name__)


def commit_refs(store: ChunkStore, ref_id: str, tables: Dict[str, Dict[str, Any]]) -> None:
    """Register one take's chunk refs, on rank 0, strictly before its
    ``.snapshot_metadata`` marker.  A crash between the two leaves refs
    of an uncommitted step, which the mark phase treats as dead.

    Raises when a referenced chunk the index did not track (or that
    ``fsck`` flagged missing) is absent from the pool: a sweep that raced
    the take, or a hand-deleted file, fails the commit here rather than
    committing a step that cannot restore."""
    with obs.span("cas/commit_refs", ref=ref_id, objects=len(tables)), index_lock(store.root):
        try:
            index = ChunkIndex.load(store)
        except ChunkIndexCorruptError:
            logger.warning(
                "corrupt chunk index under %r at commit time; rebuilding via "
                "fsck before registering refs", store.root,
            )
            fsck(store.root)
            index = ChunkIndex.load(store)
        ref_keys = {str(k) for t in tables.values() for k in t.get("keys", ())}
        # other tracked entries are on storage: a sweep removes the entry
        # and the bytes together, under this lock
        check = sorted(
            k for k in ref_keys if k not in index.chunks or index.chunks[k].get("missing")
        )
        missing = _stat_missing(store, check)
        if missing:
            raise RuntimeError(
                f"cas commit for {ref_id!r}: {len(missing)} referenced chunk(s) "
                f"missing from the pool (first: {missing[:3]}) — a GC sweep raced "
                "this take?  The commit is aborted; re-take the step."
            )
        for key in check:
            entry = index.chunks.get(key)
            if entry is not None:
                entry.pop("missing", None)  # written again: healed
        index.add_refs(ref_id, tables)
        index.save(store)
        # the crash window between the index update and the marker
        failpoint("cas.index.commit", ref=ref_id)


def _stat_missing(store: ChunkStore, keys: List[str]) -> List[str]:
    """The keys absent from the pool or of the wrong size."""
    if not keys:
        return []

    async def gather():
        sem = asyncio.Semaphore(16)

        async def one(key: str) -> Tuple[str, bool]:
            async with sem:
                try:
                    return key, await store.stat(key) == key_size(key)
                except FileNotFoundError:
                    return key, False

        return await asyncio.gather(*(one(k) for k in keys))

    return [k for k, ok in run_in_fresh_loop(gather()) if not ok]


def release_step(
    cas_root: str, path: str, grace_s: Optional[float] = None, now: Optional[float] = None
) -> int:
    """Drop a deleted step's refs and sweep what is past the grace window.
    Returns the bytes of the chunks whose refcount fell to zero (what the
    delete un-shared: the ``snapshot.gc.bytes_reclaimed`` contract)."""
    now = time.time() if now is None else now
    store = ChunkStore(cas_root)
    with obs.span("cas/release_step", root=cas_root, ref=path), index_lock(cas_root):
        try:
            try:
                index = ChunkIndex.load(store)
            except ChunkIndexCorruptError:
                logger.warning(
                    "corrupt chunk index under %r during delete; refs for %r will "
                    "be reclaimed by the next fsck/gc", cas_root, path,
                )
                return 0
            zeroed = index.release(norm_ref(path), now=now)
            _sweep(store, index, grace_s, now)
            index.save(store)
            return sum(size for _, size in zeroed)
        finally:
            store.sync_close()


def run_gc(
    cas_root: str,
    snapshot_paths: Optional[List[str]] = None,
    grace_s: Optional[float] = None,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """Mark and sweep: refs are checked against their commit markers
    (memoised per ref), then what has been orphaned longer than the grace
    window is checked again and deleted.  ``snapshot_paths`` only feeds
    the ``fsck`` that rebuilds a corrupt index first."""
    now = time.time() if now is None else now
    store = ChunkStore(cas_root)
    with obs.span("cas/gc", root=cas_root), index_lock(cas_root):
        try:
            try:
                index = ChunkIndex.load(store)
            except ChunkIndexCorruptError:
                logger.warning("corrupt chunk index under %r; rebuilding via fsck before GC", cas_root)
                fsck(cas_root, snapshot_paths, now=now)
                index = ChunkIndex.load(store)
            marked = index.mark(snapshot_is_committed, now=now)
            swept_keys, swept_bytes = _sweep(store, index, grace_s, now)
            index.save(store)
            return {
                "root": cas_root,
                "marked": marked,
                "swept_chunks": swept_keys,
                "swept_bytes": swept_bytes,
                "chunks": len(index.chunks),
            }
        finally:
            store.sync_close()


def _sweep(
    store: ChunkStore, index: ChunkIndex, grace_s: Optional[float], now: float
) -> Tuple[int, int]:
    """The sweep, in place on ``index``: delete the chunks orphaned past
    the grace window whose refs all still point at uncommitted steps."""
    grace = knobs.get_cas_gc_grace_s() if grace_s is None else grace_s
    swept = swept_bytes = 0
    verdicts: Dict[str, bool] = {}

    def committed(ref: str) -> bool:
        if ref not in verdicts:
            verdicts[ref] = snapshot_is_committed(ref)
        return verdicts[ref]

    for key in index.sweep_due(grace, now=now):
        entry = index.chunks[key]
        if any(committed(r) for r in entry["refs"]):
            entry.pop("orphaned_at", None)  # resurrected since the mark
            continue
        try:
            store.storage.sync_delete(chunk_location(key))
        except FileNotFoundError:
            pass  # an earlier partial sweep deleted the bytes
        index.remove(key)
        swept += 1
        swept_bytes += entry["size"]
    if swept:
        obs.counter(obs.CAS_CHUNKS_SWEPT).inc(swept)
        obs.counter(obs.CAS_BYTES_SWEPT).inc(swept_bytes)
    return swept, swept_bytes
