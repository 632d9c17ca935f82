"""The refcounted chunk index: which steps reference which chunks.

Counterpart of ``torchsnapshot_tpu/cas/index.py``; either package loads
and self-checks the other's ``index.json``.  One JSON document at the
pool root (the ``utils/selfcrc.py`` trailer) maps each chunk key to
``{size, refs, added_by, orphaned_at?, missing?}``:

- ``refs``: normalised snapshot paths whose manifests reference the
  chunk.  A take adds its refs strictly before its ``.snapshot_metadata``
  marker; refs of a take that died before committing are cleaned up by
  the mark phase.
- ``added_by``: the step that first brought the chunk (the per-step
  new-against-shared rollup of the ``stats`` and ``cas`` commands).
- ``orphaned_at``: set by the mark phase when no ref is committed; the
  sweep deletes the chunk once the grace window has passed and a second
  look still finds every ref dead.  A chunk referenced again while
  marked is resurrected.

Mutators run on rank 0 (the ``manager_index.json`` discipline), and
every load-modify-save in this process holds the pool's ``index_lock``,
taken within ``INDEX_LOCK_DEADLINE_S`` (``ChunkIndexLockTimeout`` past
it).  ``fsck`` rebuilds the index from the committed manifests, and on
a local pool marks the chunks no manifest references as orphans.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

from .. import obs
from ..io_types import ReadIO, WriteIO
from ..utils.selfcrc import append_crc_trailer, strip_crc_trailer
from .store import CHUNK_DIR, ChunkStore, key_size, validate_table

logger = logging.getLogger(__name__)

CHUNK_INDEX_FNAME = "index.json"
_INDEX_CRC_MARKER = "\n#tsnp-cas-crc32:"
INDEX_VERSION = 1

# the longest a load-modify-save waits for the pool's lock: the async
# commit thread's commit_refs and rank 0's retention and GC share it
INDEX_LOCK_DEADLINE_S = 300.0

_LOCKS_GUARD = threading.Lock()
_INDEX_LOCKS: Dict[str, threading.RLock] = {}


class ChunkIndexLockTimeout(TimeoutError):
    """Another thread of this process held the pool's index lock for
    longer than ``INDEX_LOCK_DEADLINE_S``."""


@contextlib.contextmanager
def index_lock(root: str) -> Iterator[None]:
    """The pool's re-entrant index lock, taken within
    ``INDEX_LOCK_DEADLINE_S``."""
    with _LOCKS_GUARD:
        lock = _INDEX_LOCKS.setdefault(root, threading.RLock())
    if not lock.acquire(timeout=INDEX_LOCK_DEADLINE_S):
        raise ChunkIndexLockTimeout(
            f"chunk index lock of {root!r} not acquired within "
            f"{INDEX_LOCK_DEADLINE_S} s"
        )
    try:
        yield
    finally:
        lock.release()


class ChunkIndexCorruptError(RuntimeError):
    """The index failed its self-checksum or its parse: ``fsck`` (or the
    next take, which runs it) rebuilds it from the committed manifests."""


def norm_ref(path: str) -> str:
    """One ref id per snapshot path (trailing slashes and the ``fs://``
    spelling must not split a step in two)."""
    p = path.rstrip("/")
    if p.startswith("fs://"):
        p = p[len("fs://"):]
    return p


class ChunkIndex:
    def __init__(self, chunks: Optional[Dict[str, Dict[str, Any]]] = None) -> None:
        self.chunks: Dict[str, Dict[str, Any]] = chunks or {}

    def to_json(self) -> str:
        return json.dumps({"version": INDEX_VERSION, "chunks": self.chunks}, sort_keys=True)

    @classmethod
    def from_serialized(cls, s: str) -> "ChunkIndex":
        try:
            body, _ = strip_crc_trailer(s, _INDEX_CRC_MARKER, "chunk index", CHUNK_INDEX_FNAME)
            d = json.loads(body)
            chunks = {str(k): dict(v) for k, v in (d.get("chunks") or {}).items()}
            for key, entry in chunks.items():
                entry["size"] = int(entry.get("size", key_size(key)))
                entry["refs"] = [str(r) for r in entry.get("refs", [])]
        except Exception as e:
            raise ChunkIndexCorruptError(f"unusable {CHUNK_INDEX_FNAME}: {e!r}") from e
        return cls(chunks)

    @classmethod
    def load(cls, store: ChunkStore) -> "ChunkIndex":
        """The committed index, empty when none exists yet; a corrupt one
        raises ``ChunkIndexCorruptError``."""
        rio = ReadIO(path=CHUNK_INDEX_FNAME)
        try:
            store.storage.sync_read(rio)
        except FileNotFoundError:
            return cls()
        return cls.from_serialized(bytes(rio.buf).decode())

    def save(self, store: ChunkStore) -> None:
        store.storage.sync_write(
            WriteIO(
                path=CHUNK_INDEX_FNAME,
                buf=append_crc_trailer(self.to_json(), _INDEX_CRC_MARKER).encode(),
                durable=True,
            )
        )

    def live_keys(self) -> Set[str]:
        """Keys a take may dedup against: neither orphan-marked (it could
        be swept during the take) nor flagged missing by ``fsck`` (the
        take writes the content again, which heals the pool)."""
        return {
            k for k, e in self.chunks.items()
            if "orphaned_at" not in e and not e.get("missing")
        }

    def add_refs(self, ref_id: str, tables: Dict[str, Dict[str, Any]]) -> None:
        """Register every chunk the step's tables reference; an
        orphan-marked one is resurrected."""
        ref_id = norm_ref(ref_id)
        for table in tables.values():
            for key in table.get("keys", ()):
                entry = self.chunks.get(key)
                if entry is None:
                    entry = self.chunks[key] = {
                        "size": key_size(key), "refs": [], "added_by": ref_id,
                    }
                if ref_id not in entry["refs"]:
                    entry["refs"].append(ref_id)
                entry.pop("orphaned_at", None)

    def release(self, ref_id: str, now: Optional[float] = None) -> List[Tuple[str, int]]:
        """Drop one step's refs; chunks left with none are orphan-marked
        at ``now``.  Returns their ``(key, size)``: the bytes this delete
        un-shares."""
        ref_id = norm_ref(ref_id)
        now = time.time() if now is None else now
        zeroed: List[Tuple[str, int]] = []
        for key, entry in self.chunks.items():
            if ref_id in entry["refs"]:
                entry["refs"].remove(ref_id)
                if not entry["refs"] and "orphaned_at" not in entry:
                    entry["orphaned_at"] = now
                    zeroed.append((key, entry["size"]))
        return zeroed

    def mark(self, is_committed: Callable[[str], bool], now: Optional[float] = None) -> int:
        """The mark phase over the whole index: chunks with no committed
        ref are orphan-marked, chunks with one are resurrected.  Returns
        how many were newly marked.  Refs that only look dead are never
        pruned (an in-flight take's refs precede its marker); a chunk
        whose refs are all dead goes through the mark, grace and sweep."""
        now = time.time() if now is None else now
        verdicts: Dict[str, bool] = {}

        def committed(ref: str) -> bool:
            if ref not in verdicts:
                verdicts[ref] = bool(is_committed(ref))
            return verdicts[ref]

        marked = 0
        for entry in self.chunks.values():
            if any(committed(r) for r in entry["refs"]):
                entry.pop("orphaned_at", None)
            elif "orphaned_at" not in entry:
                entry["orphaned_at"] = now
                marked += 1
        return marked

    def sweep_due(self, grace_s: float, now: Optional[float] = None) -> List[str]:
        """Keys whose orphan mark has outlived the grace window (the
        caller checks their refs again before deleting)."""
        now = time.time() if now is None else now
        return sorted(
            k for k, e in self.chunks.items()
            if "orphaned_at" in e and now - e["orphaned_at"] >= grace_s
        )

    def remove(self, key: str) -> None:
        self.chunks.pop(key, None)

    def rollup(self) -> Dict[str, Any]:
        """The ``stats`` and ``cas`` commands' view: live and orphaned
        counts and bytes, the refcount histogram, and each step's new
        against shared bytes."""
        live = orphaned = live_bytes = orphaned_bytes = missing = 0
        ref_hist: Dict[str, int] = {}
        per_step: Dict[str, Dict[str, int]] = {}
        for entry in self.chunks.values():
            size = entry["size"]
            if entry.get("missing"):
                missing += 1
            if "orphaned_at" in entry:
                orphaned += 1
                orphaned_bytes += size
            else:
                live += 1
                live_bytes += size
            n = str(len(entry["refs"]))
            ref_hist[n] = ref_hist.get(n, 0) + 1
            for ref in entry["refs"]:
                st = per_step.setdefault(ref, {"chunks": 0, "new_bytes": 0, "shared_bytes": 0})
                st["chunks"] += 1
                st["new_bytes" if entry.get("added_by") == ref else "shared_bytes"] += size
        return {
            "chunks": len(self.chunks),
            "live_chunks": live,
            "orphaned_chunks": orphaned,
            "missing_chunks": missing,
            "live_bytes": live_bytes,
            "orphaned_bytes": orphaned_bytes,
            "refcount_histogram": dict(sorted(ref_hist.items())),
            "per_step": {k: per_step[k] for k in sorted(per_step)},
        }


def snapshot_is_committed(path: str) -> bool:
    """A readable, intact ``.snapshot_metadata`` is what committed means."""
    from ..snapshot import Snapshot

    try:
        Snapshot(path).metadata  # noqa: B018 — the parse is the check
        return True
    except Exception:  # noqa: BLE001 — absent or corrupt: not committed
        return False


def _local_base(root: str) -> Optional[str]:
    """The listable local path behind ``root`` (a bare path, ``fs://`` or
    ``file://``); None for other schemes."""
    if "://" not in root:
        return root
    scheme, path = root.split("://", 1)
    return path if scheme in ("", "fs", "file") else None


def _scan_sibling_snapshots(cas_root: str) -> List[str]:
    """The directories beside a local pool root (the manager layout)."""
    base = _local_base(cas_root.rstrip("/"))
    if base is None:
        return []
    parent, cas_name = os.path.dirname(base), os.path.basename(base)
    try:
        names = os.listdir(parent)
    except FileNotFoundError:
        return []
    return sorted(
        os.path.join(parent, n) for n in names
        if n != cas_name and os.path.isdir(os.path.join(parent, n))
    )


def _list_pool_keys(cas_root: str) -> Optional[Set[str]]:
    """Every chunk key present in a local pool; None for a root that
    cannot be listed."""
    local = _local_base(cas_root.rstrip("/"))
    if local is None:
        return None
    base = os.path.join(local, CHUNK_DIR)
    try:
        fanout = os.listdir(base)
    except FileNotFoundError:
        return set()
    keys: Set[str] = set()
    for d in fanout:
        try:
            keys.update(os.listdir(os.path.join(base, d)))
        except NotADirectoryError:
            continue
    return keys


def fsck(
    cas_root: str, snapshot_paths: Optional[List[str]] = None, now: Optional[float] = None
) -> Dict[str, Any]:
    """Rebuild the chunk index from the committed manifests (after a
    corrupt index, or a crash between a take's ref update and its
    marker).  On a local pool, chunks no committed manifest references
    are orphan-marked (never deleted here: the grace window still
    applies), and referenced chunks missing from the pool are flagged.

    ``snapshot_paths`` defaults to the directories beside the pool.  A
    default scan that finds no committed snapshot while the pool holds
    chunks (or cannot be listed) is refused: it cannot be told from a
    pool laid out elsewhere, and would orphan every chunk; pass the
    paths (``SnapshotManager.fsck()`` does)."""
    from ..snapshot import Snapshot

    now = time.time() if now is None else now
    scanned = snapshot_paths is None
    store = ChunkStore(cas_root)
    with obs.span("cas/fsck", root=cas_root), index_lock(cas_root):
        try:
            if snapshot_paths is None:
                snapshot_paths = _scan_sibling_snapshots(cas_root)
            index = ChunkIndex()
            committed = 0
            for path in snapshot_paths:
                try:
                    md = Snapshot(path).metadata
                except Exception:  # noqa: BLE001 — an aborted or corrupt step
                    continue
                committed += 1
                tables = chunk_tables_from_metadata(md)
                if tables:
                    index.add_refs(norm_ref(path), tables)
            pool_keys = _list_pool_keys(cas_root)
            if scanned and committed == 0 and (pool_keys is None or pool_keys):
                held = "cannot be listed" if pool_keys is None else f"holds {len(pool_keys)} chunk(s)"
                raise RuntimeError(
                    f"cas fsck: sibling scan of {cas_root!r} found no committed "
                    f"snapshots while the pool {held} — a custom or cloud pool "
                    "layout?  Rebuilding would orphan (or silently un-ref) every "
                    "chunk; pass the snapshot paths explicitly (SnapshotManager.fsck())."
                )
            orphans = 0
            missing: List[str] = []
            if pool_keys is not None:
                for key in pool_keys - set(index.chunks):
                    try:
                        size = key_size(key)
                    except (ValueError, IndexError):
                        continue  # a foreign file in the pool: left alone
                    index.chunks[key] = {
                        "size": size, "refs": [], "added_by": None, "orphaned_at": now,
                    }
                    orphans += 1
                missing = sorted(set(index.chunks) - pool_keys)
            if missing:
                logger.warning(
                    "cas fsck: %d referenced chunk(s) MISSING from the pool under "
                    "%r (first: %s) — the referencing steps will fail deep "
                    "verification", len(missing), cas_root, missing[:3],
                )
                for key in missing:
                    # the refs stay (the damage report); takes must not
                    # dedup against bytes that are gone
                    index.chunks[key]["missing"] = True
            index.save(store)
            obs.counter(obs.CAS_FSCKS).inc()
            return {
                "root": cas_root,
                "snapshots_committed": committed,
                "chunks": len(index.chunks),
                "orphans_marked": orphans,
                "missing_chunks": missing,
            }
        finally:
            store.sync_close()


def chunk_tables_from_metadata(metadata: Any) -> Dict[str, Dict[str, Any]]:
    """location → chunk table of a snapshot's chunk-referenced objects.
    A structurally invalid table is dropped with a warning, and its
    object is read as plain storage (where it fails loudly)."""
    cas = getattr(metadata, "cas", None) or {}
    out: Dict[str, Dict[str, Any]] = {}
    for loc, table in (cas.get("chunks") or {}).items():
        if validate_table(table):
            out[loc] = table
        else:
            logger.warning(
                "manifest chunk table for %r is structurally invalid (version "
                "skew?); treating the object as plain storage", loc,
            )
    return out
