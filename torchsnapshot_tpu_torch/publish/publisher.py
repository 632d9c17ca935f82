"""Training-side publication: durable commits become records a serving
fleet can delta-subscribe to.

Counterpart of ``torchsnapshot_tpu/publish/publisher.py``, writing its
records.  One ``Publisher`` owns one publication root and serves three
sources:

- ``publish_continuous(durable_store_root, step)``: the continuous
  loop's durable mirror (``continuous/store.py``); the step manifest's
  chunk keys become keyed refs, no data moves.  The loop calls it at
  every confirmed durable promotion.
- ``publish_snapshot(path, step, metadata=None)``: a committed snapshot;
  chunk tables become keyed chunk refs, whole-object digests keyed
  whole-object refs, slab members and objects with no digest un-keyed
  extent refs.  Codec-framed and sharded entries have no raw bytes to
  name: they are skipped and counted in ``publish.leaves_skipped``.
- ``publish_state(app_state, step)``: the live state itself, flattened,
  each leaf copied to the host (``encode_leaf``) and digested at the
  chunk size; only chunks the previous record did not name are written
  to the root's own ``objects/`` pool (the scheduler's budgeted buffer
  writes, span ``publish/pool_write``), then the record.

Every publication is the same marker-last commit (``record.py``), then a
best-effort KV announce (``announce.py``), then retention: records past
the window, and pool chunks only the superseded record named.
``last_state_s`` holds the last ``publish_state``'s seconds by phase
(``encode`` the host copies, ``digest``, ``write``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import knobs, obs
from ..cas.store import chunk_key, chunk_location, resolve_root
from ..continuous.store import ContinuousStore, encode_leaf, step_manifest_path
from ..coordination import Coordinator
from ..flatten import flatten
from ..resilience.failpoints import failpoint
from ..storage.stripe import plan_parts
from ..utils.checksums import adler32_fast, crc32_fast
from . import announce as announce_mod
from .record import PublishStore, build_record, make_ref, record_path

logger = logging.getLogger(__name__)


class Publisher:
    """See the module docstring.  Thread-safe: the continuous loop's
    worker and a training loop's saves may publish concurrently (the
    commits serialise under one lock)."""

    def __init__(
        self,
        root: str,
        coordinator: Optional[Coordinator] = None,
        retain: Optional[int] = None,
        chunk_size_bytes: Optional[int] = None,
    ) -> None:
        self.root = root.rstrip("/")
        self._coordinator = coordinator
        self._retain = retain
        self.chunk_size = int(chunk_size_bytes or knobs.get_cas_chunk_size_bytes())
        self._store = PublishStore(self.root)
        self._lock = threading.Lock()
        self._ns: Optional[str] = None
        # the last committed record (publish_state's delta basis) and the
        # steps THIS publisher committed, oldest first (retention's
        # candidates: a restarted publisher leaves its predecessor's tail)
        self._last_record: Optional[Dict[str, Any]] = None
        self._recent_steps: List[int] = []
        self._closed = False
        self.last_state_s: Dict[str, float] = {}

    @property
    def namespace(self) -> Optional[str]:
        """The announce namespace; None until the first announce (or with
        the announce off or no coordinator)."""
        with self._lock:
            return self._ns

    def _announce_ns(self) -> Optional[str]:
        if not knobs.publish_announce_enabled() or self._coordinator is None:
            return None
        if self._ns is None:
            self._ns = announce_mod.ns_for_root(self.root)
        return self._ns

    def _seed_last_record(self) -> None:
        """Adopt an existing root's HEAD record as the delta basis, so a
        restarted publisher does not write every pool chunk again."""
        try:
            head = self._store.read_head()
            if head is not None:
                self._last_record = self._store.read_record(str(head["record"]))
        except Exception as e:  # noqa: BLE001 — a corrupt old root costs one full publication
            obs.swallowed_exception("publish.seed", e)

    def publish_record(self, record: Dict[str, Any]) -> str:
        """Commit one record marker-last, announce it, prune; returns the
        record path.  The commit raises on failure; announce and prune
        are best-effort."""
        with obs.span("publish/record", step=record["step"], root=self.root):
            with self._lock:
                if self._closed:
                    raise RuntimeError("publisher is closed")
                if self._last_record is None:
                    self._seed_last_record()
                prev = self._last_record
                path = self._store.write_record(record)
                self._last_record = record
                obs.counter(obs.PUBLISH_RECORDS).inc()
                stats = record.get("stats") or {}
                obs.counter(obs.PUBLISH_BYTES_DELTA).inc(int(stats.get("bytes_delta", 0)))
                obs.counter(obs.PUBLISH_CHUNKS_DELTA).inc(int(stats.get("chunks_delta", 0)))
                # a publisher dying here (record durable, no announce) must
                # leave subscribers converging through the durable poll
                failpoint("publish.announce", step=record["step"])
                ns = self._announce_ns()
                if ns is not None:
                    announce_mod.announce(self._coordinator, ns, record["step"], path)
                self._prune(record, prev)
                return path

    def publish_continuous(self, durable_store_root: str, step: int) -> str:
        """Publish a confirmed durable promotion of the continuous loop:
        references only."""
        with obs.span("publish/from_continuous", step=step, source=durable_store_root):
            store = ContinuousStore(durable_store_root)
            try:
                man = store.read_step_manifest(step_manifest_path(step))
            finally:
                store.sync_close()
            leaves: Dict[str, Any] = {}
            for path, rec in man["leaves"].items():
                leaf = {k: v for k, v in rec.items() if k != "keys"}
                leaf["refs"] = [make_ref(k, 0, chunk_location(k)) for k in rec["keys"]]
                leaves[path] = leaf
            bases = [durable_store_root.rstrip("/")]
            record = build_record(
                step, "continuous", bases, leaves, stats=self._delta_stats(leaves, bases)
            )
            return self.publish_record(record)

    def publish_snapshot(self, path: str, step: int, metadata: Any = None) -> str:
        """Publish a committed snapshot (see the module docstring)."""
        with obs.span("publish/from_snapshot", step=step, source=path):
            if metadata is None:
                from ..snapshot import Snapshot

                metadata = Snapshot(path).metadata
            from ..manifest import PrimitiveEntry, is_container_entry
            from ..manifest_ops import get_manifest_for_rank

            snap_root = path.rstrip("/")
            bases: List[str] = [snap_root]
            cas_doc = getattr(metadata, "cas", None) or {}
            cas_tables: Dict[str, Any] = dict(cas_doc.get("chunks") or {})
            cas_base_idx: Optional[int] = None
            if cas_tables:
                bases.append(resolve_root(snap_root, str(cas_doc.get("root"))))
                cas_base_idx = 1
            objects: Dict[str, Any] = getattr(metadata, "objects", {}) or {}
            codecs: Dict[str, Any] = getattr(metadata, "codecs", {}) or {}
            leaves: Dict[str, Any] = {}
            skipped = 0
            # rank 0's logical view: the paths a subscriber's flatten of
            # the same app state produces
            for lpath, entry in get_manifest_for_rank(metadata, 0).items():
                if is_container_entry(entry):
                    continue
                if isinstance(entry, PrimitiveEntry):
                    # inlined, as in the metadata: no refs
                    leaves[lpath] = {
                        "kind": "prim", "ptype": entry.type, "v": entry.readable,
                        "size": 0, "refs": [],
                    }
                    continue
                leaf = _snapshot_leaf(entry, cas_tables, cas_base_idx, objects, codecs)
                if leaf is None:
                    skipped += 1
                    continue
                leaves[lpath] = leaf
            if skipped:
                obs.counter(obs.PUBLISH_LEAVES_SKIPPED).inc(skipped)
                logger.warning(
                    "publication of %s skipped %d leaves (codec-framed or sharded entries "
                    "have no raw-byte refs)", path, skipped,
                )
            record = build_record(
                step, "snapshot", bases, leaves, stats=self._delta_stats(leaves, bases)
            )
            return self.publish_record(record)

    def publish_state(self, app_state: Dict[str, Any], step: int) -> str:
        """Publish the live state into this root's own chunk pool (see
        the module docstring)."""
        with obs.span("publish/from_state", step=step, root=self.root):
            with self._lock:
                if self._last_record is None:
                    self._seed_last_record()
                prev = self._last_record
            state_tree = {
                k: (v.state_dict() if hasattr(v, "state_dict") else v) for k, v in app_state.items()
            }
            _manifest, flattened = flatten(state_tree)
            prev_keys = _record_keys(prev)
            leaves: Dict[str, Any] = {}
            new_chunks: List[Tuple[str, Any]] = []
            staged_keys: Set[str] = set()
            encode_s = digest_s = 0.0
            for lpath in sorted(flattened):
                t0 = time.monotonic()
                rec, view = encode_leaf(flattened[lpath])
                t1 = time.monotonic()
                refs = []
                for lo, hi in plan_parts(view.nbytes, self.chunk_size):
                    piece = view[lo:hi]
                    key = chunk_key((crc32_fast(piece), adler32_fast(piece), piece.nbytes))
                    refs.append(make_ref(key, 0, chunk_location(key)))
                    if key not in prev_keys and key not in staged_keys:
                        staged_keys.add(key)
                        new_chunks.append((chunk_location(key), piece))
                rec["refs"] = refs
                leaves[lpath] = rec
                encode_s += t1 - t0
                digest_s += time.monotonic() - t1
            t2 = time.monotonic()
            self._write_pool_chunks(new_chunks)
            self.last_state_s = {
                "encode": encode_s, "digest": digest_s, "write": time.monotonic() - t2,
            }
            record = build_record(
                step, "state", [self.root], leaves, stats=self._delta_stats(leaves, [self.root])
            )
            return self.publish_record(record)

    def _write_pool_chunks(self, new_chunks: List[Tuple[str, Any]]) -> None:
        if not new_chunks:
            return
        from .. import scheduler

        scheduler.sync_execute_buffer_writes(
            new_chunks,
            self._store.storage,
            scheduler.get_process_memory_budget_bytes(),
            obs.BYTES_WRITTEN,
            span_label="publish/pool_write",
        )

    def _delta_stats(self, leaves: Dict[str, Any], bases: List[str]) -> Dict[str, int]:
        """This record's wire cost for a subscriber holding the PREVIOUS
        record (the steady-state update size)."""
        from .delta import plan_delta

        with self._lock:
            prev = self._last_record
        prev_probe = None
        if prev is not None:
            prev_probe = {"bases": prev["bases"], "leaves": prev["leaves"], "step": -1}
        plan = plan_delta({"bases": bases, "leaves": leaves, "step": -1}, prev_probe)
        return {
            "bytes_delta": plan.stats["bytes_fetch"],
            "bytes_total": plan.stats["bytes_total"],
            "chunks_delta": plan.stats["chunks_fetch"],
            "chunks_total": plan.stats["chunks_total"],
        }

    def _prune(self, record: Dict[str, Any], prev: Optional[Dict[str, Any]]) -> None:
        """Drop records past the retention window (this publisher's own,
        oldest first) and, between two own-pool publications, the chunks
        the superseded record named that the new one does not.  Pruning
        at depth 1 keeps the pool safe for subscribers holding the
        previous record (the only ones a delta applies against); older
        ones full-fetch the current record, whose chunks stay.
        Best-effort: a failed delete leaks bytes, never a publication."""
        try:
            retain = self._retain if self._retain is not None else knobs.get_publish_retain()
            self._recent_steps.append(int(record["step"]))
            while len(self._recent_steps) > retain:
                self._store.delete_quiet(record_path(self._recent_steps.pop(0)))
            if prev is not None and record.get("source") == "state" and prev.get("source") == "state":
                for key in sorted(_record_keys(prev) - _record_keys(record)):
                    self._store.delete_quiet(chunk_location(key))
        except Exception as e:  # noqa: BLE001 — retention is advisory
            obs.swallowed_exception("publish.prune", e)

    def close(self) -> None:
        """Clean shutdown: clear the announce key, release storage."""
        with obs.span("publish/close", root=self.root):
            with self._lock:
                if self._closed:
                    return
                self._closed = True
                if self._ns is not None and self._coordinator is not None:
                    try:
                        announce_mod.clear(self._coordinator, self._ns)
                    except Exception as e:  # noqa: BLE001 — best-effort
                        obs.swallowed_exception("publish.close", e)
                self._store.sync_close()


def _record_keys(record: Optional[Dict[str, Any]]) -> Set[str]:
    if record is None:
        return set()
    return {
        ref["k"]
        for leaf in record["leaves"].values()
        for ref in leaf["refs"]
        if ref.get("k") is not None
    }


def _snapshot_leaf(
    entry: Any,
    cas_tables: Dict[str, Any],
    cas_base_idx: Optional[int],
    objects: Dict[str, Any],
    codecs: Dict[str, Any],
) -> Optional[Dict[str, Any]]:
    """One manifest entry → a publication leaf, or None when the entry has
    no raw-byte form (codec-framed, sharded, or no digest and no extent)."""
    kind = type(entry).__name__
    if kind == "ObjectEntry":
        pieces = [(entry.location, getattr(entry, "byte_range", None))]
        meta: Dict[str, Any] = {"kind": "object", "tag": getattr(entry, "serializer", "object")}
    elif kind == "ArrayEntry":
        pieces = [(entry.location, getattr(entry, "byte_range", None))]
        meta = {"kind": "array", "dtype": str(entry.dtype), "shape": [int(d) for d in entry.shape]}
    elif kind == "ChunkedArrayEntry":
        pieces = [(c.location, getattr(c, "byte_range", None)) for c in entry.chunks]
        meta = {"kind": "array", "dtype": str(entry.dtype), "shape": [int(d) for d in entry.shape]}
    else:
        return None  # sharded (per-rank boxes): not hot-swappable
    refs: List[Dict[str, Any]] = []
    for loc, byte_range in pieces:
        if loc in codecs:
            return None  # framed bytes are not the leaf's raw bytes
        table = cas_tables.get(loc)
        if table is not None and byte_range is None:
            assert cas_base_idx is not None
            refs.extend(make_ref(k, cas_base_idx, chunk_location(k)) for k in table["keys"])
            continue
        digest = objects.get(loc)
        if digest is not None and byte_range is None:
            key = chunk_key((int(digest[0]), int(digest[1]), int(digest[2])))
            refs.append(make_ref(key, 0, loc))
            continue
        if byte_range is None:
            return None  # no digest, no extent: its length is unknown here
        lo, hi = int(byte_range[0]), int(byte_range[1])
        refs.append(make_ref(None, 0, loc, byte_range=[lo, hi], nbytes=hi - lo))
    meta["size"] = sum(int(r["n"]) for r in refs)
    meta["refs"] = refs
    return meta
