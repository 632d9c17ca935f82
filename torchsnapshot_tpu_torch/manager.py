"""Snapshot lifecycle: step-indexed saves, resume, retention and GC.

Counterpart of ``torchsnapshot_tpu/manager.py``, with the same root
layout, so either package's manager reads the other's root:

- a step's snapshot is ``<root>/<prefix><step:010d>``;
- ``<root>/manager_index.json`` (``{"steps": [...]}``) lists the
  committed steps; a local fs root is also scanned, so snapshots taken
  without the manager, or an index lost in a crash, are found;
- only the commit protocol is trusted: a step counts when its
  ``.snapshot_metadata`` reads back;
- GC is metadata-first: deleting ``.snapshot_metadata`` un-commits the
  snapshot at once, so a crash midway leaves an aborted snapshot, never
  a committed one with missing objects;
- every rank calls ``save``/``restore_latest``; rank 0 resolves the step
  to restore or dedup against and broadcasts it, and rank 0 alone
  writes the index and runs retention, after the take's commit.

``save(incremental=True)`` dedups against the newest committed step
(``Snapshot.take(base=)``).  With the chunk store (``cas=``, or the
``CAS`` knob) every save stores its payload as chunks in ``<root>/cas``
and dedups against every committed step, retention deletes a step's
metadata first and then releases its chunk refs, and ``cas_gc`` and
``fsck`` (rank 0) mark, sweep and rebuild the pool's index.

Tiered managers (``tier=``, a ``TierConfig`` or a dict): ``root`` names
the DURABLE tier, each step also lands under ``tier.fast_root`` with the
same layout, and reads go fast-first.  ``steps()`` spans both tiers (a
write-back step is restorable from its fast copy as soon as it commits
there), ``durable_steps()`` only the durable one.  Fast-tier retention
(``fast_keep_last_n``) runs on every rank against its own fast root and
never evicts a step whose durable marker is missing (its fast copy may
be the only one); incremental links live in the durable tier, so no
fast eviction breaks a dedup chain.  Deleting a fast copy never releases
chunk refs (the durable step owns them).  ``repromote()`` re-enqueues
the promotion of fast-committed steps a crash left without a durable
marker; it runs once before a manager's first save.  ``repair(sources)``
heals steps a take committed degraded after a rank's death, from
continuous mirrors (``Snapshot.repair_degraded``).  ``publisher=`` (a
``publish.Publisher``): rank 0 publishes every committed save to a
live-weight publication root, best-effort (a failure is counted in
``exceptions.swallowed`` and logged; the save stands).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import weakref
from typing import Any, Dict, List, Optional, Sequence, Union

from . import knobs, obs
from .coordination import Coordinator, get_default_coordinator
from .event import Event
from .event_handlers import log_event
from .io_types import ReadIO, WriteIO
from .manifest import Entry, SnapshotMetadata
from .snapshot import SNAPSHOT_METADATA_FNAME, PendingSnapshot, Snapshot
from .storage import url_to_storage_plugin
from .tier import TierConfig

logger = logging.getLogger(__name__)

INDEX_FNAME = "manager_index.json"


def entry_locations(manifest: Dict[str, Entry]) -> List[str]:
    """Every stored object a manifest references, relative to the
    snapshot root: GC deletes through the plugin with no listing."""
    locs: set = set()
    for entry in manifest.values():
        loc = getattr(entry, "location", None)
        if isinstance(loc, str):
            locs.add(loc)
        for attr in ("shards", "chunks"):
            for piece in getattr(entry, attr, None) or ():
                if isinstance(getattr(piece, "location", None), str):
                    locs.add(piece.location)
    return sorted(locs)


def delete_snapshot(
    path: str,
    manifest: Optional[Dict[str, Entry]] = None,
    metadata: Optional[SnapshotMetadata] = None,
    release_cas: bool = True,
) -> None:
    """Delete one snapshot, committed or aborted, metadata first (see the
    module docstring).  ``manifest`` or ``metadata``, when the caller has
    them, spare the metadata read.  A snapshot whose metadata does not
    parse loses its metadata, and its objects stay behind (logged).

    Chunk-referenced objects have no per-step file: with ``release_cas``
    the step's refs are released in the pool index after the metadata
    goes (chunks left unreferenced are orphan-marked for the sweep; chunks
    other steps share stay).  A failed release is logged and left to the
    next ``cas_gc`` or ``fsck``."""
    with log_event(Event("delete_snapshot", {"path": path})), obs.span(
        "manager/delete_snapshot", path=path
    ):
        if metadata is not None and manifest is None:
            manifest = metadata.manifest
        storage = url_to_storage_plugin(path)
        try:
            if manifest is None:
                try:
                    read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
                    storage.sync_read(read_io)
                    metadata = SnapshotMetadata.from_yaml(bytes(read_io.buf).decode())
                    manifest = metadata.manifest
                except FileNotFoundError:
                    pass  # aborted: no manifest to enumerate
                except Exception as e:  # noqa: BLE001 — corrupt metadata
                    logger.warning(
                        "corrupt %s under %r (%r): deleting metadata only; "
                        "data objects may be left behind",
                        SNAPSHOT_METADATA_FNAME, path, e,
                    )
            cas_info = (metadata.cas or {}) if metadata is not None else {}
            chunked = set(cas_info.get("chunks") or {})
            try:
                storage.sync_delete(SNAPSHOT_METADATA_FNAME)
            except FileNotFoundError:
                pass
            reclaimed = 0
            extents = _expected_extents_safe(manifest) if manifest is not None else {}
            for loc in entry_locations(manifest) if manifest is not None else ():
                if loc in chunked:
                    continue  # its bytes are the pool's
                try:
                    storage.sync_delete(loc)
                    reclaimed += extents.get(loc, 0)
                except FileNotFoundError:
                    pass  # idempotent: a partial earlier GC
            if release_cas and chunked:
                from . import cas as cas_mod

                # strictly after the metadata: a crash in between leaves refs
                # of an uncommitted step, which the mark phase reclaims.  Only
                # chunks whose last ref went count as reclaimed
                try:
                    reclaimed += cas_mod.release_step(
                        cas_mod.resolve_root(path, str(cas_info.get("root"))), path
                    )
                except Exception as e:  # noqa: BLE001 — the delete itself succeeded
                    logger.warning(
                        "chunk-ref release for deleted %r failed (%r); the next "
                        "cas gc/fsck will reconcile", path, e,
                    )
            if reclaimed:
                obs.counter(obs.GC_BYTES_RECLAIMED).inc(reclaimed)
        finally:
            storage.sync_close()
        # a local fs root: the now-empty directory skeleton goes too
        if "://" not in path or path.startswith("file://"):
            shutil.rmtree(path.split("://", 1)[-1], ignore_errors=True)


def _expected_extents_safe(manifest: Dict[str, Entry]) -> Dict[str, int]:
    from .verify import _expected_extents

    try:
        return _expected_extents(manifest)
    except Exception:  # noqa: BLE001 — a metric only, never fails a delete
        return {}


class SnapshotManager:
    """Step-indexed snapshots under one root with bounded retention.

    >>> mgr = SnapshotManager("/ckpt/run7", keep_last_n=3)
    >>> start = mgr.restore_latest(app_state)   # None on a cold start
    >>> for step in range(start or 0, total):
    ...     ...
    ...     mgr.save(app_state, step=step, async_=True, incremental=True)

    ``keep_last_n`` counts committed snapshots; the newest N survive.
    Retention runs on rank 0 after each committed save (an async save's
    when it is waited on, or at the next save).

    ``cas``: the content-addressed chunk store (None defers to the ``CAS``
    knob; ``True`` puts the pool at ``<root>/cas``, a string names its
    root, a dict may add ``chunk_size_bytes``).  ``tier``: a fast tier in
    front of ``root`` (a ``TierConfig`` or its fields as a dict; see the
    module docstring)."""

    def __init__(
        self,
        root: str,
        keep_last_n: Optional[int] = None,
        prefix: str = "step_",
        coordinator: Optional[Coordinator] = None,
        tier: Any = None,
        cas: Any = None,
        publisher: Any = None,
    ) -> None:
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
        self.root = root.rstrip("/")
        if cas is None:
            cas = knobs.cas_enabled()
        if isinstance(cas, (bool, int)):
            cas = {} if cas else None
        elif isinstance(cas, str):
            cas = {"root": cas}
        if cas is not None:
            cas = dict(cas)
            cas.setdefault("root", f"{self.root}/cas")
        self.cas: Optional[Dict[str, Any]] = cas
        self.keep_last_n = keep_last_n
        self.prefix = prefix
        self._coordinator = coordinator
        # rank 0 only: async saves not yet indexed, step → weakref to the
        # PendingSnapshot (the commit thread holds it while it runs)
        self._pending_async: Dict[int, "weakref.ref[PendingSnapshot]"] = {}
        # steps whose commit was verified (commits are immutable)
        self._verified: Dict[int, Snapshot] = {}
        # steps the last _verify could not read the metadata of (perhaps
        # a passing outage): kept in the index, not counted as committed
        self._last_unverifiable: set = set()
        # tiered storage: ``root`` is the durable tier (module docstring)
        self.tier: Optional[TierConfig] = TierConfig(**tier) if isinstance(tier, dict) else tier
        # steps whose durable marker was seen (durability is monotonic:
        # one metadata read per step and manager)
        self._durable_confirmed: set = set()
        # the crash-recovery sweep runs once, before the first save
        self._repromoted = False
        # live-weight publication (publish/): rank 0 publishes every
        # committed save, best-effort (it never gates or fails the commit)
        self._publisher = publisher

    # ------------------------------------------------------------ paths

    def path_for_step(self, step: int) -> str:
        # fixed width: lexicographic order is numeric order
        return f"{self.root}/{self.prefix}{step:010d}"

    def fast_path_for_step(self, step: int) -> str:
        assert self.tier is not None
        return f"{self.tier.fast_root.rstrip('/')}/{self.prefix}{step:010d}"

    def _tier_storage_options(self, step: int) -> Optional[Dict[str, Any]]:
        """The ``storage_options`` that make this step's Snapshot tiered;
        None for an untiered manager."""
        if self.tier is None:
            return None
        t = self.tier
        peer_urls = None
        if t.peer_fast_roots:
            peer_urls = [f"{r.rstrip('/')}/{self.prefix}{step:010d}" for r in t.peer_fast_roots]
        return {
            "tier": {
                "fast_url": self.fast_path_for_step(step),
                "policy": t.policy,
                "replica_count": t.replica_count,
                "peer_fast_urls": peer_urls,
                "verify_fast_reads": t.verify_fast_reads,
            }
        }

    @property
    def _coord(self) -> Coordinator:
        return self._coordinator or get_default_coordinator()

    # -------------------------------------------------------- discovery

    def _read_index(self) -> List[int]:
        storage = url_to_storage_plugin(self.root)
        try:
            read_io = ReadIO(path=INDEX_FNAME)
            storage.sync_read(read_io)
            data = json.loads(bytes(read_io.buf).decode())
            return sorted(int(s) for s in data.get("steps", []))
        except FileNotFoundError:
            return []
        except Exception as e:  # noqa: BLE001 — a corrupt index: the scan rebuilds it
            logger.warning("unreadable %s (%r); falling back to scan", INDEX_FNAME, e)
            return []
        finally:
            storage.sync_close()

    def _write_index(self, steps: Sequence[int]) -> None:
        payload = json.dumps({"steps": sorted(set(steps))}).encode()
        storage = url_to_storage_plugin(self.root)
        try:
            storage.sync_write(WriteIO(path=INDEX_FNAME, buf=payload))
        finally:
            storage.sync_close()

    def _scan_fs(self) -> List[int]:
        """Committed step directories of a local fs root, and of the fast
        root too under a tier (a write-back step not promoted yet is only
        found there)."""
        steps = set(self._scan_dir(self.root))
        if self.tier is not None:
            steps |= set(self._scan_dir(self.tier.fast_root))
        return sorted(steps)

    def _scan_dir(self, root: str, require_metadata: bool = True) -> List[int]:
        """Step directories under a local fs ``root``; with
        ``require_metadata=False`` (fast-tier retention) also those
        without a commit marker (a durable fallback repairs data objects,
        never metadata, and such directories must stay evictable)."""
        if "://" in root and not root.startswith("file://"):
            return []
        base = root.split("://", 1)[-1]
        pat = re.compile(re.escape(self.prefix) + r"(\d+)")
        try:
            names = os.listdir(base)
        except FileNotFoundError:
            return []
        return sorted(
            int(m.group(1))
            for name in names
            if (m := pat.fullmatch(name))
            and (
                not require_metadata
                or os.path.exists(os.path.join(base, name, SNAPSHOT_METADATA_FNAME))
            )
        )

    def _verify(self, candidates: set, use_cache: bool = False) -> Dict[int, Snapshot]:
        """step → Snapshot of each committed candidate, ascending.  Metadata
        that does not read is "not committed" for this call, never a crash
        that blocks resuming from the snapshots that are fine.
        ``use_cache`` (retention sweeps only) trusts earlier verifications;
        ``steps`` and ``restore_latest`` always read afresh."""
        committed: Dict[int, Snapshot] = {}
        self._last_unverifiable = set()
        for step in sorted(candidates):
            if use_cache and step in self._verified:
                committed[step] = self._verified[step]
                continue
            snap = Snapshot(
                self.path_for_step(step), storage_options=self._tier_storage_options(step)
            )
            try:
                snap.metadata
            except FileNotFoundError:
                self._verified.pop(step, None)
                continue
            except Exception as e:  # noqa: BLE001 — corrupt, or a passing outage
                logger.warning(
                    "step %d has unreadable metadata (%r); treating as "
                    "uncommitted for this call", step, e,
                )
                self._last_unverifiable.add(step)
                self._verified.pop(step, None)
                continue
            self._verified[step] = snap
            committed[step] = snap
        return committed

    def _committed(self, use_cache: bool = False) -> Dict[int, Snapshot]:
        return self._verify(set(self._read_index()) | set(self._scan_fs()), use_cache)

    def steps(self) -> List[int]:
        """Committed steps, ascending (the index and the local scan)."""
        with obs.span("manager/steps", root=self.root):
            return list(self._committed())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def snapshot(self, step: int) -> Snapshot:
        return Snapshot(
            self.path_for_step(step), coordinator=self._coordinator,
            storage_options=self._tier_storage_options(step),
        )

    def durable_steps(self) -> List[int]:
        """Steps whose DURABLE commit marker reads back: those that would
        survive losing every fast tier.  A write-back step is in
        ``steps()`` once its fast commit lands, and here only once the
        promoter finished.  Untiered: ``steps()``."""
        with obs.span("manager/durable_steps", root=self.root):
            if self.tier is None:
                return self.steps()
            return [
                step
                for step in sorted(set(self._read_index()) | set(self._scan_fs()))
                if self._durable_ok(step)
            ]

    # ------------------------------------------------------- save/load

    def save(
        self,
        app_state: Dict[str, Any],
        step: int,
        replicated: Sequence[str] = (),
        async_: bool = False,
        incremental: bool = False,
        **take_kwargs: Any,
    ) -> Union[Snapshot, "_ManagedPendingSnapshot"]:
        """Take ``app_state`` as ``step``.  ``**take_kwargs`` go to
        ``Snapshot.take``/``async_take`` (``leaf_transform``,
        ``storage_options``).  ``incremental=True`` dedups against the
        newest committed step (``take(base=)``); with none committed it
        is a full save, and under ``cas`` the chunk store dedups every
        save already.  ``async_=True`` returns a handle whose ``wait()``
        also indexes the step and applies retention."""
        with log_event(
            Event("manager_save", {"root": self.root, "step": step, "async": async_})
        ):
            # the crash-recovery sweep before this process's first take:
            # nothing of this process is queued yet, so only steps a
            # previous crash orphaned are enqueued
            if self.tier is not None and not self._repromoted:
                self.repromote()
            path = self.path_for_step(step)
            tier_opts = self._tier_storage_options(step)
            if tier_opts is not None:
                take_kwargs["storage_options"] = {
                    **(take_kwargs.get("storage_options") or {}), **tier_opts,
                }
            if self.cas is not None:
                take_kwargs["cas"] = self.cas
            base: Optional[str] = None
            if incremental and self.cas is None:
                prev = self._coord.broadcast_object(
                    self.latest_step() if self._coord.rank == 0 else None, src=0
                )
                if prev is not None:
                    base = self.path_for_step(prev)
            if async_:
                pending = Snapshot.async_take(
                    path, app_state, replicated=replicated,
                    coordinator=self._coordinator, base=base, **take_kwargs,
                )
                # the index and retention do not run on the commit thread
                # (they would race a save on the index): they run at wait(),
                # and at the next save for a handle never waited on
                if self._coord.rank == 0:
                    self._pending_async[step] = weakref.ref(pending)
                return _ManagedPendingSnapshot(pending, self, step)
            snap = Snapshot.take(
                path, app_state, replicated=replicated,
                coordinator=self._coordinator, base=base, **take_kwargs,
            )
            self._after_commit(step)
            self._publish(step, snap)
            return snap

    def restore_latest(
        self,
        app_state: Dict[str, Any],
        strict: bool = True,
        paths: Optional[Sequence[str]] = None,
    ) -> Optional[int]:
        """Restore the newest committed step and return it, or None on a
        cold start.  Rank 0 chooses, every rank follows.  ``paths``
        restores the matching leaves only (``Snapshot.restore``)."""
        with log_event(Event("manager_restore_latest", {"root": self.root})) as event:
            step = self._coord.broadcast_object(
                self.latest_step() if self._coord.rank == 0 else None, src=0
            )
            event.metadata["step"] = step
            if step is None:
                return None
            self.snapshot(step).restore(app_state, strict=strict, paths=paths)
            return step

    # ------------------------------------------------------- retention

    def _publish(self, step: int, snap: Optional[Snapshot]) -> None:
        """Publish a committed step to the publication root (rank 0,
        best-effort: a failure is counted and logged, and subscribers stay
        at the previous published step)."""
        if self._publisher is None or self._coord.rank != 0:
            return
        try:
            self._publisher.publish_snapshot(
                self.path_for_step(step), step, metadata=None if snap is None else snap.metadata
            )
        except Exception as e:  # noqa: BLE001 — publication never fails a committed save
            obs.swallowed_exception("manager.publish", e)
            logger.warning(
                "publication of committed step %d failed; serving subscribers stay at the "
                "previous published step", step,
            )

    def _after_commit(self, step: Optional[int]) -> None:
        # fast-tier retention is rank-local (each host owns its fast
        # root), so it runs before the rank-0 gate
        self._apply_fast_retention()
        if self._coord.rank != 0:
            return
        # async saves whose commit thread has finished by now: committed
        # ones are indexed, failed ones (no metadata) dropped
        candidates = set(self._read_index()) | set(self._scan_fs())
        if step is not None:
            candidates.add(step)
        settled = set()
        for s, ref in self._pending_async.items():
            pending = ref()
            if pending is None or pending.done():
                settled.add(s)
        candidates |= settled
        committed = self._verify(candidates, use_cache=True)
        for s in settled:
            if s in committed:
                del self._pending_async[s]
            elif s not in self._last_unverifiable:
                logger.warning(
                    "async save for step %d finished without committing; "
                    "dropping it from the sweep list", s,
                )
                del self._pending_async[s]
        # a step whose metadata failed to read keeps its index entry: only
        # definitely absent metadata un-indexes a step
        self._write_index(sorted(set(committed) | self._last_unverifiable))
        self._apply_retention(committed)

    def gc(self) -> None:
        """Delete all but the newest ``keep_last_n`` committed snapshots
        and, with the chunk store, mark and sweep its pool (rank 0); under
        a tier, all but the newest ``fast_keep_last_n`` fast copies (every
        rank, its own fast root).  Safe to call at any time."""
        with log_event(Event("manager_gc", {"root": self.root})):
            self._apply_fast_retention()
            if self._coord.rank != 0:
                return
            if self.keep_last_n is not None:
                self._apply_retention(self._committed())
            if self.cas is not None:
                self.cas_gc()

    def _apply_retention(self, committed: Dict[int, Snapshot]) -> None:
        if self.keep_last_n is None:
            return
        evict = list(committed)[: -self.keep_last_n]
        for step in evict:
            logger.info("retention: deleting snapshot step %d", step)
            metadata = committed[step].metadata
            delete_snapshot(self.path_for_step(step), metadata=metadata)
            if self.tier is not None:
                # this rank's fast copy goes too (peers evict theirs in
                # their own sweeps); never releasing chunk refs twice, and
                # a degraded fast disk never fails a committed save
                try:
                    delete_snapshot(
                        self.fast_path_for_step(step), metadata=metadata, release_cas=False
                    )
                except Exception as e:  # noqa: BLE001 — retried by later sweeps
                    logger.warning(
                        "fast-tier delete of evicted step %d failed (%r); "
                        "leftover will be retried", step, e,
                    )
            self._verified.pop(step, None)
            self._durable_confirmed.discard(step)
        if evict:
            self._write_index(
                sorted((set(committed) - set(evict)) | self._last_unverifiable)
            )

    def _apply_fast_retention(self) -> None:
        """Keep fast copies of the newest ``fast_keep_last_n`` fast-resident
        steps and delete older ones from this rank's fast root, but only
        a step that is safe to lose locally: its durable marker reads
        back, or durable retention evicted it (no longer indexed, with a
        newer step indexed).  A write-back step not promoted yet holds
        the only copy and stays."""
        if self.tier is None:
            return
        keep = (
            self.tier.fast_keep_last_n
            if self.tier.fast_keep_last_n is not None
            else knobs.get_tier_fast_keep_last_n()
        )
        fast_steps = self._scan_dir(self.tier.fast_root, require_metadata=False)
        for step in fast_steps[:-keep] if keep else fast_steps:
            # the metadata carries the chunk tables: the delete then skips
            # locations that only ever lived in the pool
            metadata = None
            if self._durable_ok(step):
                try:
                    metadata = Snapshot(self.path_for_step(step)).metadata
                except Exception as e:  # noqa: BLE001 — evict without the list
                    logger.debug(
                        "fast-tier retention: durable manifest read for step %d "
                        "failed (%r)", step, e,
                    )
            else:
                idx = set(self._read_index())
                if not (idx and step not in idx and step < max(idx)):
                    logger.info(
                        "fast-tier retention: keeping step %d — not durably "
                        "committed yet", step,
                    )
                    continue
                try:
                    metadata = Snapshot(self.fast_path_for_step(step)).metadata
                except Exception as e:  # noqa: BLE001 — evict without the list
                    logger.debug(
                        "fast-tier retention: fast manifest read for step %d "
                        "failed (%r)", step, e,
                    )
            logger.info("fast-tier retention: evicting local copy of step %d", step)
            try:
                # a COPY's delete: the durable step keeps its chunk refs
                delete_snapshot(
                    self.fast_path_for_step(step), metadata=metadata, release_cas=False
                )
            except Exception as e:  # noqa: BLE001 — a committed save never fails here
                logger.warning(
                    "fast-tier eviction of step %d failed (%r); leftover will "
                    "be retried next sweep", step, e,
                )

    def repromote(self) -> List[int]:
        """Crash recovery for write-back tiers: re-enqueue the promotion
        of every fast-committed step whose durable marker is missing (the
        queue lives in memory, so a crash between the fast and the
        durable commit would leave an acknowledged step non-durable).
        Rank-local: each host copies what its fast root holds, and the
        durable marker lands only once every manifest location is
        durable (``PromotionGroup.recovery``).  Runs once per manager
        before its first save; returns the steps enqueued."""
        with obs.span("manager/repromote", root=self.root):
            self._repromoted = True
            if self.tier is None:
                return []
            from .tier.promoter import PromotionGroup, get_promoter

            enqueued = []
            idx = set(self._read_index())
            for step in self._scan_dir(self.tier.fast_root):
                if self._durable_ok(step):
                    continue
                # a step durable retention evicted (unindexed, with a
                # newer step indexed) must not come back to life
                if idx and step not in idx and step < max(idx):
                    continue
                try:
                    fast_md = Snapshot(self.fast_path_for_step(step)).metadata
                except Exception:  # noqa: BLE001 — not fast-committed
                    continue
                group = PromotionGroup(self.fast_path_for_step(step), self.path_for_step(step))
                # chunk-referenced locations live in the (durable) pool
                group.paths = set(entry_locations(fast_md.manifest)) - set(
                    (fast_md.cas or {}).get("chunks") or {}
                )
                group.recovery = True
                promoter = get_promoter()
                promoter.enqueue_data(group)
                promoter.enqueue_commit(group)
                logger.warning(
                    "re-promoting step %d: fast-committed but no durable commit "
                    "marker (promotion interrupted by a previous crash?)", step,
                )
                enqueued.append(step)
            return enqueued

    def _durable_ok(self, step: int) -> bool:
        """Whether the durable marker reads back (positives cached)."""
        if self.tier is None or step in self._durable_confirmed:
            return True
        try:
            Snapshot(self.path_for_step(step)).metadata  # noqa: B018
        except Exception:  # noqa: BLE001 — absent or unreachable
            return False
        self._durable_confirmed.add(step)
        return True

    # ------------------------------------------------ chunk pool: GC and fsck

    def _candidate_paths(self) -> List[str]:
        return [
            self.path_for_step(s) for s in sorted(set(self._read_index()) | set(self._scan_fs()))
        ]

    def cas_gc(self, grace_s: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Mark and sweep the chunk pool (rank 0): refs are checked
        against the commit markers, chunks with no committed ref are
        orphan-marked, and marks older than the grace window
        (``CAS_GC_GRACE_S`` unless ``grace_s``) are checked again and
        deleted.  The sweep's summary, None without the chunk store."""
        with obs.span("manager/cas_gc", root=self.root):
            if self.cas is None or self._coord.rank != 0:
                return None
            from . import cas as cas_mod

            return cas_mod.run_gc(self.cas["root"], self._candidate_paths(), grace_s=grace_s)

    def fsck(self) -> Optional[Dict[str, Any]]:
        """Rebuild the chunk index from this root's committed manifests
        (after a corrupt index, or a crash between a take's ref update and
        its marker).  The rebuild's summary, None without the chunk
        store."""
        with obs.span("manager/fsck", root=self.root):
            if self.cas is None:
                return None
            from . import cas as cas_mod

            return cas_mod.fsck(self.cas["root"], self._candidate_paths())

    def repair(self, sources: Sequence[str], step: Optional[int] = None) -> Dict[int, List[str]]:
        """Heal committed steps that a take surviving a rank's death
        committed degraded, from continuous mirrors
        (``Snapshot.repair_degraded``; ``sources``: continuous host roots
        holding ``r<rank>`` mirrors).  ``step`` limits it to one step;
        default every committed step with a ``degraded`` section.  Rank 0
        only.  Returns ``{step: repaired paths}``.  The next complete save
        heals too: under retention a degraded step ages out."""
        with log_event(Event("manager_repair", {"root": self.root})):
            if self._coord.rank != 0:
                return {}
            committed = self._committed()
            out: Dict[int, List[str]] = {}
            for s in [step] if step is not None else sorted(committed):
                snap = committed.get(s) or self.snapshot(s)
                try:
                    degraded = snap.metadata.degraded
                except Exception:  # noqa: BLE001 — an unreadable step is skipped
                    continue
                if degraded:
                    repaired = snap.repair_degraded(sources)
                    if repaired:
                        out[s] = repaired
            return out


class _ManagedPendingSnapshot:
    """A ``PendingSnapshot`` whose ``wait()`` also does the manager's
    bookkeeping: on rank 0 it indexes the step and applies retention."""

    def __init__(self, pending: PendingSnapshot, manager: SnapshotManager, step: int) -> None:
        self._pending = pending
        self._manager = manager
        self._step = step

    def wait(self) -> Snapshot:
        snap = self._pending.wait()
        self._manager._after_commit(self._step)
        self._manager._publish(self._step, snap)
        return snap

    def done(self) -> bool:
        return self._pending.done()
