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
(``Snapshot.take(base=)``).  Not ported yet: tiered storage (``tier=``)
and the content-addressed chunk store (``cas=``, the CAS knob,
``cas_gc``, ``fsck``), both ROADMAP queue A item 5; live-weight
publication (``publisher=``), ``repromote`` and ``repair``, queue A
item 7.  Each raises ``NotImplementedError``.
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

logger = logging.getLogger(__name__)

INDEX_FNAME = "manager_index.json"


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"SnapshotManager {what} is not ported yet (ROADMAP queue A item {item})"
    )


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
) -> None:
    """Delete one snapshot, committed or aborted, metadata first (see the
    module docstring).  ``manifest`` or ``metadata``, when the caller has
    them, spare the metadata read.  A snapshot whose metadata does not
    parse loses its metadata, and its objects stay behind (logged)."""
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
            if metadata is not None and (metadata.cas or {}).get("chunks"):
                # chunk references are released by the chunk store's GC
                raise _not_ported("deletion of a content-addressed snapshot", 5)
            try:
                storage.sync_delete(SNAPSHOT_METADATA_FNAME)
            except FileNotFoundError:
                pass
            reclaimed = 0
            extents = _expected_extents_safe(manifest) if manifest is not None else {}
            for loc in entry_locations(manifest) if manifest is not None else ():
                try:
                    storage.sync_delete(loc)
                    reclaimed += extents.get(loc, 0)
                except FileNotFoundError:
                    pass  # idempotent: a partial earlier GC
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
    when it is waited on, or at the next save)."""

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
        if tier is not None:
            raise _not_ported("tier= (tiered storage)", 5)
        if cas is None:
            cas = knobs.cas_enabled()
        if cas not in (False, 0):
            raise _not_ported("cas= (the content-addressed chunk store)", 5)
        if publisher is not None:
            raise _not_ported("publisher= (live-weight publication)", 7)
        self.root = root.rstrip("/")
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

    # ------------------------------------------------------------ paths

    def path_for_step(self, step: int) -> str:
        # fixed width: lexicographic order is numeric order
        return f"{self.root}/{self.prefix}{step:010d}"

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
        """Committed step directories of a local fs root."""
        if "://" in self.root and not self.root.startswith("file://"):
            return []
        base = self.root.split("://", 1)[-1]
        pat = re.compile(re.escape(self.prefix) + r"(\d+)")
        try:
            names = os.listdir(base)
        except FileNotFoundError:
            return []
        return sorted(
            int(m.group(1))
            for name in names
            if (m := pat.fullmatch(name))
            and os.path.exists(os.path.join(base, name, SNAPSHOT_METADATA_FNAME))
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
            snap = Snapshot(self.path_for_step(step))
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
        return Snapshot(self.path_for_step(step), coordinator=self._coordinator)

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
        is a full save.  ``async_=True`` returns a handle whose
        ``wait()`` also indexes the step and applies retention."""
        with log_event(
            Event("manager_save", {"root": self.root, "step": step, "async": async_})
        ):
            path = self.path_for_step(step)
            base: Optional[str] = None
            if incremental:
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

    def _after_commit(self, step: Optional[int]) -> None:
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
        (rank 0).  Safe to call at any time."""
        with log_event(Event("manager_gc", {"root": self.root})):
            if self._coord.rank == 0 and self.keep_last_n is not None:
                self._apply_retention(self._committed())

    def _apply_retention(self, committed: Dict[int, Snapshot]) -> None:
        if self.keep_last_n is None:
            return
        evict = list(committed)[: -self.keep_last_n]
        for step in evict:
            logger.info("retention: deleting snapshot step %d", step)
            delete_snapshot(self.path_for_step(step), metadata=committed[step].metadata)
            self._verified.pop(step, None)
        if evict:
            self._write_index(
                sorted((set(committed) - set(evict)) | self._last_unverifiable)
            )

    # ------------------------------------------------ not ported yet

    def repromote(self) -> List[int]:
        raise _not_ported("repromote (tiered storage)", 5)

    def cas_gc(self, grace_s: Optional[float] = None) -> Optional[Dict[str, Any]]:
        raise _not_ported("cas_gc (the content-addressed chunk store)", 5)

    def fsck(self) -> Optional[Dict[str, Any]]:
        raise _not_ported("fsck (the content-addressed chunk store)", 5)

    def repair(self, *args: Any, **kwargs: Any) -> Any:
        raise _not_ported("repair (write takeover and degraded repair)", 7)


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
        return snap

    def done(self) -> bool:
        return self._pending.done()
