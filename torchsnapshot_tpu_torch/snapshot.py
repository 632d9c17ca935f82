"""The user-facing Snapshot API: take / async_take / restore /
read_object / metadata.

Counterpart of ``torchsnapshot_tpu/snapshot.py`` for one process.  The
orchestration is the JAX package's:

- ``take`` flattens every stateful's ``state_dict`` into logical paths,
  plans one write per leaf, coalesces small writes into slabs, stages
  and writes them under a host-memory budget, and commits by writing
  ``.snapshot_metadata`` last (a snapshot without it is incomplete);
- ``async_take`` plans the same writes, makes each independent of the
  live state (``host_offload.py``: device-side copies of CUDA tensors,
  host copies of host ones) and returns a ``PendingSnapshot``; staging,
  I/O and the commit run on a background thread, an error surfaces from
  ``wait()``, and ``.snapshot_metadata`` is never written on failure;
- ``restore`` reads each leaf INTO the current state's tensors (restore
  templates, updated in place), RNG state last;
- ``read_object`` reads one leaf by ``"<rank>/<logical path>"``.

Snapshots are interchangeable with the JAX package's: same manifest,
same object layout, same checksums.  Not ported yet: incremental and
content-addressed takes, tiered storage, topology and transport,
liveness, write takeover and repair.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import knobs, obs
from .batcher import batch_read_requests, batch_write_requests
from .coordination import LocalCoordinator, get_default_coordinator
from .event import Event
from .event_handlers import log_event
from .flatten import flatten, inflate
from .io_types import Future, ReadIO, ReadReq, WriteIO, WriteReq
from .manifest import (
    MANIFEST_VERSION,
    ChunkedArrayEntry,
    Entry,
    Manifest,
    PrimitiveEntry,
    SnapshotMetadata,
    is_container_entry,
)
from .manifest_ops import consolidate_manifests, get_manifest_for_rank
from .partitioner import partition_replicated_writes
from .preparers import path_is_replicated, prepare_read, prepare_write
from .scheduler import (
    PendingIOWork,
    execute_write_reqs,
    get_process_memory_budget_bytes,
    sync_execute_read_reqs,
)
from .stateful import RNGState, load_with_strict
from .storage import url_to_storage_plugin

logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"
AppState = Dict[str, Any]


def _validate_app_state(app_state: AppState) -> None:
    for key, value in app_state.items():
        if not (hasattr(value, "state_dict") and hasattr(value, "load_state_dict")):
            raise TypeError(
                f"app_state[{key!r}] (type {type(value)}) does not implement "
                "the Stateful protocol (state_dict/load_state_dict); wrap "
                "plain values in StateDict or nested tensors in PyTreeState"
            )


def _place(obj: Any, template: Any, device: Any) -> Any:
    """A restored tensor with no array template goes to ``device``; one
    restored into its template already sits where the template does."""
    if isinstance(obj, torch.Tensor) and not isinstance(
        template, (torch.Tensor, np.ndarray)
    ):
        return obj.to(device)
    return obj


@dataclasses.dataclass
class _TakePlan:
    """A take's planned writes and the records they fill in: checksum
    sinks stamp the entries while staging runs, so the metadata is
    rendered after the writes."""

    manifest: Manifest
    entries: Dict[str, Entry]
    write_reqs: List[WriteReq]
    object_digests: Dict[str, List[int]]
    world: int

    def metadata(self) -> SnapshotMetadata:
        return SnapshotMetadata(
            version=MANIFEST_VERSION,
            world_size=self.world,
            manifest=consolidate_manifests([{**self.manifest, **self.entries}]),
            objects=self.object_digests,
        )


def _commit(storage: Any, metadata: SnapshotMetadata) -> None:
    """The commit point: metadata last, durably."""
    storage.sync_write(
        WriteIO(
            path=SNAPSHOT_METADATA_FNAME,
            buf=metadata.to_yaml().encode(),
            durable=True,
        )
    )


class Snapshot:
    def __init__(self, path: str, coordinator: Optional[LocalCoordinator] = None) -> None:
        self.path = path
        self._coordinator = coordinator or get_default_coordinator()
        self._metadata_cache: Optional[SnapshotMetadata] = None

    # ------------------------------------------------------------------ take

    @classmethod
    def take(
        cls,
        path: str,
        app_state: AppState,
        replicated: Sequence[str] = (),
        coordinator: Optional[LocalCoordinator] = None,
    ) -> "Snapshot":
        """Save ``app_state`` (name → Stateful) to ``path``.  Leaves whose
        logical path matches a ``replicated`` glob are stored once for
        all ranks under ``replicated/``."""
        coordinator = coordinator or get_default_coordinator()
        _validate_app_state(app_state)
        with log_event(Event("take", {"path": path, "rank": coordinator.rank})):
            plan = cls._plan_at_entry(path, app_state, replicated, coordinator, is_async=False)
            storage = url_to_storage_plugin(path)
            try:
                execute_write_reqs(
                    plan.write_reqs, storage, get_process_memory_budget_bytes(),
                    coordinator.rank,
                ).sync_complete()
                metadata = plan.metadata()
                _commit(storage, metadata)
            finally:
                storage.sync_close()
        snapshot = cls(path, coordinator)
        snapshot._metadata_cache = metadata
        return snapshot

    @classmethod
    def async_take(
        cls,
        path: str,
        app_state: AppState,
        replicated: Sequence[str] = (),
        coordinator: Optional[LocalCoordinator] = None,
    ) -> "PendingSnapshot":
        """Save ``app_state`` to ``path`` in the background.  Returns once
        the snapshot's content is independent of the live state: CUDA
        tensors are copied on the device (on the caller's current stream,
        with no host wait) and host tensors on the host
        (``host_offload.py``), so the caller may run its next step, which
        changes the state in place, right away.  Staging, storage I/O
        and the commit run on a background thread; ``wait()`` returns
        the committed ``Snapshot`` or raises the error, in which case
        ``.snapshot_metadata`` was never written.  With the knob
        TORCHSNAPSHOT_TPU_TORCH_DISABLE_EAGER_HOST_STAGING=1 it returns
        only after every write is staged in host memory."""
        from .host_offload import eager_offload_write_reqs

        coordinator = coordinator or get_default_coordinator()
        _validate_app_state(app_state)
        with log_event(Event("async_take", {"path": path, "rank": coordinator.rank})):
            plan = cls._plan_at_entry(path, app_state, replicated, coordinator, is_async=True)
            unblock_early = not knobs.is_eager_host_staging_disabled()
            if unblock_early:
                eager_offload_write_reqs(plan.write_reqs)
            storage = url_to_storage_plugin(path)
            try:
                pending_io = execute_write_reqs(
                    plan.write_reqs, storage, get_process_memory_budget_bytes(),
                    coordinator.rank, wait_for_staging=not unblock_early,
                )
            except BaseException:
                storage.sync_close()
                raise
        return PendingSnapshot(path, coordinator, plan, pending_io, storage)

    @classmethod
    def _plan_at_entry(
        cls,
        path: str,
        app_state: AppState,
        replicated: Sequence[str],
        coordinator: LocalCoordinator,
        is_async: bool,
    ) -> _TakePlan:
        # a take must not perturb the RNG streams, and the state saved
        # is the state at entry: capture now, restore on the way out
        rng_at_entry = RNGState().state_dict()
        rng_states_at_entry = {
            k: v.state_dict()
            for k, v in app_state.items()
            if isinstance(v, RNGState)
        }
        try:
            return cls._plan(
                app_state, replicated, coordinator, rng_states_at_entry, is_async
            )
        finally:
            for k, v in app_state.items():
                if isinstance(v, RNGState):
                    v.load_state_dict(rng_states_at_entry[k])
            RNGState().load_state_dict(rng_at_entry)

    @classmethod
    def _plan(
        cls,
        app_state: AppState,
        replicated: Sequence[str],
        coordinator: LocalCoordinator,
        rng_states_at_entry: Dict[str, Dict[str, Any]],
        is_async: bool,
    ) -> _TakePlan:
        rank, world = coordinator.rank, coordinator.world_size
        replicated_globs = sorted(set(replicated))
        manifest: Manifest = {}
        flattened: Dict[str, Any] = {}
        for key in sorted(app_state):
            state = rng_states_at_entry.get(key)
            if state is None:
                state = app_state[key].state_dict()
            m, f = flatten(state, prefix=key)
            manifest.update(m)
            flattened.update(f)

        entries: Dict[str, Entry] = {}
        write_reqs: List[WriteReq] = []
        repl_items = []
        repl_reqs: Dict[str, List[WriteReq]] = {}
        split_repl_paths = set()
        chunk_size_bytes = knobs.get_max_chunk_size_bytes()
        with obs.span("take/plan", leaves=len(flattened), rank=rank):
            for lpath in sorted(flattened):
                repl = path_is_replicated(lpath, replicated_globs)
                entry, reqs = prepare_write(
                    flattened[lpath], lpath, rank, replicated=repl,
                    chunk_size_bytes=chunk_size_bytes, is_async_snapshot=is_async,
                )
                entries[lpath] = entry
                if not repl:
                    write_reqs.extend(reqs)
                elif isinstance(entry, ChunkedArrayEntry) and len(reqs) > 1:
                    # chunk-granular writers; such entries stay out of
                    # slabs (a slab would re-point a shared entry at a
                    # rank-local location)
                    for ci, r in enumerate(reqs):
                        k = f"{lpath}\x00{ci}"
                        repl_reqs[k] = [r]
                        repl_items.append((k, r.buffer_stager.get_staging_cost_bytes()))
                    split_repl_paths.add(lpath)
                else:
                    repl_reqs[lpath] = reqs
                    repl_items.append((
                        lpath,
                        sum(r.buffer_stager.get_staging_cost_bytes() for r in reqs),
                    ))
        assignment = partition_replicated_writes(repl_items, world)
        for k, reqs in repl_reqs.items():
            if assignment[k] == rank:
                write_reqs.extend(reqs)

        if not knobs.is_batching_disabled():
            shielded = {lp: entries.pop(lp) for lp in split_repl_paths}
            entries, write_reqs = batch_write_requests(entries, write_reqs, rank)
            entries.update(shielded)

        object_digests: Dict[str, List[int]] = {}
        for wr in write_reqs:
            wr.digest_sink = (
                lambda d, p=wr.path: object_digests.__setitem__(p, list(d))
            )
        return _TakePlan(manifest, entries, write_reqs, object_digests, world)

    # --------------------------------------------------------------- restore

    @property
    def metadata(self) -> SnapshotMetadata:
        if self._metadata_cache is None:
            storage = url_to_storage_plugin(self.path)
            try:
                read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
                storage.sync_read(read_io)
            except FileNotFoundError as e:
                raise FileNotFoundError(
                    f"no {SNAPSHOT_METADATA_FNAME} under {self.path!r} — "
                    "not a committed snapshot"
                ) from e
            finally:
                storage.sync_close()
            self._metadata_cache = SnapshotMetadata.from_yaml(
                bytes(read_io.buf).decode()
            )
        return self._metadata_cache

    def restore(
        self, app_state: AppState, strict: bool = True, device: Any = "cuda"
    ) -> None:
        """Load the snapshot into ``app_state``.  Tensors in the current
        state are restore templates and are updated IN PLACE (cast to
        their dtype, on their device); a tensor leaf with no tensor
        template comes back on ``device``."""
        _validate_app_state(app_state)
        rank = self._coordinator.rank
        with log_event(Event("restore", {"path": self.path, "rank": rank})):
            manifest_for_rank = get_manifest_for_rank(self.metadata, rank)
            storage = url_to_storage_plugin(self.path)
            try:
                # RNG state last, so no other restore can perturb it
                keys = sorted(app_state)
                keys.sort(key=lambda k: isinstance(app_state[k], RNGState))
                for key in keys:
                    self._load_stateful(
                        key, app_state[key], manifest_for_rank, storage,
                        strict, rank, device,
                    )
            finally:
                storage.sync_close()

    def _load_stateful(
        self, key: str, stateful: Any, manifest_for_rank: Manifest,
        storage: Any, strict: bool, rank: int, device: Any,
    ) -> None:
        with obs.span("restore/load_stateful", key=key, rank=rank):
            key_manifest = {
                p: e
                for p, e in manifest_for_rank.items()
                if p == key or p.startswith(key + "/")
            }
            if not key_manifest:
                if strict:
                    raise KeyError(
                        f"app_state key {key!r} not found in snapshot manifest"
                    )
                logger.warning("skipping %r: not in snapshot", key)
                return
            degraded = sorted(set(self.metadata.degraded) & set(key_manifest))
            if degraded:
                raise RuntimeError(
                    f"snapshot {self.path!r} is degraded at {degraded[:5]}: "
                    "their payloads were lost with a dead rank"
                )
            # the current state provides the in-place templates
            _, targets = flatten(stateful.state_dict(), prefix=key)
            container_entries: Manifest = {}
            read_reqs: List[ReadReq] = []
            futures: Dict[str, Future] = {}
            for lpath, entry in key_manifest.items():
                if is_container_entry(entry):
                    container_entries[lpath] = entry
                    continue
                reqs, fut = prepare_read(entry, obj_out=targets.get(lpath))
                read_reqs.extend(reqs)
                futures[lpath] = fut
            if not knobs.is_batching_disabled():
                read_reqs = batch_read_requests(read_reqs)
            sync_execute_read_reqs(
                read_reqs, storage, get_process_memory_budget_bytes(), rank
            )
            state_dict = inflate(
                container_entries,
                {
                    lpath: _place(fut.obj, targets.get(lpath), device)
                    for lpath, fut in futures.items()
                },
                prefix=key,
                allow_missing=not strict,
            )
            load_with_strict(stateful, state_dict, strict)

    # ----------------------------------------------------------- read_object

    def read_object(
        self, path: str, obj_out: Optional[Any] = None, device: Any = "cuda"
    ) -> Any:
        """One object by ``"<rank>/<logical_path>"``; a tensor or numpy
        ``obj_out`` is filled in place and returned, else a new tensor on
        ``device`` (or the decoded object) comes back."""
        with log_event(Event("read_object", {"path": path})):
            rank_str, _, lpath = path.partition("/")
            manifest = get_manifest_for_rank(self.metadata, int(rank_str))
            if lpath not in manifest:
                raise KeyError(f"{lpath!r} not in snapshot manifest")
            entry = manifest[lpath]
            if isinstance(entry, PrimitiveEntry):
                return entry.get_value()
            reqs, fut = prepare_read(entry, obj_out=obj_out)
            storage = url_to_storage_plugin(self.path)
            try:
                sync_execute_read_reqs(
                    reqs, storage, get_process_memory_budget_bytes(), rank=0
                )
            finally:
                storage.sync_close()
            return _place(fut.obj, obj_out, device)


class PendingSnapshot:
    """Handle for an in-flight ``async_take`` (the JAX package's
    ``PendingSnapshot`` for one process: no commit barrier across ranks).
    A background thread drains the writes and, only if every one
    succeeded, writes ``.snapshot_metadata``.  Two takes in flight at
    once each own their threads and storage."""

    def __init__(
        self,
        path: str,
        coordinator: LocalCoordinator,
        plan: _TakePlan,
        pending_io: PendingIOWork,
        storage: Any,
    ) -> None:
        self.path = path
        self._coordinator = coordinator
        self._plan: Optional[_TakePlan] = plan
        self._pending_io: Optional[PendingIOWork] = pending_io
        self._storage = storage
        self._metadata: Optional[SnapshotMetadata] = None
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._complete, name="tsnp-torch-commit", daemon=True
        )
        self._thread.start()

    def _complete(self) -> None:
        try:
            self._pending_io.sync_complete()
            metadata = self._plan.metadata()
            _commit(self._storage, metadata)
            self._metadata = metadata
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            self._exc = e
        finally:
            # the drained work pinned the staged buffers; the handle may
            # outlive the commit
            self._pending_io = self._plan = None
            try:
                self._storage.sync_close()
            except Exception:  # noqa: BLE001 — the outcome is decided
                logger.warning("storage close after async commit failed", exc_info=True)

    def wait(self) -> Snapshot:
        """Block until the background commit finishes; re-raise its error."""
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        snapshot = Snapshot(self.path, self._coordinator)
        snapshot._metadata_cache = self._metadata
        return snapshot

    def done(self) -> bool:
        return not self._thread.is_alive()
