"""The user-facing Snapshot API: take / async_take / restore /
read_object / metadata.

Counterpart of ``torchsnapshot_tpu/snapshot.py``.  The orchestration is
the JAX package's:

- ``take`` flattens every stateful's ``state_dict`` into logical paths,
  plans one write per leaf, splits replicated writes across ranks,
  coalesces small writes into slabs, stages and writes them under a
  host-memory budget, and commits: every rank reports done under the
  take's commit uid and rank 0 writes ``.snapshot_metadata`` last, only
  when every rank succeeded (a snapshot without it is incomplete).  A
  rank that fails poisons the commit scope, so its peers raise a typed
  ``SnapshotAbortedError`` within a poll interval;
- ``async_take`` plans the same writes, makes each independent of the
  live state (``host_offload.py``: device-side copies of CUDA tensors,
  host copies of host ones) and returns a ``PendingSnapshot``; staging,
  I/O and the commit protocol run on a background thread, an error
  surfaces from ``wait()``, and ``.snapshot_metadata`` is never written
  on failure;
- ``restore`` reads each leaf INTO the current state's tensors (restore
  templates, updated in place), RNG state last, at any world size:
  replicated entries serve every rank, and a sharded entry's merged box
  set serves any template layout (resharding).  Across ranks it is one
  collective operation: a rank that fails poisons the restore's scope
  and every peer raises ``SnapshotAbortedError``;
- ``read_object`` reads one leaf by ``"<rank>/<logical path>"``, in
  tiles of at most ``memory_budget_bytes`` when given.

Across ranks, state claimed replicated (``replicated`` globs, the
``Replicated`` marker, DDP-wrapped modules) is verified by fingerprint
(``REPLICATION_VERIFY``) and written once, the writes balanced over the
ranks.  ``DTensor`` leaves are sharded state: each box of the layout is
written once, by a writer every rank elects alike from the per-rank
loads (``preparers/sharded.py``).  Snapshots are interchangeable with
the JAX package's: same manifest, same object layout, same checksums.
Not ported: incremental and content-addressed takes, codecs, tiered
storage, topology and transport, liveness, write takeover and repair;
a read of an object stored compressed or as chunk references raises
``EncodedPayloadError`` before any byte reaches a template.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
import threading
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import knobs, obs
from .batcher import batch_read_requests, batch_write_requests
from .coordination import Coordinator, get_default_coordinator
from .event import Event
from .event_handlers import log_event
from .flatten import flatten, inflate
from .io_types import Future, ReadIO, ReadReq, WriteIO, WriteReq
from .manifest import (
    MANIFEST_VERSION,
    ArrayEntry,
    ChunkedArrayEntry,
    Entry,
    Manifest,
    PrimitiveEntry,
    ShardedArrayEntry,
    SnapshotMetadata,
    entry_from_dict,
    is_container_entry,
)
from .manifest_ops import consolidate_manifests, get_manifest_for_rank
from .partitioner import partition_replicated_writes
from .preparers import estimate_write_bytes, path_is_replicated, prepare_read, prepare_write
from .preparers.sharded import check_coordinator_rank, is_dtensor
from .scheduler import (
    PendingIOWork,
    execute_write_reqs,
    get_process_memory_budget_bytes,
    sync_execute_read_reqs,
)
from .resilience.abort import SnapshotAbortedError
from .serialization import serialize_object, string_to_dtype
from .stateful import PyTreeState, Replicated, RNGState, _tree_path_keys, load_with_strict
from .storage import url_to_storage_plugin

logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"
AppState = Dict[str, Any]


class EncodedPayloadError(RuntimeError):
    """A read of an object the snapshot stores encoded: compressed (a
    codec frame table in the metadata's ``codecs``) or as content
    addressed chunk references (a chunk table in its ``cas``).  The port
    does not decode either yet; raised before any byte is read."""

    def __init__(self, location: str, table: str) -> None:
        self.location = location
        self.table = table
        super().__init__(
            f"object {location!r} is stored encoded (the snapshot's metadata has "
            f"a {table} for it), which this package cannot decode yet; restore "
            "it with the JAX package"
        )


class DegradedSnapshotError(RuntimeError):
    """A restore would read logical paths the snapshot's ``degraded``
    section declares lost with a rank that died during the take."""

    def __init__(self, path: str, degraded_paths: Sequence[str]) -> None:
        self.path = path
        self.degraded_paths = sorted(degraded_paths)
        super().__init__(
            f"snapshot {path!r} is degraded: {len(self.degraded_paths)} logical "
            f"path(s) were lost with a dead rank and not healed: "
            f"{self.degraded_paths[:5]}"
        )


def _entry_locations(entry: Entry) -> List[str]:
    if isinstance(entry, ShardedArrayEntry):
        return [s.location for s in entry.shards]
    if isinstance(entry, ChunkedArrayEntry):
        return [c.location for c in entry.chunks]
    location = getattr(entry, "location", None)
    return [location] if location else []


def _refuse_encoded(metadata: SnapshotMetadata, locations: Iterable[str]) -> None:
    codecs = metadata.codecs or {}
    chunks = (metadata.cas or {}).get("chunks") or {}
    for location in locations:
        if location in codecs:
            raise EncodedPayloadError(location, "codec frame table")
        if location in chunks:
            raise EncodedPayloadError(location, "CAS chunk table")


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


def _host_crc32(obj: Any) -> int:
    """crc32 of a host array's bytes in C order, copied at most 16 MiB of
    rows at a time when it is not contiguous."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.is_contiguous() or t.dim() == 0:
            return zlib.crc32(t.reshape(-1).view(torch.uint8).numpy())
        rows = max(1, (16 << 20) // max(1, t[:1].numel() * t.element_size()))
        crc = 0
        for i in range(0, t.shape[0], rows):
            crc = zlib.crc32(t[i:i + rows].contiguous().reshape(-1).view(torch.uint8).numpy(), crc)
        return crc
    if obj.flags["C_CONTIGUOUS"] or obj.ndim == 0:
        return zlib.crc32(np.ascontiguousarray(obj).reshape(-1).view(np.uint8))
    crc = 0
    rows = max(1, (16 << 20) // max(1, obj[:1].nbytes))
    for i in range(0, obj.shape[0], rows):
        crc = zlib.crc32(np.ascontiguousarray(obj[i:i + rows]).reshape(-1).view(np.uint8), crc)
    return crc


def _replication_fingerprint(obj: Any, mode: str = "full") -> Tuple:
    """Per-leaf fingerprint that verifies state claimed replicated matches
    across ranks (the JAX package's, with CUDA tensors in the place of
    jax arrays).

    - host arrays (numpy, CPU tensors): dtype, shape and the crc32 of the
      whole buffer in C order (so memory layout does not matter); dtype
      and shape only under ``mode == "shape"``;
    - CUDA tensors: dtype and shape only — content would need a device
      sync on the take's path;
    - primitives: small values verbatim, floats by bit pattern (NaN must
      compare equal to itself), long str/bytes by length and crc32;
    - anything else: the crc32 of its serialized form.
    ``mode == "off"`` is handled by the caller (no fingerprints)."""
    if isinstance(obj, float):
        return ("prim_f", struct.pack("<d", obj))
    if isinstance(obj, (str, bytes)):
        raw = obj.encode("utf-8", "surrogatepass") if isinstance(obj, str) else obj
        if len(raw) > 4096:
            return ("prim_big", type(obj).__name__, len(raw), zlib.crc32(raw))
        return ("prim", type(obj).__name__, obj)
    if isinstance(obj, (int, bool, type(None))):
        # the concrete type in the tag: True == 1, but a bool/int
        # divergence across ranks must still demote
        return ("prim", type(obj).__name__, obj)
    if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
        return ("dev", str(obj.dtype), tuple(obj.shape))
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        if mode == "shape":
            return ("arr", str(obj.dtype), tuple(obj.shape))
        return ("arr", str(obj.dtype), tuple(obj.shape), _host_crc32(obj))
    try:
        payload, _ = serialize_object(obj)
        return ("obj", type(obj).__name__, len(payload), zlib.crc32(payload))
    except Exception:  # noqa: BLE001 — an unencodable object: by type
        return ("obj", type(obj).__name__)


def _safe_replication_verify_mode() -> str:
    """The knob, without raising: an invalid value on one rank must not
    break the ranks' common protocol — the strict default instead."""
    try:
        return knobs.get_replication_verify()
    except ValueError as e:
        logger.warning("%s; falling back to 'full'", e)
        return "full"


def _strictest_mode(modes: Sequence[str]) -> str:
    return "full" if "full" in modes else ("shape" if "shape" in modes else "off")


def _verify_replicated_paths(
    flattened: Dict[str, Any],
    replicated_globs: Sequence[str],
    coordinator: Coordinator,
    mode: str,
) -> set:
    """The logical paths that are verifiably replicated: matched by the
    agreed globs on every rank, with equal fingerprints.  The others are
    demoted to per-rank entries with a warning: a 'replicated' save of
    one rank's copy is worse than a larger correct one.  Under "off" the
    paths' presence is still intersected (the partitioner needs the same
    item list on every rank)."""
    if not replicated_globs:
        return set()
    # a DTensor is sharded state, never replicated
    local = {
        lpath: None if mode == "off" else _replication_fingerprint(obj, mode)
        for lpath, obj in flattened.items()
        if path_is_replicated(lpath, replicated_globs) and not is_dtensor(obj)
    }
    if coordinator.world_size <= 1:
        return set(local)
    gathered = coordinator.all_gather_object(local)
    missing = object()
    verified = {
        lpath for lpath, fp in gathered[0].items()
        if all(peer.get(lpath, missing) == fp for peer in gathered[1:])
    }
    demoted = set(local) - verified
    if demoted:
        logger.warning(
            "rank %d: %d path(s) matched replicated globs but differ across "
            "ranks; saving per-rank instead: %s",
            coordinator.rank, len(demoted), sorted(demoted)[:10],
        )
    return verified


def _ddp_module(stateful: Any) -> Optional[Any]:
    """The DistributedDataParallel instance behind ``stateful`` (itself,
    or the ``.module`` of an adapter), if there is one."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    for cand in (stateful, getattr(stateful, "module", None)):
        if isinstance(cand, DDP):
            return cand
    return None


def _infer_replicated(replicated: Sequence[str], app_state: Dict[str, Any]) -> List[str]:
    """Replication globs inferred from the app state, added to the
    caller's: a stateful marked ``Replicated`` (or whose class says
    ``replicated = True``) and a DDP-wrapped module contribute
    ``key/**``; a DDP module with ``parameters_to_ignore`` contributes
    one glob per name it does replicate.  Each rank infers on its own;
    the glob intersection across ranks and the fingerprints guard the
    rest."""
    globs = list(replicated)
    if "**" in globs:
        return globs
    for key, val in app_state.items():
        if isinstance(val, Replicated) or getattr(type(val), "replicated", None) is True:
            globs.append(f"{key}/**")
            continue
        ddp = _ddp_module(val)
        if ddp is None:
            continue
        ignored = set(getattr(ddp, "parameters_to_ignore", ()) or ())
        if not ignored:
            globs.append(f"{key}/**")
            continue
        for name in val.state_dict().keys():
            bare = name[7:] if name.startswith("module.") else name
            if bare not in ignored and name not in ignored:
                globs.append(f"{key}/{name}")
    return globs


@dataclasses.dataclass
class _TakePlan:
    """A take's planned writes and the records they fill in: checksum
    sinks stamp the entries while staging runs, so each rank's manifest
    is published after its writes."""

    path: str
    manifest: Manifest
    entries: Dict[str, Entry]
    write_reqs: List[WriteReq]
    object_digests: Dict[str, List[int]]
    world: int

    def local_payload(self) -> Dict[str, Any]:
        return {
            "manifest": {p: e.to_dict() for p, e in {**self.manifest, **self.entries}.items()},
            "objects": self.object_digests,
        }


def _metadata_from(
    manifests: List[Dict[str, Entry]], objects: Dict[str, List[int]], world: int
) -> SnapshotMetadata:
    """The consolidated metadata of every rank's manifest.  A replicated
    chunked entry whose chunks were split across ranks carries on each
    rank only the crc32s of the chunks that rank wrote: the kept copy
    gets them all."""
    chunk_crcs = {}
    for m in manifests:
        for e in m.values():
            for c in getattr(e, "chunks", None) or ():
                if c.crc32 is not None:
                    chunk_crcs[(c.location, tuple(c.byte_range or ()))] = c.crc32
    consolidated = consolidate_manifests(manifests)
    for e in consolidated.values():
        for c in getattr(e, "chunks", None) or ():
            if c.crc32 is None:
                c.crc32 = chunk_crcs.get((c.location, tuple(c.byte_range or ())))
    return SnapshotMetadata(
        version=MANIFEST_VERSION, world_size=world, manifest=consolidated,
        objects=objects,
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


def _commit_protocol(
    coord: Coordinator, uid: str, plan: _TakePlan, storage: Any, status: str
) -> Optional[SnapshotMetadata]:
    """Commit a take whose writes on this rank ended with ``status``
    ("ok" or an error).  KV only, under explicit keys of the commit uid,
    so the async commit thread may run it: each rank publishes its
    manifest and its status; rank 0 waits for every rank, consolidates
    and writes ``.snapshot_metadata`` only when all succeeded and the
    scope is not poisoned, then publishes its verdict, which every rank
    waits for.  Returns the metadata on rank 0, None elsewhere.  Run
    inside ``coord.abort_scope(uid)``: a peer's poison ends every wait."""
    rank, world = coord.rank, coord.world_size
    if world == 1:
        metadata = _metadata_from(
            [{**plan.manifest, **plan.entries}], plan.object_digests, 1
        )
        _commit(storage, metadata)
        return metadata
    coord.kv_set(
        f"{uid}/manifest/{rank}",
        coord._encode(plan.local_payload()) if status == "ok" else "",
    )
    coord.kv_set(f"{uid}/arrive/{rank}", status)
    metadata = None
    if rank == 0:
        # the verdict is published even when the commit itself raises,
        # so peers never wait out the timeout
        try:
            statuses = [coord.kv_get(f"{uid}/arrive/{r}") for r in range(world)]
            failed = [f"rank {r}: {st}" for r, st in enumerate(statuses) if st != "ok"]
            if failed:
                depart = f"peers failed: {failed}"
            else:
                payloads = [
                    coord._decode(coord.kv_get(f"{uid}/manifest/{r}")) for r in range(world)
                ]
                objects: Dict[str, List[int]] = {}
                for p in payloads:
                    objects.update(p["objects"])
                metadata = _metadata_from(
                    [{k: entry_from_dict(v) for k, v in p["manifest"].items()} for p in payloads],
                    objects, world,
                )
                # never write the commit marker after the scope was poisoned
                coord.raise_if_poisoned(uid)
                _commit(storage, metadata)
                depart = "ok"
        except BaseException as e:
            coord.kv_set(f"{uid}/depart", f"rank 0 commit failed: {e!r}")
            raise
        coord.kv_set(f"{uid}/depart", depart)
    depart = coord.kv_get(f"{uid}/depart")
    if depart != "ok":
        raise RuntimeError(f"snapshot commit failed: {depart}")
    return metadata


class Snapshot:
    def __init__(self, path: str, coordinator: Optional[Coordinator] = None) -> None:
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
        coordinator: Optional[Coordinator] = None,
    ) -> "Snapshot":
        """Save ``app_state`` (name → Stateful) to ``path`` from every rank
        of ``coordinator`` (default: ``get_default_coordinator()``).
        Leaves whose logical path matches a ``replicated`` glob (or that
        replication inference finds) and whose content every rank shares
        are stored once under ``replicated/``, their writes split across
        the ranks.  A rank whose writes fail raises its error and its
        peers raise ``SnapshotAbortedError``; no metadata is written."""
        coordinator = coordinator or get_default_coordinator()
        _validate_app_state(app_state)
        rank = coordinator.rank
        with log_event(Event("take", {"path": path, "rank": rank})):
            uid = coordinator._next_uid("commit")
            plan = cls._plan_at_entry(path, app_state, replicated, coordinator, uid, is_async=False)
            storage = url_to_storage_plugin(plan.path)
            try:
                with coordinator.abort_scope(uid):
                    execute_write_reqs(
                        plan.write_reqs, storage, get_process_memory_budget_bytes(), rank,
                    ).sync_complete()
                    metadata = _commit_protocol(coordinator, uid, plan, storage, "ok")
            except SnapshotAbortedError:
                raise
            except BaseException as e:
                coordinator.poison(uid, cause=repr(e), site=f"take/rank{rank}")
                raise
            finally:
                storage.sync_close()
        snapshot = cls(plan.path, coordinator)
        # other ranks load the committed metadata when they need it
        snapshot._metadata_cache = metadata
        return snapshot

    @classmethod
    def async_take(
        cls,
        path: str,
        app_state: AppState,
        replicated: Sequence[str] = (),
        coordinator: Optional[Coordinator] = None,
    ) -> "PendingSnapshot":
        """Save ``app_state`` to ``path`` in the background.  Returns once
        the snapshot's content is independent of the live state: CUDA
        tensors are copied on the device (on the caller's current stream,
        with no host wait) and host tensors on the host
        (``host_offload.py``), so the caller may run its next step, which
        changes the state in place, right away.  Staging, storage I/O
        and the commit protocol run on a background thread; ``wait()``
        returns the committed ``Snapshot`` or raises the error (a peer's
        failure as ``SnapshotAbortedError``), in which case
        ``.snapshot_metadata`` was never written.  With the knob
        TORCHSNAPSHOT_TPU_TORCH_DISABLE_EAGER_HOST_STAGING=1 it returns
        only after every write is staged in host memory."""
        from .host_offload import eager_offload_write_reqs

        coordinator = coordinator or get_default_coordinator()
        _validate_app_state(app_state)
        rank = coordinator.rank
        with log_event(Event("async_take", {"path": path, "rank": rank})):
            uid = coordinator._next_uid("commit")
            plan = cls._plan_at_entry(path, app_state, replicated, coordinator, uid, is_async=True)
            unblock_early = not knobs.is_eager_host_staging_disabled()
            storage = url_to_storage_plugin(plan.path)
            try:
                if unblock_early:
                    eager_offload_write_reqs(plan.write_reqs)
                pending_io = execute_write_reqs(
                    plan.write_reqs, storage, get_process_memory_budget_bytes(),
                    rank, wait_for_staging=not unblock_early,
                )
            except BaseException as e:
                # peers are past planning, waiting for this rank's commit
                coordinator.poison(uid, cause=repr(e), site=f"async_take/rank{rank}")
                storage.sync_close()
                raise
        return PendingSnapshot(plan.path, coordinator, plan, pending_io, storage, uid)

    @classmethod
    def _plan_at_entry(
        cls,
        path: str,
        app_state: AppState,
        replicated: Sequence[str],
        coordinator: Coordinator,
        uid: str,
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
        # the commit uid is the abort scope from the first gather on, so
        # a rank failing in planning releases peers waiting in a gather
        try:
            with coordinator.abort_scope(uid):
                return cls._plan(
                    path, app_state, replicated, coordinator, rng_states_at_entry, is_async
                )
        except SnapshotAbortedError:
            raise
        except BaseException as e:
            coordinator.poison(uid, cause=repr(e), site=f"take_plan/rank{coordinator.rank}")
            raise
        finally:
            for k, v in app_state.items():
                if isinstance(v, RNGState):
                    v.load_state_dict(rng_states_at_entry[k])
            RNGState().load_state_dict(rng_at_entry)

    @classmethod
    def _plan(
        cls,
        path: str,
        app_state: AppState,
        replicated: Sequence[str],
        coordinator: Coordinator,
        rng_states_at_entry: Dict[str, Dict[str, Any]],
        is_async: bool,
    ) -> _TakePlan:
        rank, world = coordinator.rank, coordinator.world_size
        replicated = _infer_replicated(replicated, app_state)
        local_mode = _safe_replication_verify_mode()
        if world > 1:
            # rank 0's path wins; the replication globs are intersected
            # and the strictest verification mode wins, so every rank
            # branches alike below
            path0 = coordinator.broadcast_object(path, src=0)
            if path0 != path:
                logger.warning(
                    "rank %d: snapshot path %r differs from rank 0's %r; using "
                    "rank 0's", rank, path, path0,
                )
                path = path0
            gathered = coordinator.all_gather_object((sorted(set(replicated)), local_mode))
            replicated_globs = sorted(
                set(gathered[0][0]).intersection(*(set(g) for g, _ in gathered[1:]))
            )
            if set(replicated) != set(replicated_globs):
                logger.warning(
                    "rank %d: replicated globs differ across ranks; using the "
                    "intersection %r", rank, replicated_globs,
                )
            verify_mode = _strictest_mode([m for _, m in gathered])
            keys = sorted(set().union(*coordinator.all_gather_object(sorted(app_state))))
        else:
            replicated_globs = sorted(set(replicated))
            verify_mode = local_mode
            keys = sorted(app_state)
        manifest: Manifest = {}
        flattened: Dict[str, Any] = {}
        for key in keys:
            if key in app_state:
                state = rng_states_at_entry.get(key)
                if state is None:
                    state = app_state[key].state_dict()
                m, f = flatten(state, prefix=key)
                manifest.update(m)
                flattened.update(f)
            if world > 1:
                # one state_dict() at a time across ranks, in case one
                # runs collectives
                coordinator.barrier()
        verified = _verify_replicated_paths(flattened, replicated_globs, coordinator, verify_mode)
        # every rank's non-sharded write bytes pre-load the sharded-box
        # balance; the gathered vector is the same on every rank and is
        # mutated by each sharded leaf's assignment, in sorted path order
        host_est = sum(
            estimate_write_bytes(obj)
            for lp, obj in flattened.items()
            if lp not in verified and not is_dtensor(obj)
        )
        writer_loads = list(coordinator.all_gather_object(host_est)) if world > 1 else [host_est]

        entries: Dict[str, Entry] = {}
        write_reqs: List[WriteReq] = []
        repl_items = []
        repl_reqs: Dict[str, List[WriteReq]] = {}
        repl_chunks: Dict[str, Tuple[str, WriteReq]] = {}
        local_bytes = 0
        chunk_size_bytes = knobs.get_max_chunk_size_bytes()
        with obs.span("take/plan", leaves=len(flattened), rank=rank):
            for lpath in sorted(flattened):
                repl = lpath in verified
                entry, reqs = prepare_write(
                    flattened[lpath], lpath, rank, replicated=repl,
                    chunk_size_bytes=chunk_size_bytes, is_async_snapshot=is_async,
                    world=world, writer_loads=writer_loads,
                )
                entries[lpath] = entry
                if not repl:
                    write_reqs.extend(reqs)
                    local_bytes += sum(r.buffer_stager.get_staging_cost_bytes() for r in reqs)
                elif isinstance(entry, ChunkedArrayEntry) and len(reqs) > 1:
                    # chunk-granular writers, so a big replicated array's
                    # writes spread over the ranks too
                    for ci, r in enumerate(reqs):
                        k = f"{lpath}\x00{ci}"  # \x00 cannot occur in a path
                        repl_chunks[k] = (lpath, r)
                        repl_items.append((k, r.buffer_stager.get_staging_cost_bytes()))
                else:
                    repl_reqs[lpath] = reqs
                    repl_items.append((
                        lpath,
                        sum(r.buffer_stager.get_staging_cost_bytes() for r in reqs),
                    ))
        split_repl_paths = set()
        if repl_items:
            # each rank's per-rank bytes preload the balance
            preloads = coordinator.all_gather_object(local_bytes) if world > 1 else [local_bytes]
            assignment = partition_replicated_writes(repl_items, world, preloads)
            for lpath, reqs in repl_reqs.items():
                if assignment[lpath] == rank:
                    write_reqs.extend(reqs)
                else:
                    # only the writer keeps the entry: batching may point
                    # its copy at a slab, and the manifest must carry the
                    # written one
                    del entries[lpath]
            writes_chunk_of: Dict[str, bool] = {}
            for k, (lpath, r) in repl_chunks.items():
                mine = assignment[k] == rank
                writes_chunk_of[lpath] = writes_chunk_of.get(lpath, False) or mine
                if mine:
                    write_reqs.append(r)
            for lpath, any_mine in writes_chunk_of.items():
                if any_mine:
                    # chunk locations are rank-independent: every writer's
                    # copy of the entry is the same (restore dedups)
                    split_repl_paths.add(lpath)
                else:
                    del entries[lpath]

        if not knobs.is_batching_disabled():
            # a slab would re-point a shared chunked entry at a rank-local
            # location: such entries stay out
            shielded = {lp: entries.pop(lp) for lp in split_repl_paths}
            entries, write_reqs = batch_write_requests(entries, write_reqs, rank)
            entries.update(shielded)

        object_digests: Dict[str, List[int]] = {}
        if knobs.write_checksums_enabled():
            for wr in write_reqs:
                wr.digest_sink = (
                    lambda d, p=wr.path: object_digests.__setitem__(p, list(d))
                )
        return _TakePlan(path, manifest, entries, write_reqs, object_digests, world)

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
        """Load the snapshot into ``app_state`` as the coordinator's rank
        sees it, at any world size: that rank's own entries (none for a
        rank the take did not have) and every replicated one.  Tensors in
        the current state are restore templates and are updated IN PLACE
        (cast to their dtype, on their device); a tensor leaf with no
        tensor template comes back on ``device``."""
        _validate_app_state(app_state)
        coordinator = self._coordinator
        rank, world = coordinator.rank, coordinator.world_size
        with log_event(Event("restore", {"path": self.path, "rank": rank})):
            # one collective operation under the restore's own scope, the
            # metadata read included: a rank that fails anywhere poisons
            # it, and its peers' waits raise SnapshotAbortedError
            uid = coordinator._next_uid("restore")
            storage = None
            try:
                with coordinator.abort_scope(uid):
                    manifest_for_rank = get_manifest_for_rank(self.metadata, rank)
                    storage = url_to_storage_plugin(self.path)
                    keys = sorted(app_state)
                    if world > 1:
                        gathered = coordinator.all_gather_object(keys)
                        if any(g != keys for g in gathered):
                            raise ValueError(
                                f"restore: the ranks' app_state keys differ: {gathered}"
                            )
                    # every object the keys would read, refused before
                    # any key restores if one is stored encoded
                    _refuse_encoded(self.metadata, (
                        location
                        for p, e in manifest_for_rank.items()
                        if any(p == k or p.startswith(k + "/") for k in keys)
                        for location in _entry_locations(e)
                    ))
                    # RNG state last, so no other restore can perturb it
                    keys.sort(key=lambda k: isinstance(app_state[k], RNGState))
                    for key in keys:
                        self._load_stateful(
                            key, app_state[key], manifest_for_rank, storage,
                            strict, rank, device,
                        )
                        if world > 1:
                            # one load_state_dict at a time across ranks,
                            # in case one runs collectives
                            coordinator.barrier()
            except SnapshotAbortedError:
                raise
            except BaseException as e:
                coordinator.poison(uid, cause=repr(e), site=f"restore/rank{rank}")
                raise
            finally:
                if storage is not None:
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
            # a degraded path blocks this restore only when this rank's
            # view would read the dead rank's bytes: this rank is its
            # origin, or the entry is sharded (the merged boxes include
            # the lost ones), or replicated (every view overlays the dead
            # writer's copy); a peer's intact private copy restores
            degraded = self.metadata.degraded or {}
            hits = [
                p for p, e in key_manifest.items()
                if p in degraded
                and not is_container_entry(e)
                and (
                    rank == degraded[p].get("origin_rank")
                    or isinstance(e, ShardedArrayEntry)
                    or bool(getattr(e, "replicated", False))
                )
            ]
            if hits:
                raise DegradedSnapshotError(self.path, hits)
            # the current state provides the in-place templates
            _, targets = flatten(stateful.state_dict(), prefix=key)
            _map_legacy_leaf_targets(key, stateful, key_manifest, targets)
            for lpath, t in targets.items():
                if is_dtensor(t):
                    check_coordinator_rank(rank, self._coordinator.world_size, t, lpath)
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
        self,
        path: str,
        obj_out: Optional[Any] = None,
        memory_budget_bytes: Optional[int] = None,
        device: Any = "cuda",
    ) -> Any:
        """One object by ``"<rank>/<logical_path>"``; a tensor or numpy
        ``obj_out`` is filled in place and returned, else a new tensor on
        ``device`` (or the decoded object) comes back.

        With ``memory_budget_bytes``, an array (or chunk) larger than the
        budget is read in tiles of at most that many bytes, each written
        into its place as it lands, and the budget also caps the reads in
        flight: host memory stays O(budget).  A sharded entry is read in
        row tiles of its stored boxes under the same cap; where every
        stored box spans the whole array but along dim 0 (boxes split by
        rows), the tiles land in place as a dense array's do, else they
        are scattered into one host buffer of the whole result (pinned,
        for the card), as the JAX package assembles it, and that buffer
        is not bounded by the budget.  A CUDA template takes the
        tiles in place (a cast tile through kernel K6); with no template
        and a CUDA ``device`` the tiles land in a fresh tensor on the
        card.  If the read fails (a storage error, or a crc32 mismatch
        under VERIFY_ON_RESTORE) it raises; the template's contents are
        then unspecified, but it stays usable and can be passed to a
        retry."""
        with log_event(Event("read_object", {"path": path})):
            rank_str, _, lpath = path.partition("/")
            manifest = get_manifest_for_rank(self.metadata, int(rank_str))
            if lpath not in manifest:
                raise KeyError(f"{lpath!r} not in snapshot manifest")
            entry = manifest[lpath]
            if isinstance(entry, PrimitiveEntry):
                return entry.get_value()
            if (
                memory_budget_bytes is not None
                and obj_out is None
                and isinstance(entry, (ArrayEntry, ChunkedArrayEntry, ShardedArrayEntry))
                and torch.device(device).type != "cpu"
            ):
                # onto the card, never through a whole host copy of a dense
                # array or of row-split boxes (their tiles land in place)
                obj_out = torch.empty(
                    tuple(entry.shape), dtype=string_to_dtype(entry.dtype), device=device
                )
            reqs, fut = prepare_read(
                entry, obj_out=obj_out, buffer_size_limit_bytes=memory_budget_bytes
            )
            _refuse_encoded(self.metadata, [r.path for r in reqs])
            storage = url_to_storage_plugin(self.path)
            try:
                sync_execute_read_reqs(
                    reqs, storage,
                    memory_budget_bytes or get_process_memory_budget_bytes(), rank=0,
                )
            finally:
                storage.sync_close()
            return _place(fut.obj, obj_out, device)


def _map_legacy_leaf_targets(
    key: str, stateful: Any, key_manifest: Manifest, targets: Dict[str, Any]
) -> None:
    """A snapshot written before ``PyTreeState`` rendered named paths
    stores its leaves as ``<key>/leaves/<i>``: map the current tree's
    leaves onto them positionally (both orders are the tree's flattening
    order), so they stay the restore's in-place templates."""
    import re

    if isinstance(stateful, Replicated):
        stateful = stateful.stateful
    if not isinstance(stateful, PyTreeState):
        return
    pat = re.compile(re.escape(key) + r"/leaves/(\d+)")
    legacy = {
        int(m.group(1)): p
        for p, e in key_manifest.items()
        if (m := pat.fullmatch(p)) and not is_container_entry(e)
    }
    if not legacy or any(p in targets for p in legacy.values()):
        return
    for i, (_, leaf) in enumerate(_tree_path_keys(stateful.tree)):
        if i in legacy:
            targets[legacy[i]] = leaf


class PendingSnapshot:
    """Handle for an in-flight ``async_take``.  A background thread drains
    the writes, then runs the KV-only commit protocol under the take's
    commit uid: every rank reports done or its error, and rank 0 writes
    ``.snapshot_metadata`` only if every rank succeeded.  A rank whose
    writes fail poisons the scope first, so its peers' waits end within
    a poll interval.  Two takes in flight at once each own their threads
    and storage."""

    def __init__(
        self,
        path: str,
        coordinator: Coordinator,
        plan: _TakePlan,
        pending_io: PendingIOWork,
        storage: Any,
        uid: str,
    ) -> None:
        self.path = path
        self._coordinator = coordinator
        self._plan: Optional[_TakePlan] = plan
        self._pending_io: Optional[PendingIOWork] = pending_io
        self._storage = storage
        self._uid = uid
        self._metadata: Optional[SnapshotMetadata] = None
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._complete, name="tsnp-torch-commit", daemon=True
        )
        self._thread.start()

    def _complete(self) -> None:
        coord, uid = self._coordinator, self._uid
        status = "ok"
        try:
            self._pending_io.sync_complete()
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            self._exc = e
            status = f"err:{e!r}"
            coord.poison(uid, cause=repr(e), site=f"async_commit/rank{coord.rank}")
        try:
            if status == "ok" or coord.world_size > 1:
                with coord.abort_scope(uid):
                    self._metadata = _commit_protocol(
                        coord, uid, self._plan, self._storage, status
                    )
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            if self._exc is None:
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
        # rank 0 holds the consolidated metadata; others load the committed one
        snapshot._metadata_cache = self._metadata
        return snapshot

    def done(self) -> bool:
        return not self._thread.is_alive()
