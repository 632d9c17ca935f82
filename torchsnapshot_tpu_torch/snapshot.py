"""The user-facing Snapshot API: take / async_take / restore /
read_object / materialize / verify / metadata / get_manifest.

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
  tiles of at most ``memory_budget_bytes`` when given;
- ``materialize`` reads one rank's whole view without templates, and
  ``verify`` audits the stored objects (``verify.py``).

Incremental takes (``base=``) link each object whose digest equals the
base snapshot's object at the same location instead of writing it
(``scheduler.py``; a hardlink on fs), so each snapshot owns its files
and either can be deleted.  ``leaf_transform`` rewrites leaves before
planning (a lower checkpoint precision, say); ``restore(paths=)``
restores a subset and ``priority=`` orders the reads.

Every take writes the flight record ``.snapshot_obsrecord`` (each
rank's metrics since the take began, merged by rank 0; ``obs/aggregate.py``)
before ``.snapshot_metadata``, best-effort; a restore's merged record
stays in-process on rank 0.  Goodput (time to unblock, durability lag)
is stamped at the take's return and at its commit.

Across ranks, state claimed replicated (``replicated`` globs, the
``Replicated`` marker, DDP-wrapped modules) is verified by fingerprint
(``REPLICATION_VERIFY``) and written once, the writes balanced over the
ranks.  ``DTensor`` leaves are sharded state: each box of the layout is
written once, by a writer every rank elects alike from the per-rank
loads (``preparers/sharded.py``).  Snapshots are interchangeable with
the JAX package's: same manifest, same object layout, same checksums.
Objects stored compressed (the metadata's ``codecs`` frame tables,
``codec.py``) are decoded by the read pipeline, so restore,
``read_object`` (whole or budgeted, raw byte ranges across frames) and
``materialize`` read them as they read raw ones.

Content-addressed takes (``cas=``, ``cas/``) store every object as
content-keyed chunks in a pool shared by a root's steps: rank 0 reads
the pool index's live keys once and broadcasts them, each rank writes
only the chunks the pool lacks, the per-rank chunk tables merge at
commit into the metadata's ``cas`` section (its root recorded relative
under the manager layout), and rank 0 registers the step's refs in the
index strictly before ``.snapshot_metadata``.  Every read path
assembles chunk-referenced objects from the pool.

Tiered storage (``storage_options={"tier": {...}}``, ``tier/``): a
take calls the plugin's ``finalize_take`` after this rank's writes and
before the commit (sync and async), so write-back promotion and peer
replicas only ever trail the data, and under write-back the durable
goodput commit is reported by the promoter; restore, ``read_object`` and
``materialize`` prime the plugin with the committed digests first.

Fleets.  Replicated writers are elected slice → host → rank under an
explicit topology (``partitioner.py``).  A take stamps a heartbeat from
its start (``resilience/liveness.py``) and runs its commit waits in a
``liveness_scope``: a rank that dies mid-commit surfaces within
``LIVENESS_TIMEOUT_S`` as ``RankDeadError``, and the survivors finish the
commit without it by write takeover (``_recover_commit_after_death``):
they agree on the dead set, re-elect writers for its replicated objects
and re-write them from their own copies, and the leader commits, with a
``degraded`` section naming the state only the dead rank held.
``repair_degraded`` heals such a snapshot from a continuous mirror
(``continuous/store.py``).  A restore runs in a liveness scope too (a
dead peer raises ``RankDeadError``; there is no takeover on the read
path) and, over a topology whose slices span ranks, fans out
(``topology/fanout.py``): each replicated object is read once per slice
and handed to the siblings over the payload transport (``transport/``).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import logging
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import knobs, obs
from . import topology as topology_mod
from . import transport as transport_mod
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
from .partitioner import elect_takeover_writers, partition_replicated_writes
from .preparers import estimate_write_bytes, path_is_replicated, prepare_read, prepare_write
from .preparers.sharded import check_coordinator_rank, is_dtensor
from .scheduler import (
    PendingIOWork,
    execute_write_reqs,
    get_process_memory_budget_bytes,
    sync_execute_read_reqs,
)
from .resilience.abort import SnapshotAbortedError
from .resilience.liveness import DegradedSnapshotError, LivenessSession, RankDeadError
from .serialization import serialize_object, string_to_dtype
from .stateful import PyTreeState, Replicated, RNGState, _tree_path_keys, load_with_strict
from .storage import url_to_storage_plugin

logger = logging.getLogger(__name__)

SNAPSHOT_METADATA_FNAME = ".snapshot_metadata"
AppState = Dict[str, Any]


def _storage_for(path: str, options: Optional[Dict[str, Any]]) -> Any:
    """The storage plugin of ``path``, given ``storage_options`` only when
    set: tests and third parties replace ``url_to_storage_plugin`` with
    one-argument factories."""
    if options:
        return url_to_storage_plugin(path, options)
    return url_to_storage_plugin(path)


def _read_priority_for(lpath: str, priority_globs: Sequence[str]) -> int:
    """A logical path's read class under ``priority``: the index of the
    first glob it matches (lower reads earlier), ``len(priority_globs)``
    when none does.  The fnmatch dialect of the ``paths`` filter."""
    for i, g in enumerate(priority_globs):
        if fnmatch.fnmatch(lpath, g):
            return i
    return len(priority_globs)


def _normalize_cas_config(cas: Any, path: str) -> Optional[Dict[str, Any]]:
    """A take's ``cas`` argument as ``{"root", "chunk_size"}``, or None
    (off).  ``True`` places the pool beside the snapshot (``<parent>/cas``,
    the manager layout), a string names the pool root, a dict may also
    give ``chunk_size_bytes``."""
    if not cas:
        return None
    cfg: Dict[str, Any] = {}
    if isinstance(cas, str):
        cfg["root"] = cas
    elif isinstance(cas, dict):
        cfg.update(cas)
    if not cfg.get("root"):
        snap = path.rstrip("/")
        parent = snap.rsplit("/", 1)[0] if "/" in snap else ""
        if not parent:
            raise ValueError(
                f"cas=True needs a parent directory to place the pool next to "
                f"{path!r}; pass an explicit root instead"
            )
        cfg["root"] = f"{parent}/cas"
    chunk_size = int(
        cfg.pop("chunk_size_bytes", None) or cfg.get("chunk_size")
        or knobs.get_cas_chunk_size_bytes()
    )
    return {"root": cfg["root"].rstrip("/"), "chunk_size": chunk_size}


def _cas_commit_refs(metadata: SnapshotMetadata, path: str, store: Any) -> None:
    """Register the take's chunk refs in the pool index, on rank 0,
    strictly before ``.snapshot_metadata``: a failure fails the commit (a
    marker whose chunks GC could sweep would be corrupt from birth)."""
    tables = (metadata.cas or {}).get("chunks") or {}
    if tables:
        from .cas import commit_refs

        commit_refs(store, path, tables)


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
    # location → codec frame table of each object this rank stored
    # encoded (or linked from a base that did), filled by the writes
    object_codecs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # content-addressed takes: the rank-agreed {"root", "chunk_size"}, the
    # pool, and location → chunk table of each object this rank stored
    cas_cfg: Optional[Dict[str, Any]] = None
    cas_store: Any = None
    object_cas: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # what the survivors need to finish the commit after a peer's death
    takeover: Optional["_TakeoverContext"] = None

    def local_payload(self, extra: Optional[Dict[str, Entry]] = None) -> Dict[str, Any]:
        """This rank's commit payload: its manifest (plus ``extra``
        entries it took over), digests, codec and chunk tables."""
        return {
            "manifest": {
                p: e.to_dict() for p, e in {**self.manifest, **self.entries, **(extra or {})}.items()
            },
            "objects": self.object_digests,
            "codecs": self.object_codecs,
            "cas": self.object_cas,
        }

    def cas_envelope(self, chunks: Dict[str, Any]) -> Dict[str, Any]:
        """The metadata's ``cas`` section (empty for a plain take)."""
        if self.cas_cfg is None:
            return {}
        from .cas import record_root

        return {
            "root": record_root(self.path, self.cas_cfg["root"]),
            "chunk_size": self.cas_cfg["chunk_size"],
            "chunks": dict(chunks),
        }

    def close_cas(self) -> None:
        if self.cas_store is not None:
            self.cas_store.sync_close()
            self.cas_store = None


def _metadata_from(
    manifests: List[Dict[str, Entry]], objects: Dict[str, List[int]], world: int,
    codecs: Optional[Dict[str, Any]] = None, cas: Optional[Dict[str, Any]] = None,
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
        objects=objects, codecs=dict(codecs or {}), cas=dict(cas or {}),
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


def _finalize_take(storage: Any, coord: Coordinator, uid: str) -> None:
    """A tiered plugin's ``finalize_take`` (peer replication, write-back
    promotion hand-off); no-op for other plugins."""
    finalize = getattr(storage, "finalize_take", None)
    if finalize is not None:
        finalize(coord, uid)


def _write_obsrecord(coord: Coordinator, uid: str, storage: Any, path: str) -> None:
    """Rank 0 merges the payloads every rank published under ``uid``
    (waiting at most ``aggregate._COLLECT_TIMEOUT_S`` for the missing
    ones) and writes ``.snapshot_obsrecord``, strictly before the commit
    marker.  Best-effort: a failure is counted, never raised."""
    try:
        obs.aggregate.write_obsrecord(
            storage, obs.aggregate.collect_and_merge(coord, uid, op="take", path=path)
        )
    except Exception as e:  # noqa: BLE001 — the record never fails a commit
        obs.swallowed_exception("take.obsrecord", e)


def _commit_protocol(
    coord: Coordinator, uid: str, plan: _TakePlan, storage: Any, status: str,
    obs_before: Dict[str, Any],
) -> Optional[SnapshotMetadata]:
    """Commit a take whose writes on this rank ended with ``status``
    ("ok" or an error).  KV only, under explicit keys of the commit uid,
    so the async commit thread may run it: each rank publishes its
    flight-record payload (the metrics since ``obs_before``), its
    manifest and its status; rank 0 waits for every rank, consolidates,
    writes ``.snapshot_obsrecord`` and then ``.snapshot_metadata`` only
    when all succeeded and the scope is not poisoned, then publishes its
    verdict, which every rank waits for.  Returns the metadata on rank
    0, None elsewhere.  Run inside ``coord.abort_scope(uid)``: a peer's
    poison ends every wait; inside ``coord.liveness_scope``, a peer's
    death raises ``RankDeadError`` (and rank 0 publishes no verdict: the
    survivors finish by write takeover)."""
    rank, world = coord.rank, coord.world_size
    obs.aggregate.publish(coord, uid, obs.aggregate.rank_payload(rank, "take", obs_before))
    if world == 1:
        metadata = _metadata_from(
            [{**plan.manifest, **plan.entries}], plan.object_digests, 1, plan.object_codecs,
            plan.cas_envelope(plan.object_cas),
        )
        _write_obsrecord(coord, uid, storage, plan.path)
        _cas_commit_refs(metadata, plan.path, plan.cas_store)
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
                codecs: Dict[str, Any] = {}
                chunks: Dict[str, Any] = {}
                for p in payloads:
                    objects.update(p["objects"])
                    codecs.update(p.get("codecs") or {})
                    chunks.update(p.get("cas") or {})
                metadata = _metadata_from(
                    [{k: entry_from_dict(v) for k, v in p["manifest"].items()} for p in payloads],
                    objects, world, codecs, plan.cas_envelope(chunks),
                )
                _write_obsrecord(coord, uid, storage, plan.path)
                # never write the commit marker after the scope was poisoned,
                # and register chunk refs strictly before it
                coord.raise_if_poisoned(uid)
                _cas_commit_refs(metadata, plan.path, plan.cas_store)
                _commit(storage, metadata)
                depart = "ok"
        except RankDeadError:
            raise
        except BaseException as e:
            coord.kv_set(f"{uid}/depart", f"rank 0 commit failed: {e!r}")
            raise
        coord.kv_set(f"{uid}/depart", depart)
    depart = coord.kv_get(f"{uid}/depart")
    if depart != "ok":
        raise RuntimeError(f"snapshot commit failed: {depart}")
    return metadata


# ------------------------------------------------------------- takeover
# A rank that dies mid-commit (killed, out of memory, hung) never reaches
# its poison call.  The liveness scope turns its frozen heartbeat into
# RankDeadError at the commit's waits, and the survivors finish the
# commit without it: every rank planned write requests for every
# replicated object and discarded those it was not elected for, so the
# dead writer's objects are re-written from a survivor's copy, and state
# only the dead rank held is named in the metadata's ``degraded``
# section instead of failing the take.

_RECOVERY_POLL_S = 0.1
# recovery's own bound: survivors may be re-writing the dead rank's
# objects while their peers wait on the takeover keys
_RECOVERY_TIMEOUT_S = 600.0


@dataclasses.dataclass
class _TakeoverContext:
    """The planning-time facts a takeover needs.  ``topo``, ``preloads``,
    ``assignment``, ``repl_items`` and ``gathered_manifests`` (every
    rank's manifest after batching) are alike on every rank;
    ``repl_reqs``/``repl_chunk_reqs`` are this rank's un-elected write
    requests, which a takeover writer replays.  ``repl_entries`` are the
    replicated entry objects captured BEFORE non-writers drop theirs and
    before batching re-points the writer's at a rank-local slab: their
    ``replicated/`` locations are rank-independent, so a survivor's
    re-write lands where the manifest says.  Under ``async_take`` the
    replayed requests stage from the live state, which may have moved on
    since the take returned."""

    topo: Any
    preloads: List[int]
    assignment: Dict[str, int]
    repl_reqs: Dict[str, List[WriteReq]]
    repl_chunk_reqs: Dict[str, WriteReq]
    chunk_parent: Dict[str, str]
    repl_items: List[Tuple[str, int]]
    repl_entries: Dict[str, Entry]
    gathered_manifests: List[Dict[str, Any]]


class _CommittedClean(Exception):
    """Rank 0 committed the take complete before this rank's recovery
    began: nothing is left to take over."""


def _recovery_kv_get(
    coord: Coordinator, monitor: Any, key: str, expected_dead: set,
    depart_key: Optional[str] = None, timeout_s: float = _RECOVERY_TIMEOUT_S,
) -> str:
    """A wait of the recovery protocol: the ranks of ``expected_dead``
    stay dead, so only a NEW death raises.  With ``depart_key``, rank 0's
    clean verdict ends the wait (``_CommittedClean``), and a failed one
    raises."""
    deadline = time.monotonic() + timeout_s
    while True:
        value = coord.kv_try_get(key)
        if value is not None:
            return value
        if depart_key is not None:
            depart = coord.kv_try_get(depart_key)
            if depart == "ok":
                raise _CommittedClean()
            if depart is not None:
                raise RuntimeError(f"snapshot commit failed: {depart}")
        newly = [r for r in monitor.dead_ranks() if r not in expected_dead]
        if newly:
            raise RankDeadError(newly[0], set(newly) | set(expected_dead), ns=monitor.ns)
        if time.monotonic() >= deadline:
            raise TimeoutError(f"takeover recovery timed out after {timeout_s}s waiting for {key!r}")
        time.sleep(_RECOVERY_POLL_S)


def _degraded_paths(ctx: _TakeoverContext, dead: Sequence[int], taken_over_lps: set) -> Dict[str, Any]:
    """State only a dead rank held: everything in its manifest but
    containers, primitives and the replicated paths taken over.
    Conservative (payloads it did land before dying are named too;
    ``verify`` and ``repair_degraded`` settle those)."""
    degraded: Dict[str, Dict[str, Any]] = {}
    for d in sorted(dead):
        for lp, ed in ctx.gathered_manifests[d].items():
            entry = entry_from_dict(ed)
            if lp in taken_over_lps or is_container_entry(entry) or isinstance(entry, PrimitiveEntry):
                continue
            degraded.setdefault(lp, {"origin_rank": d, "kind": entry.type})
    return degraded


def _recover_commit_after_death(
    coord: Coordinator, uid: str, plan: _TakePlan, storage: Any, monitor: Any,
    dead_err: RankDeadError,
) -> Optional[SnapshotMetadata]:
    """Finish a take's commit after ``dead_err``.  Runs outside the abort
    and liveness scopes (they would raise on the known dead forever),
    over explicit KV keys only (no uid is minted, so the survivors' op
    counters stay aligned).  (1) The lowest live rank of each survivor's
    view publishes the dead set; a leader that dies meanwhile is folded
    in and the next one elected.  (2) Every survivor elects the writers
    of the orphaned replicated objects alike (``elect_takeover_writers``)
    and (3) replays its share.  (4) Each publishes its commit payload;
    the leader merges them with the dead ranks' planning-time manifests
    (their taken-over paths removed), names the ``degraded`` paths,
    writes ``.snapshot_metadata`` and signals.  Returns the metadata on
    the leader, None elsewhere (also when rank 0 had already committed
    complete)."""
    ctx = plan.takeover
    rank, world = coord.rank, coord.world_size
    my_dead = set(dead_err.dead_ranks or [dead_err.rank])
    logger.warning(
        "rank %d: peer rank(s) %s declared dead during commit %s; entering write takeover",
        rank, sorted(my_dead), uid,
    )
    depart_key = f"{uid}/depart"
    plan_dead: Optional[List[int]] = None
    try:
        for _ in range(world):
            live = [r for r in range(world) if r not in my_dead]
            if not live:
                raise RuntimeError(f"takeover for {uid}: every rank is in the dead set {sorted(my_dead)}")
            candidate = live[0]
            plan_key = f"{uid}/takeover/plan/{candidate}"
            if candidate == rank:
                coord.kv_set(plan_key, json.dumps(sorted(my_dead)))
                plan_dead = sorted(my_dead)
                break
            try:
                plan_dead = json.loads(
                    _recovery_kv_get(coord, monitor, plan_key, my_dead, depart_key)
                )
                break
            except RankDeadError as e:
                my_dead |= set(e.dead_ranks or [e.rank])
    except _CommittedClean:
        logger.warning("rank %d: commit %s completed before the death mattered", rank, uid)
        return None
    if plan_dead is None:
        raise RuntimeError(f"takeover for {uid}: no live leader converged")
    dead = set(plan_dead)
    if rank in dead:
        # declared dead (our stamps stalled): the others moved on
        raise RuntimeError(
            f"rank {rank} was declared dead by the takeover plan for {uid}; aborting locally"
        )
    live = [r for r in range(world) if r not in dead]
    leader = live[0]

    # re-elect the orphaned replicated objects' writers, alike everywhere
    origin_of = {k: ctx.assignment[k] for k, _ in ctx.repl_items if ctx.assignment.get(k) in dead}
    orphans = [(k, n) for k, n in ctx.repl_items if k in origin_of]
    takeover = elect_takeover_writers(
        orphans, sorted(dead), world, preloads=ctx.preloads, topology=ctx.topo, origin_of=origin_of,
    )
    mine = sorted(k for k, w in takeover.items() if w == rank)
    taken_paths = {ctx.chunk_parent.get(k, k) for k in mine}
    if mine:
        reqs: List[WriteReq] = []
        for k in mine:
            reqs.extend(ctx.repl_reqs[k] if k in ctx.repl_reqs else [ctx.repl_chunk_reqs[k]])
        cost_of = dict(ctx.repl_items)
        my_bytes = sum(cost_of.get(k, 0) for k in mine)
        # the sinks went to the elected writer's requests only; taken-over
        # payloads are written plain at their locations, never as chunks
        checksums = knobs.write_checksums_enabled()
        for wr in reqs:
            def codec_sink(table: Dict[str, Any], wr: WriteReq = wr) -> None:
                plan.object_codecs[wr.path] = table

            wr.codec_sink = codec_sink
            if checksums:
                def digest_sink(d: List[int], wr: WriteReq = wr) -> None:
                    wr.object_digest = tuple(d)
                    plan.object_digests[wr.path] = list(d)

                wr.digest_sink = digest_sink
        logger.warning(
            "rank %d: taking over %d replicated write unit(s) (%d bytes) from dead rank(s) %s",
            rank, len(mine), my_bytes, sorted(dead),
        )
        execute_write_reqs(reqs, storage, get_process_memory_budget_bytes(), rank).sync_complete()
        obs.counter(obs.TAKEOVER_OBJECTS).inc(len(mine))
        obs.counter(obs.TAKEOVER_BYTES).inc(my_bytes)

    payload = plan.local_payload({lp: ctx.repl_entries[lp] for lp in taken_paths})
    coord.kv_set(f"{uid}/takeover/manifest/{rank}", coord._encode(payload))
    commit_key = f"{uid}/takeover/commit/{leader}"
    if rank != leader:
        status = _recovery_kv_get(coord, monitor, commit_key, dead)
        if status != "ok":
            raise RuntimeError(f"takeover leader rank {leader} failed to commit {plan.path!r}: {status}")
        logger.warning("rank %d: takeover commit of %r done by rank %d", rank, plan.path, leader)
        return None
    try:
        payloads = {rank: payload}
        for r in live:
            if r != rank:
                key = f"{uid}/takeover/manifest/{r}"
                raw = coord.kv_try_get(key) or _recovery_kv_get(coord, monitor, key, dead)
                payloads[r] = coord._decode(raw)
        taken_over_lps = {ctx.chunk_parent.get(k, k) for k in takeover}
        manifests: List[Dict[str, Entry]] = []
        for r in range(world):
            if r in payloads:
                manifests.append(
                    {k: entry_from_dict(v) for k, v in payloads[r]["manifest"].items()}
                )
            else:
                # the dead rank's keys stay (repair and partial restores
                # need shapes and locations), but not what was taken over
                manifests.append({
                    k: entry_from_dict(v) for k, v in ctx.gathered_manifests[r].items()
                    if k not in taken_over_lps
                })
        objects: Dict[str, List[int]] = {}
        codecs: Dict[str, Any] = {}
        chunks: Dict[str, Any] = {}
        for p in payloads.values():
            objects.update(p["objects"])
            codecs.update(p.get("codecs") or {})
            chunks.update(p.get("cas") or {})
        metadata = _metadata_from(manifests, objects, world, codecs, plan.cas_envelope(chunks))
        degraded = _degraded_paths(ctx, dead, taken_over_lps)
        if degraded:
            metadata.degraded = degraded
        # the clean path's invariants: never after a poison, chunk refs
        # strictly before the marker
        coord.raise_if_poisoned(uid)
        _cas_commit_refs(metadata, plan.path, plan.cas_store)
        if degraded:
            obs.counter(obs.TAKEOVER_DEGRADED_COMMITS).inc()
        _commit(storage, metadata)
        coord.kv_set(commit_key, "ok")
    except BaseException as e:
        try:
            coord.kv_set(commit_key, f"failed: {e!r}")
        except Exception as signal_exc:  # noqa: BLE001 — the peers time out instead
            obs.swallowed_exception("takeover.commit_failure_signal", signal_exc)
        raise
    logger.warning(
        "rank %d: takeover commit of %r done: %s (%d write unit(s) re-written, %d degraded path(s))",
        rank, plan.path, "DEGRADED" if degraded else "complete", len(takeover), len(degraded),
    )
    return metadata


def _commit_or_take_over(
    coord: Coordinator, uid: str, plan: _TakePlan, storage: Any, status: str,
    obs_before: Dict[str, Any], session: LivenessSession,
) -> Optional[SnapshotMetadata]:
    """``_commit_protocol`` in the take's liveness scope; a peer's death
    is finished by write takeover (``TAKEOVER``, world > 1), else it
    poisons the scope and raises."""
    try:
        with coord.liveness_scope(session.monitor):
            return _commit_protocol(coord, uid, plan, storage, status, obs_before)
    except RankDeadError as dead_err:
        if status != "ok" or not knobs.takeover_enabled() or coord.world_size <= 1:
            coord.poison(uid, cause=repr(dead_err), site=f"take/rank{coord.rank}")
            raise
        try:
            return _recover_commit_after_death(coord, uid, plan, storage, session.monitor, dead_err)
        except BaseException as e:
            coord.poison(uid, cause=repr(e), site=f"takeover/rank{coord.rank}")
            raise


class Snapshot:
    def __init__(
        self,
        path: str,
        coordinator: Optional[Coordinator] = None,
        storage_options: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.path = path
        self._coordinator = coordinator or get_default_coordinator()
        self._metadata_cache: Optional[SnapshotMetadata] = None
        # forwarded to the storage plugin's constructor on every access
        self._storage_options = storage_options

    # ------------------------------------------------------------------ take

    @classmethod
    def take(
        cls,
        path: str,
        app_state: AppState,
        replicated: Sequence[str] = (),
        coordinator: Optional[Coordinator] = None,
        base: Optional[str] = None,
        leaf_transform: Optional[Callable[[str, Any], Any]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        cas: Optional[Any] = None,
    ) -> "Snapshot":
        """Save ``app_state`` (name → Stateful) to ``path`` from every rank
        of ``coordinator`` (default: ``get_default_coordinator()``).
        Leaves whose logical path matches a ``replicated`` glob (or that
        replication inference finds) and whose content every rank shares
        are stored once under ``replicated/``, their writes split across
        the ranks.  A rank whose writes fail raises its error and its
        peers raise ``SnapshotAbortedError``; no metadata is written.

        ``base``: a committed snapshot to dedup against.  An object whose
        (crc32, adler32, size) equals the base's object at the same
        location is hardlinked from it instead of written; each snapshot
        owns its files, so deleting the base leaves this one whole.
        Rank 0 reads the base's objects table once and broadcasts it.  It
        needs WRITE_CHECKSUMS on every rank; without them, with a base
        that cannot be read, or with the base equal to ``path``, the take
        is a full save (with a warning).

        ``leaf_transform(logical_path, leaf) -> leaf`` rewrites every
        flattened leaf before planning (a lower checkpoint precision, for
        instance); it must return a leaf for every path, alike on every
        rank.  Under ``async_take`` a transformed CUDA leaf is copied on
        the device like any other: the port cannot tell a fresh tensor
        from a view of live state, and the copy counts in the
        device-copy budget.

        ``storage_options`` go to the storage plugin's constructor
        (``storage.url_to_storage_plugin``).

        ``cas``: store the payload as content-addressed chunks in a pool
        (``True``: ``<parent>/cas``; a root URL; or a dict that may give
        ``root`` and ``chunk_size_bytes``), writing only the chunks no
        committed step holds.  It needs WRITE_CHECKSUMS on every rank
        (without, a plain take with a warning) and supersedes ``base``."""
        coordinator = coordinator or get_default_coordinator()
        _validate_app_state(app_state)
        rank = coordinator.rank
        with log_event(Event("take", {"path": path, "rank": rank})):
            # the flight record's window and the goodput clock start here
            obs_before = obs.aggregate.capture()
            gp_begin = obs.goodput.take_begin(path)
            uid = coordinator._next_uid("commit")
            # the heartbeat stamps from here, so a rank slow in planning or
            # staging is never declared dead; only the commit's waits
            # consult the peers' stamps
            session = LivenessSession(coordinator, uid).start()
            try:
                plan = cls._plan_at_entry(
                    path, app_state, replicated, coordinator, uid, False, base,
                    leaf_transform, storage_options, cas,
                )
            except BaseException:
                session.stop()
                raise
            storage = _storage_for(plan.path, storage_options)
            try:
                with coordinator.abort_scope(uid):
                    execute_write_reqs(
                        plan.write_reqs, storage, get_process_memory_budget_bytes(), rank,
                    ).sync_complete()
                    # tiered storage: peer replication and the write-back
                    # hand-off, strictly after this rank's writes landed
                    # and before the commit (the durable marker can only
                    # trail the data)
                    _finalize_take(storage, coordinator, uid)
                    metadata = _commit_or_take_over(
                        coordinator, uid, plan, storage, "ok", obs_before, session
                    )
            except SnapshotAbortedError:
                raise
            except BaseException as e:
                coordinator.poison(uid, cause=repr(e), site=f"take/rank{rank}")
                raise
            finally:
                session.stop()
                storage.sync_close()
                plan.close_cas()
            # a sync take is durable and unblocks at its return, except
            # under a write-back tier: the promoter reports the durable
            # commit when the durable marker lands
            if getattr(storage, "policy", None) != "write_back":
                obs.goodput.durable_commit(path)
            obs.goodput.take_unblocked(path, gp_begin)
            obs.maybe_write_metrics_textfile()
        snapshot = cls(plan.path, coordinator, storage_options)
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
        base: Optional[str] = None,
        leaf_transform: Optional[Callable[[str, Any], Any]] = None,
        storage_options: Optional[Dict[str, Any]] = None,
        cas: Optional[Any] = None,
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
        only after every write is staged in host memory.  ``base``,
        ``leaf_transform``, ``storage_options`` and ``cas`` are
        ``take``'s."""
        from .host_offload import eager_offload_write_reqs

        coordinator = coordinator or get_default_coordinator()
        _validate_app_state(app_state)
        rank = coordinator.rank
        with log_event(Event("async_take", {"path": path, "rank": rank})):
            obs_before = obs.aggregate.capture()
            gp_begin = obs.goodput.take_begin(path)
            uid = coordinator._next_uid("commit")
            # stamps from planning to the background commit's end
            session = LivenessSession(coordinator, uid).start()
            try:
                plan = cls._plan_at_entry(
                    path, app_state, replicated, coordinator, uid, True, base,
                    leaf_transform, storage_options, cas,
                )
            except BaseException:
                session.stop()
                raise
            unblock_early = not knobs.is_eager_host_staging_disabled()
            storage = _storage_for(plan.path, storage_options)
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
                session.stop()
                storage.sync_close()
                plan.close_cas()
                raise
        pending = PendingSnapshot(
            plan.path, coordinator, plan, pending_io, storage, uid, obs_before,
            storage_options, session,
        )
        # the unblock point is this return: staging, I/O and the commit
        # (with the flight-record exchange) drain in the background
        obs.goodput.take_unblocked(path, gp_begin)
        return pending

    @classmethod
    def _plan_at_entry(
        cls,
        path: str,
        app_state: AppState,
        replicated: Sequence[str],
        coordinator: Coordinator,
        uid: str,
        is_async: bool,
        base: Optional[str],
        leaf_transform: Optional[Callable[[str, Any], Any]],
        storage_options: Optional[Dict[str, Any]],
        cas: Any = None,
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
                    path, app_state, replicated, coordinator, rng_states_at_entry,
                    is_async, base, leaf_transform, storage_options, cas, uid,
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
        base: Optional[str],
        leaf_transform: Optional[Callable[[str, Any], Any]],
        storage_options: Optional[Dict[str, Any]],
        cas: Any = None,
        uid: str = "",
    ) -> _TakePlan:
        rank, world = coordinator.rank, coordinator.world_size
        replicated = _infer_replicated(replicated, app_state)
        local_mode = _safe_replication_verify_mode()
        checksums = knobs.write_checksums_enabled()
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
            # the base, the pool and the checksum setting gate the
            # broadcasts below (the base's table, the pool's live keys), so
            # they are rank-agreed: rank 0's base and pool win, and dedup
            # needs checksums on every rank
            gathered = coordinator.all_gather_object(
                (sorted(set(replicated)), local_mode, base, checksums,
                 _normalize_cas_config(cas, path))
            )
            base, cas_cfg = gathered[0][2], gathered[0][4]
            checksums_all = all(g[3] for g in gathered)
            if base is not None and not checksums_all:
                logger.warning(
                    "rank %d: WRITE_CHECKSUMS is off on some rank; incremental "
                    "dedup is off for this take", rank,
                )
                base = None
            replicated_globs = sorted(
                set(gathered[0][0]).intersection(*(set(g[0]) for g in gathered[1:]))
            )
            if set(replicated) != set(replicated_globs):
                logger.warning(
                    "rank %d: replicated globs differ across ranks; using the "
                    "intersection %r", rank, replicated_globs,
                )
            verify_mode = _strictest_mode([g[1] for g in gathered])
            keys = sorted(set().union(*coordinator.all_gather_object(sorted(app_state))))
        else:
            replicated_globs = sorted(set(replicated))
            verify_mode = local_mode
            keys = sorted(app_state)
            cas_cfg = _normalize_cas_config(cas, path)
            checksums_all = checksums
        if cas_cfg is not None and not checksums_all:
            logger.warning(
                "rank %d: take(cas=...) needs WRITE_CHECKSUMS=1 on every rank; "
                "taking a plain (per-step object) snapshot", rank,
            )
            cas_cfg = None
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
        if leaf_transform is not None:
            # before replication verification: fingerprints and written
            # bytes are the transformed content's
            flattened = {p: leaf_transform(p, v) for p, v in flattened.items()}
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
        # rank → host → slice placement, alike on every rank (an explicit
        # spec, or one exchange of hints under the commit uid): the writer
        # elections below spread replicated writes slice → host → rank
        topo = topology_mod.detect_topology(coordinator, exchange_prefix=f"{uid}/topo")

        entries: Dict[str, Entry] = {}
        write_reqs: List[WriteReq] = []
        repl_items = []
        repl_reqs: Dict[str, List[WriteReq]] = {}
        repl_chunk_reqs: Dict[str, WriteReq] = {}
        chunk_parent: Dict[str, str] = {}
        local_bytes = 0
        chunk_size_bytes = knobs.get_max_chunk_size_bytes()
        t_plan = time.perf_counter()
        with obs.span("take/plan", leaves=len(flattened), rank=rank):
            for lpath in sorted(flattened):
                repl = lpath in verified
                entry, reqs = prepare_write(
                    flattened[lpath], lpath, rank, replicated=repl,
                    chunk_size_bytes=chunk_size_bytes, is_async_snapshot=is_async,
                    world=world, writer_loads=writer_loads, topology=topo,
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
                        repl_chunk_reqs[k] = r
                        chunk_parent[k] = lpath
                        repl_items.append((k, r.buffer_stager.get_staging_cost_bytes()))
                else:
                    repl_reqs[lpath] = reqs
                    repl_items.append((
                        lpath,
                        sum(r.buffer_stager.get_staging_cost_bytes() for r in reqs),
                    ))
        obs.histogram(obs.TAKE_PLAN_S).observe(time.perf_counter() - t_plan)
        # takeover: the replicated entry objects as planned, before
        # non-writers drop theirs and batching re-points the writer's
        repl_entries = {lp: entries[lp] for lp in set(repl_reqs) | set(chunk_parent.values())}
        split_repl_paths = set()
        preloads: List[int] = [0] * world
        assignment: Dict[str, int] = {}
        if repl_items:
            # each rank's per-rank bytes preload the balance
            preloads = list(
                coordinator.all_gather_object(local_bytes) if world > 1 else [local_bytes]
            )
            assignment = partition_replicated_writes(repl_items, world, preloads, topology=topo)
            # per-slice egress: each writer counts the replicated units
            # and bytes it carries (explicit topologies only)
            cost_of = dict(repl_items)
            m_objs = obs.counter(obs.TOPOLOGY_REPLICATED_OBJECTS_WRITTEN)
            m_bytes = obs.counter(obs.TOPOLOGY_REPLICATED_BYTES_WRITTEN)
            for lpath, reqs in repl_reqs.items():
                if assignment[lpath] == rank:
                    write_reqs.extend(reqs)
                    if topo.explicit:
                        m_objs.inc()
                        m_bytes.inc(cost_of[lpath])
                else:
                    # only the writer keeps the entry: batching may point
                    # its copy at a slab, and the manifest must carry the
                    # written one
                    del entries[lpath]
            writes_chunk_of: Dict[str, bool] = {}
            for k, r in repl_chunk_reqs.items():
                lpath = chunk_parent[k]
                mine = assignment[k] == rank
                if mine:
                    write_reqs.append(r)
                    if topo.explicit:
                        # bytes per chunk, the object once per rank
                        m_bytes.inc(cost_of[k])
                        if not writes_chunk_of.get(lpath):
                            m_objs.inc()
                writes_chunk_of[lpath] = writes_chunk_of.get(lpath, False) or mine
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
        object_codecs: Dict[str, Any] = {}
        for wr in write_reqs:
            # every write gets a sink: an encoded write or a link of an
            # encoded base object reports its frame table here
            def codec_sink(table: Dict[str, Any], wr: WriteReq = wr) -> None:
                object_codecs[wr.path] = table

            wr.codec_sink = codec_sink
        if cas_cfg is not None and base is not None:
            # chunk addressing dedups against every committed step of the
            # pool; a whole-object base link is weaker, and one take does
            # not mix the two storage models
            logger.warning(
                "rank %d: take(cas=...) supersedes base=%r; using chunk-level "
                "content addressing", rank, base,
            )
            base = None
        if base is not None and base.rstrip("/") == path.rstrip("/"):
            # a self-link would unlink the only copy before linking it
            logger.warning(
                "rank %d: incremental base equals the target path %r; "
                "performing a full save", rank, path,
            )
            base = None
        if checksums:
            base_objects, base_codecs = (
                _base_tables(base, storage_options, coordinator) if base is not None else ({}, {})
            )
            for wr in write_reqs:
                def sink(d: List[int], wr: WriteReq = wr) -> None:
                    wr.object_digest = tuple(d)
                    object_digests[wr.path] = list(d)

                wr.digest_sink = sink
                # (crc32, adler32, size): two checksums and the exact length
                base_digest = base_objects.get(wr.path)
                if isinstance(base_digest, (list, tuple)) and len(base_digest) == 3:
                    wr.dedup = (base, tuple(int(x) for x in base_digest))
                    wr.dedup_codec = base_codecs.get(wr.path)
        elif base is not None:
            logger.warning(
                "rank %d: take(base=...) needs WRITE_CHECKSUMS=1; performing "
                "a full save", rank,
            )
        plan = _TakePlan(
            path, manifest, entries, write_reqs, object_digests, world, object_codecs, cas_cfg
        )
        # every rank's manifest after batching: a survivor names what a
        # dead rank held (and keeps its shapes and locations) from these
        gathered: List[Dict[str, Any]] = []
        if world > 1:
            gathered = coordinator.all_gather_object(
                {p: e.to_dict() for p, e in {**manifest, **entries}.items()}
            )
        plan.takeover = _TakeoverContext(
            topo=topo, preloads=preloads, assignment=assignment, repl_reqs=repl_reqs,
            repl_chunk_reqs=repl_chunk_reqs, chunk_parent=chunk_parent, repl_items=repl_items,
            repl_entries=repl_entries, gathered_manifests=gathered,
        )
        if cas_cfg is not None:
            _attach_cas(plan, coordinator)
        return plan

    # --------------------------------------------------------------- restore

    @property
    def metadata(self) -> SnapshotMetadata:
        if self._metadata_cache is None:
            storage = _storage_for(self.path, self._storage_options)
            try:
                read_io = ReadIO(path=SNAPSHOT_METADATA_FNAME)
                storage.sync_read(read_io)
            except FileNotFoundError as e:
                # missing (a cold start, or never committed) stays
                # distinguishable from unreadable
                raise FileNotFoundError(
                    f"no {SNAPSHOT_METADATA_FNAME} under {self.path!r} — "
                    f"not a committed snapshot (a snapshot without "
                    f"metadata was aborted before commit)"
                ) from e
            finally:
                storage.sync_close()
            self._metadata_cache = SnapshotMetadata.from_yaml(
                bytes(read_io.buf).decode()
            )
        return self._metadata_cache

    def get_manifest(self) -> Dict[str, Entry]:
        return dict(self.metadata.manifest)

    def _prime_tier_digests(self, storage: Any) -> None:
        """Tiered storage: install the committed metadata's whole-object
        digest table on the plugin, so fast and peer copies are checked
        before they are trusted (and fall back and repair on a mismatch).
        An encoded object is checked against its STORED digest from the
        codec table (the bytes on disk are frames); one whose table has
        none stays unprimed.  No-op for other plugins."""
        prime = getattr(storage, "prime_digests", None)
        if prime is None:
            return
        digests = dict(self.metadata.objects or {})
        for loc, tbl in (self.metadata.codecs or {}).items():
            stored = tbl.get("digest") if isinstance(tbl, dict) else None
            if isinstance(stored, (list, tuple)) and len(stored) == 3:
                digests[loc] = [int(x) for x in stored]
            else:
                digests.pop(loc, None)
        prime(digests)

    def _codec_tables(self) -> Optional[Dict[str, Any]]:
        """location → frame table of each object stored compressed; None
        when nothing is.  A structurally invalid table (version skew) is
        dropped with a warning: the read then sees frames where raw bytes
        were expected and fails at the parse or digest, never silently."""
        from .codec import validate_table

        tables = {}
        for loc, tbl in (self.metadata.codecs or {}).items():
            if validate_table(tbl):
                tables[loc] = tbl
            else:
                logger.warning(
                    "manifest codec table for %r is structurally invalid (version "
                    "skew?); treating the object as raw", loc,
                )
        return tables or None

    def _cas_reads(self) -> Optional[Tuple[Any, Dict[str, Any]]]:
        """``(ChunkStore, {location → chunk table})`` of the objects stored
        as chunk references, None when there are none (the caller closes
        the store)."""
        from . import cas as cas_mod

        meta_cas = self.metadata.cas or {}
        tables = cas_mod.chunk_tables_from_metadata(self.metadata) if meta_cas else {}
        if not tables:
            return None
        root = cas_mod.resolve_root(self.path, str(meta_cas.get("root")))
        return cas_mod.ChunkStore(root), tables

    def restore(
        self,
        app_state: AppState,
        strict: bool = True,
        paths: Optional[Sequence[str]] = None,
        priority: Optional[Sequence[str]] = None,
        device: Any = "cuda",
    ) -> None:
        """Load the snapshot into ``app_state`` as the coordinator's rank
        sees it, at any world size: that rank's own entries (none for a
        rank the take did not have) and every replicated one.  Tensors in
        the current state are restore templates and are updated IN PLACE
        (cast to their dtype, on their device); a tensor leaf with no
        tensor template comes back on ``device``.

        ``paths``: fnmatch globs of the logical paths to restore (for
        instance ``["model/**"]`` to warm-start the parameters while the
        optimizer keeps its fresh state).  Other leaves keep their
        current values and are not read; ``strict`` still governs
        app_state keys the snapshot lacks.

        ``priority``: ordered fnmatch globs; reads of paths matching an
        earlier glob are admitted first (unmatched paths last), so a
        server can restore its first layers first.  Ordering only: every
        leaf is restored.

        Over a topology whose slices span several ranks (``TOPOLOGY``,
        ``FANOUT``), each replicated object is read once per slice and
        handed to the slice's other ranks over the payload transport,
        whose payload parts live on ``device``; every rank must then call
        ``restore`` with the same ``paths`` and ``priority``.  A peer that
        dies mid-restore makes the others raise ``RankDeadError`` within
        ``LIVENESS_TIMEOUT_S``."""
        _validate_app_state(app_state)
        coordinator = self._coordinator
        rank, world = coordinator.rank, coordinator.world_size
        with log_event(Event("restore", {"path": self.path, "rank": rank})):
            obs_before = obs.aggregate.capture()
            # one collective operation under the restore's own scope, the
            # metadata read included: a rank that fails anywhere poisons
            # it, and its peers' waits raise SnapshotAbortedError; a peer
            # that dies is named by RankDeadError (no takeover on reads)
            uid = coordinator._next_uid("restore")
            storage = cas_reads = None
            session = LivenessSession(coordinator, uid)
            try:
                session.start()
                with coordinator.abort_scope(uid), coordinator.liveness_scope(session.monitor):
                    metadata = self.metadata
                    manifest_for_rank = get_manifest_for_rank(metadata, rank)
                    storage = _storage_for(self.path, self._storage_options)
                    self._prime_tier_digests(storage)
                    cas_reads = self._cas_reads()
                    # fan-out: the wrapper goes outside any host cache, so
                    # the slice's one read is itself host-deduplicated
                    topo = (
                        topology_mod.detect_topology(coordinator, exchange_prefix=f"{uid}/topo")
                        if world > 1 else None
                    )
                    if topo is not None and topology_mod.fanout_enabled(topo):
                        shared = topology_mod.shared_read_locations(metadata.manifest)
                        if shared:
                            storage = topology_mod.FanoutReadPlugin(
                                storage, coordinator, topo, f"{uid}/fan", shared,
                                transport=transport_mod.resolve_transport(
                                    coordinator, topology=topo, device=device
                                ),
                            )
                    # (key, is RNG state) of this rank's app_state; over
                    # ranks, the union of the keys (a rank-local stateful
                    # is restored where it lives), a key RNG state when
                    # any rank holds it so: every rank loops the same
                    # keys in the same order, barrier by barrier
                    local = [(k, isinstance(app_state[k], RNGState)) for k in sorted(app_state)]
                    if world > 1:
                        flags: Dict[str, bool] = {}
                        for g in coordinator.all_gather_object(local):
                            for k, is_rng in g:
                                flags[k] = flags.get(k, False) or is_rng
                    else:
                        flags = dict(local)
                    # RNG state last, so no other restore can perturb it
                    keys = sorted(flags, key=lambda k: (flags[k], k))
                    self._open_fanout_session(storage, topo, uid, keys, paths)
                    for key in keys:
                        if key in app_state:
                            self._load_stateful(
                                key, app_state[key], manifest_for_rank, storage,
                                strict, rank, device, paths, priority, cas_reads,
                            )
                        if world > 1:
                            # one load_state_dict at a time across ranks,
                            # in case one runs collectives
                            coordinator.barrier()
                    # every rank is past its reads: the fan-out's
                    # publications (blobs, gate keys, registry entries)
                    # are reclaimed
                    if isinstance(storage, topology_mod.FanoutReadPlugin):
                        if storage.transport_session is not None:
                            storage.transport_session.close()
                        storage.cleanup_published()
                    # the restore's flight record is merged in-process
                    # (the snapshot may be read-only): rank 0 keeps it as
                    # obs.aggregate.last_record("restore").  Every rank
                    # just left the last barrier, so the peers publish
                    # within rank 0's bounded wait.
                    obs.aggregate.exchange_and_merge(
                        coordinator, uid,
                        obs.aggregate.rank_payload(rank, "restore", obs_before),
                        op="restore", path=self.path,
                    )
            except SnapshotAbortedError:
                raise
            except BaseException as e:
                coordinator.poison(uid, cause=repr(e), site=f"restore/rank{rank}")
                raise
            finally:
                session.stop()
                if storage is not None:
                    if isinstance(storage, topology_mod.FanoutReadPlugin):
                        # idempotent after the clean path's close: the
                        # session thread must not outlive the restore
                        for closer in (storage.transport_session, storage.transport):
                            if closer is not None:
                                try:
                                    closer.close()
                                except Exception as e:  # noqa: BLE001
                                    obs.swallowed_exception("restore.transport_close", e)
                    storage.sync_close()
                if cas_reads is not None:
                    cas_reads[0].sync_close()
            obs.maybe_write_metrics_textfile()

    def _open_fanout_session(
        self, storage: Any, topo: Any, uid: str, keys: List[str],
        paths: Optional[Sequence[str]],
    ) -> None:
        """Attach a collective fan-out session to the restore's fan-out
        wrapper, when the transport has a process group over the world,
        every rank fans out (``fanout_world_uniform``) and the restore is
        whole (a ``paths`` filter makes which objects are read a per-rank
        question).  Its schedule follows the restore's key order.  A
        session that cannot open leaves the restore on the KV path,
        counted in ``transport.fallbacks``."""
        if not (
            isinstance(storage, topology_mod.FanoutReadPlugin)
            and getattr(storage.transport, "mode", None) == "session"
            and paths is None
            and topology_mod.fanout_world_uniform(topo)
        ):
            return
        try:
            plan_paths = topology_mod.ordered_shared_locations(
                self.metadata.manifest, storage.shared_paths, keys
            )
            storage.transport_session = storage.transport.open_fanout_session(
                topo, f"{uid}/fan", plan_paths
            )
        except Exception as e:  # noqa: BLE001 — the restore goes on over KV
            transport_mod.count_fallback("session-open", e)

    def _load_stateful(
        self, key: str, stateful: Any, manifest_for_rank: Manifest,
        storage: Any, strict: bool, rank: int, device: Any,
        paths: Optional[Sequence[str]] = None,
        priority: Optional[Sequence[str]] = None,
        cas_reads: Optional[Tuple[Any, Dict[str, Any]]] = None,
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
            if paths is not None and not any(
                not is_container_entry(e) and path_is_replicated(p, paths)
                for p, e in key_manifest.items()
            ):
                return  # nothing under this key matches the filter
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
                and (paths is None or path_is_replicated(p, paths))
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
                if paths is not None and not path_is_replicated(lpath, paths):
                    # not read; its current value keeps its slot, so a
                    # list or tuple keeps its length and order
                    if lpath in targets:
                        futures[lpath] = Future(targets[lpath])
                    continue
                reqs, fut = prepare_read(entry, obj_out=targets.get(lpath))
                if priority:
                    pri = _read_priority_for(lpath, priority)
                    for r in reqs:
                        r.priority = pri
                read_reqs.extend(reqs)
                futures[lpath] = fut
            if not knobs.is_batching_disabled():
                read_reqs = batch_read_requests(read_reqs)
            sync_execute_read_reqs(
                read_reqs, storage, get_process_memory_budget_bytes(), rank,
                codec_tables=self._codec_tables(), cas_reads=cas_reads,
                # fan-out: this rank's reads for its siblings go first
                publish_first=getattr(storage, "local_publish_paths", None),
            )
            state_dict = inflate(
                container_entries,
                {
                    lpath: _place(fut.obj, targets.get(lpath), device)
                    for lpath, fut in futures.items()
                },
                prefix=key,
                allow_missing=not strict or paths is not None,
            )
            load_with_strict(stateful, state_dict, strict and paths is None)

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
            storage = _storage_for(self.path, self._storage_options)
            self._prime_tier_digests(storage)
            cas_reads = self._cas_reads()
            try:
                sync_execute_read_reqs(
                    reqs, storage,
                    memory_budget_bytes or get_process_memory_budget_bytes(), rank=0,
                    codec_tables=self._codec_tables(), cas_reads=cas_reads,
                )
            finally:
                storage.sync_close()
                if cas_reads is not None:
                    cas_reads[0].sync_close()
            return _place(fut.obj, obj_out, device)

    # ----------------------------------------------------- inspection

    def materialize(
        self,
        rank: Optional[int] = None,
        priority: Optional[Sequence[str]] = None,
        device: Any = "cuda",
    ) -> Dict[str, Any]:
        """Read one rank's whole view (default: this process's rank) into
        a nested state dict, with no templates and no app_state: one
        entry per app_state key.  Tensors come back on ``device``
        (``"cpu"`` for host tensors).  Under ``MMAP`` (the default) on a
        local filesystem a CPU leaf stored raw is a tensor over a private
        mapping of its file, as the JAX package returns mmap-backed
        views: no host copy is made, and writing the tensor changes a
        private copy of the page, never the file.  ``priority`` orders
        the reads as ``restore``'s does.  A
        ``PyTreeState``'s list and tuple nodes come back as index-keyed
        dicts (its structure lives in the tree, not the manifest)."""
        if rank is None:
            rank = self._coordinator.rank
        world = self.metadata.world_size
        if not 0 <= rank < world:
            # a grown-world view would hold only the replicated leaves
            raise ValueError(f"rank {rank} out of range for world_size={world}")
        with log_event(Event("materialize", {"path": self.path, "rank": rank})):
            manifest = get_manifest_for_rank(self.metadata, rank)
            containers = {p: e for p, e in manifest.items() if is_container_entry(e)}
            futures: Dict[str, Future] = {}
            read_reqs: List[ReadReq] = []
            for p, e in manifest.items():
                if is_container_entry(e):
                    continue
                reqs, fut = prepare_read(e)
                if priority:
                    pri = _read_priority_for(p, priority)
                    for r in reqs:
                        r.priority = pri
                read_reqs.extend(reqs)
                futures[p] = fut
            if not knobs.is_batching_disabled():
                read_reqs = batch_read_requests(read_reqs)
            storage = _storage_for(self.path, self._storage_options)
            self._prime_tier_digests(storage)
            cas_reads = self._cas_reads()
            try:
                sync_execute_read_reqs(
                    read_reqs, storage, get_process_memory_budget_bytes(), rank,
                    codec_tables=self._codec_tables(), cas_reads=cas_reads,
                )
            finally:
                storage.sync_close()
                if cas_reads is not None:
                    cas_reads[0].sync_close()
            leaves = {p: _place(fut.obj, None, device) for p, fut in futures.items()}
            return {
                key: inflate(containers, leaves, prefix=key)
                for key in sorted({p.split("/", 1)[0] for p in manifest})
            }

    def publish_to(self, publisher: Any, step: int) -> str:
        """Publish this committed snapshot to a live-weight publication
        root (``publish.Publisher``) so serving subscribers can swap to
        it; returns the record path.  ``step`` orders the publication.
        The explicit path: it raises on failure, where the manager's and
        the continuous loop's hooks are best-effort."""
        return publisher.publish_snapshot(self.path, step, metadata=self.metadata)

    def repair_degraded(
        self, sources: Sequence[str], paths: Optional[Sequence[str]] = None
    ) -> List[str]:
        """Heal a degraded snapshot IN PLACE from continuous mirrors.  A
        take committed degraded lost the state only its dead rank held;
        the dead rank's continuous mirror (``<host root>/r<rank>``,
        ``continuous/store.py``) still has it.  The lost leaves are read
        from the first usable mirror (content-verified), written at fresh
        manifest locations of the dead rank's namespace, dropped from
        ``degraded``, and ``.snapshot_metadata`` is rewritten strictly
        last.  One process, no coordination.

        ``sources``: continuous host roots (their ``r<d>`` is probed) or
        store roots ending in ``/r<d>``; ``paths`` restricts the logical
        paths.  Returns the paths repaired.  Sharded state cannot be
        rebuilt from a host mirror (its mesh is gone): such paths are
        skipped with a warning, and only a fresh take heals them."""
        with log_event(Event("repair_degraded", {"path": self.path})), obs.span(
            "snapshot/repair_degraded", path=self.path
        ):
            return self._repair_degraded_impl(sources, paths)

    def _read_peer_leaves(
        self, sources: Sequence[str], origin: int, lpaths: Sequence[str]
    ) -> Dict[str, Any]:
        """The wanted leaves (host tensors, or objects) from the first
        usable mirror of rank ``origin``.  Only roots of that rank are
        probed: a same-shaped leaf of another rank would be the wrong
        rank's data."""
        from .continuous.store import ContinuousStore

        wanted = set(lpaths)
        for src in sources:
            src = str(src).rstrip("/")
            root = src if src.endswith(f"/r{origin}") else f"{src}/r{origin}"
            store = ContinuousStore(root)
            try:
                head = store.read_head()
                if head is None:
                    continue
                manifest = store.read_step_manifest(str(head["manifest"]))
                out = store.read_leaves(manifest, sorted(wanted), device="cpu")
                if not out:
                    continue
                logger.info(
                    "repair: recovered %d/%d leaves of dead rank %d from %r (step %d)",
                    len(out), len(wanted), origin, root, int(head["step"]),
                )
                return out
            except Exception as e:  # noqa: BLE001 — the next source
                logger.warning(
                    "repair source %r unusable for rank %d (%r); trying the next one",
                    root, origin, e,
                )
            finally:
                store.sync_close()
        return {}

    def _repair_degraded_impl(
        self, sources: Sequence[str], paths: Optional[Sequence[str]]
    ) -> List[str]:
        metadata = self.metadata
        degraded = dict(metadata.degraded or {})
        if not degraded:
            return []
        if isinstance(sources, str):
            sources = [sources]
        by_origin: Dict[int, List[str]] = {}
        for p, info in degraded.items():
            if paths is None or p in set(paths):
                by_origin.setdefault(int(info.get("origin_rank", -1)), []).append(p)
        checksums = knobs.write_checksums_enabled()
        storage = _storage_for(self.path, self._storage_options)
        repaired: List[str] = []
        try:
            for d, lpaths in sorted(by_origin.items()):
                leaves = self._read_peer_leaves(sources, d, lpaths)
                reqs: List[WriteReq] = []
                staged: List[Tuple[str, Entry]] = []
                for lp in sorted(set(lpaths) & set(leaves)):
                    if isinstance(metadata.manifest.get(f"{d}/{lp}"), ShardedArrayEntry):
                        logger.warning(
                            "repair: %r is sharded state; a host mirror cannot rebuild its "
                            "mesh layout, only a fresh take heals it", lp,
                        )
                        continue
                    entry, ereqs = prepare_write(leaves[lp], lp, d)
                    if checksums:
                        # plain writes (no codec sink): a repaired object reads
                        # raw, so its stale codec table goes below
                        for wr in ereqs:
                            def sink(digest: List[int], wr: WriteReq = wr) -> None:
                                wr.object_digest = tuple(digest)
                                metadata.objects[wr.path] = list(digest)

                            wr.digest_sink = sink
                    reqs.extend(ereqs)
                    staged.append((lp, entry))
                if not staged:
                    continue
                execute_write_reqs(
                    reqs, storage, get_process_memory_budget_bytes(), self._coordinator.rank
                ).sync_complete()
                new_locs = {r.path for r in reqs}
                for lp, entry in staged:
                    old = metadata.manifest.get(f"{d}/{lp}")
                    if old is not None:
                        # the dead rank's never-landed locations leave the
                        # objects and codecs tables with its entry
                        old_locs = [getattr(old, "location", None)] + [
                            s.location
                            for attr in ("shards", "chunks")
                            for s in getattr(old, attr, None) or ()
                        ]
                        for loc in old_locs:
                            if isinstance(loc, str):
                                metadata.codecs.pop(loc, None)
                                if checksums and loc not in new_locs:
                                    metadata.objects.pop(loc, None)
                    metadata.manifest[f"{d}/{lp}"] = entry
                    metadata.degraded.pop(lp, None)
                    repaired.append(lp)
            if repaired:
                # the marker strictly last: a crash mid-repair leaves the
                # snapshot committed and still degraded
                _commit(storage, metadata)
                obs.counter(obs.TAKEOVER_PATHS_REPAIRED).inc(len(repaired))
                logger.warning(
                    "repair: healed %d degraded path(s) of %r; %d still degraded",
                    len(repaired), self.path, len(metadata.degraded),
                )
        finally:
            storage.sync_close()
        return sorted(repaired)

    def verify(self, deep: bool = False) -> Any:
        """Audit this rank's view (``verify.py``): every object the
        manifest references exists with the size it claims; ``deep``
        also re-reads every checksummed payload against its crc32 and
        reads every other entry.  Returns a ``VerifyResult``."""
        from .verify import verify_snapshot

        return verify_snapshot(self, deep=deep)


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


def _attach_cas(plan: _TakePlan, coordinator: Coordinator) -> None:
    """Route every write of a content-addressed take through the pool:
    rank 0 loads the index's live keys once (rebuilding a corrupt index
    with ``fsck`` first) and broadcasts them; one written-this-take set is
    shared, so repeats within the take are written once."""
    from . import cas as cas_mod

    root = plan.cas_cfg["root"]
    plan.cas_store = cas_mod.ChunkStore(root)
    known: set = set()
    if coordinator.rank == 0:
        try:
            known = cas_mod.ChunkIndex.load(plan.cas_store).live_keys()
        except cas_mod.ChunkIndexCorruptError as e:
            logger.warning(
                "corrupt chunk index under %r (%r); rebuilding via fsck before "
                "this take", root, e,
            )
            try:
                cas_mod.fsck(root)
                known = cas_mod.ChunkIndex.load(plan.cas_store).live_keys()
            except Exception as e2:  # noqa: BLE001 — dedup only, never correctness
                logger.warning(
                    "chunk-index fsck under %r failed (%r); this take writes "
                    "every chunk", root, e2,
                )
    if coordinator.world_size > 1:
        known = coordinator.broadcast_object(known, src=0)
    written: set = set()
    for wr in plan.write_reqs:
        def sink(table: Dict[str, Any], wr: WriteReq = wr) -> None:
            plan.object_cas[wr.path] = table

        wr.cas = cas_mod.CasWriteContext(
            store=plan.cas_store, known_keys=known,
            chunk_size=plan.cas_cfg["chunk_size"], sink=sink, written_this_take=written,
        )


def _base_tables(
    base: str, storage_options: Optional[Dict[str, Any]], coordinator: Coordinator
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The base snapshot's objects table and codec tables, read once by
    rank 0 and broadcast (every rank reading a large metadata object at
    the start of each take is a thundering herd).  A base that cannot be
    read gives empty tables: the take is a full save.  A tier option
    names this take's fast root, not the base's: the base is read from
    its own (durable) url, as in the JAX package."""
    tables: Tuple[Dict[str, Any], Dict[str, Any]] = ({}, {})
    if coordinator.rank == 0:
        opts = {k: v for k, v in (storage_options or {}).items() if k != "tier"}
        try:
            meta = Snapshot(base, storage_options=opts or None).metadata
            tables = (meta.objects or {}, meta.codecs or {})
        except Exception as e:  # noqa: BLE001 — any unusable base: full save
            logger.warning(
                "rank 0: incremental base %r unusable (%r); performing a full save",
                base, e,
            )
    if coordinator.world_size > 1:
        tables = coordinator.broadcast_object(tables, src=0)
    return tables


class PendingSnapshot:
    """Handle for an in-flight ``async_take``.  A background thread drains
    the writes, then runs the KV-only commit protocol under the take's
    commit uid: every rank reports done or its error, and rank 0 writes
    ``.snapshot_metadata`` only if every rank succeeded.  A rank whose
    writes fail poisons the scope first, so its peers' waits end within
    a poll interval.  The commit runs in the take's liveness scope, and a
    peer's death is finished by write takeover as in ``take`` (the
    replayed writes stage from the live state, which may have moved on
    since ``async_take`` returned).  Two takes in flight at once each own
    their threads and storage."""

    def __init__(
        self,
        path: str,
        coordinator: Coordinator,
        plan: _TakePlan,
        pending_io: PendingIOWork,
        storage: Any,
        uid: str,
        obs_before: Dict[str, Any],
        storage_options: Optional[Dict[str, Any]] = None,
        session: Optional[LivenessSession] = None,
    ) -> None:
        self.path = path
        # the heartbeat started at async_take's entry; stopped at the end
        # of the background commit
        self._session = session or LivenessSession(coordinator, uid)
        self._storage_options = storage_options
        # metrics at async_take's entry: the commit thread deltas against
        # them after the drain, so the record covers the background work
        self._obs_before = obs_before
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
            # tiered storage: replication and the write-back hand-off
            # (KV-only, explicit keys: legal on this thread)
            _finalize_take(self._storage, coord, uid)
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            self._exc = e
            status = f"err:{e!r}"
            coord.poison(uid, cause=repr(e), site=f"async_commit/rank{coord.rank}")
        try:
            if status == "ok" or coord.world_size > 1:
                with coord.abort_scope(uid):
                    self._metadata = _commit_or_take_over(
                        coord, uid, self._plan, self._storage, status, self._obs_before,
                        self._session,
                    )
                if status == "ok" and getattr(self._storage, "policy", None) != "write_back":
                    # the commit marker landed (on rank 0; every rank
                    # read rank 0's "ok" verdict); a write-back tier's
                    # promoter reports its durable marker instead
                    obs.goodput.durable_commit(self.path)
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            if self._exc is None:
                self._exc = e
        finally:
            self._session.stop()
            obs.maybe_write_metrics_textfile()
            self._plan.close_cas()
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
        snapshot = Snapshot(self.path, self._coordinator, self._storage_options)
        # rank 0 holds the consolidated metadata; others load the committed one
        snapshot._metadata_cache = self._metadata
        return snapshot

    def done(self) -> bool:
        return not self._thread.is_alive()
