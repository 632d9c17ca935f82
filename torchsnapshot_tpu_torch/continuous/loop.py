"""The always-on per-step checkpoint loop.

Counterpart of ``torchsnapshot_tpu/continuous/loop.py``, with its
semantics and its store format.  ``ContinuousCheckpointer.step(app_state,
step)`` is called after every optimizer step.  The blocked window is what
makes the step's bytes independent of the training state: flatten, copy
each tensor to the host (``encode_leaf``: one copy per leaf, frozen ones
too, since a chunk is skipped only by its digest), digest its chunks on
the staging threads, and copy out the chunks no target holds yet.  The
rest runs on one replication thread: those chunks go to this host's store
and to each peer host's store (chunks, then the step manifest, then HEAD,
per target, the targets concurrently under one share of the staging
budget, ``scheduler.sync_execute_buffer_writes``), then the heartbeat,
retention and, every Nth step, the durable promotion.

Loss model: a host killed at any instant loses at most the step whose
replication was in flight (a peer's HEAD names its last complete step,
and ``step()`` joins the previous replication before it starts the
next).  Peers are chosen by topology (``replica_candidate_order``:
another slice first); promotion goes through the write-back promoter
(``tier/promoter.py``) with a pinned HEAD; a SIGTERM notice
(``resilience/preemption.py``) drains the in-flight replication inside
the grace window.  With the collective transport, each chunk bound for a
peer takes the engine's device round trip (``Transport.device_move``).

Differences from the reference, on purpose:
- every wait has a deadline: joining the in-flight job (in ``step``,
  ``promote`` and ``drain()`` without a deadline) raises a
  ``TimeoutError`` naming the step after ``DRAIN_DEADLINE_S``;
- only peer stores take the transport's device round trip, as the
  reference's comment says (its test compares the host root with a store
  root, so its local store takes it too);
- ``publisher=`` (live-weight publication) is refused: ROADMAP queue A
  item 5.4 ports it.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .. import knobs, obs
from ..cas.store import chunk_location
from ..coordination import Coordinator, get_default_coordinator
from ..flatten import flatten
from ..obs import goodput
from ..resilience import preemption
from ..storage.stripe import plan_parts
from ..tier.promoter import PromotionGroup, get_promoter
from ..utils.checksums import digest
from . import heartbeat
from .store import (
    ContinuousStore,
    chunk_key,
    encode_head,
    encode_leaf,
    encode_step_manifest,
    step_manifest_path,
)

logger = logging.getLogger(__name__)

# the bound of every wait for a replication job (the promoter's own)
DRAIN_DEADLINE_S = 600.0
# the bound of close()'s join of the replication thread
_WORKER_JOIN_S = 30.0

# the most recently built live checkpointer, for the flight record's
# continuous stamp (obs/aggregate.py reads summary_block())
_ACTIVE: Optional["weakref.ref[ContinuousCheckpointer]"] = None


def summary_block() -> Optional[Dict[str, Any]]:
    """The active checkpointer's ``summary()`` (None without a live loop
    in this process); never raises."""
    cc = _ACTIVE() if _ACTIVE is not None else None
    if cc is None:
        return None
    try:
        return cc.summary()
    except Exception as e:  # noqa: BLE001 — telemetry must not raise
        obs.swallowed_exception("continuous.summary_block", e)
        return None


class _StepJob:
    __slots__ = (
        "step", "t_begin", "target_items", "all_keys",
        "manifest_payload", "head_payload", "done", "promote",
    )

    def __init__(
        self,
        step: int,
        t_begin: float,
        target_items: Dict[str, List[Tuple[str, bytes]]],
        all_keys: Set[str],
        manifest_payload: bytes,
        head_payload: bytes,
        promote: bool,
    ) -> None:
        self.step = step
        self.t_begin = t_begin
        self.target_items = target_items
        self.all_keys = all_keys
        self.manifest_payload = manifest_payload
        self.head_payload = head_payload
        self.done = threading.Event()
        self.promote = promote


class ContinuousCheckpointer:
    """Always-on per-step peer checkpointing (see the module docstring).

    ``local_root``: this HOST's fast store root (a tmpfs path, a local
    disk or ``memory://``); rank r's state lives under ``{root}/r{r}``.
    ``durable_root``: the durable mirror's root; None disables promotion
    and the durable fallback.  ``peer_roots``: every rank's
    ``local_root`` by rank (None: exchanged over the coordination KV at
    the first step).  ``replica_roots``: explicit host roots to mirror
    to, instead of choosing peers.  ``replica_count``: peers per step
    (another slice first).  ``promote_every_n``: None = the
    CONTINUOUS_PROMOTE_EVERY_N knob.  ``retain_steps``: complete steps
    each store keeps (the HEAD step always survives).  ``device``: where
    the transport's device round trip runs and where ``restore_latest``
    puts tensors by default (the tests pass ``"cpu"``).
    """

    def __init__(
        self,
        local_root: str,
        durable_root: Optional[str] = None,
        coordinator: Optional[Coordinator] = None,
        replica_count: int = 1,
        peer_roots: Optional[Sequence[str]] = None,
        replica_roots: Optional[Sequence[str]] = None,
        promote_every_n: Optional[int] = None,
        chunk_size_bytes: Optional[int] = None,
        retain_steps: int = 2,
        topology: Any = None,
        preemption_hook: bool = True,
        publisher: Any = None,
        device: Any = "cuda",
    ) -> None:
        if publisher is not None:
            raise NotImplementedError(
                "ContinuousCheckpointer(publisher=) (live-weight publication) is not "
                "ported yet (ROADMAP queue A item 5.4)"
            )
        self.local_root = local_root.rstrip("/")
        self.durable_root = durable_root.rstrip("/") if durable_root else None
        self._coordinator = coordinator
        self.replica_count = int(replica_count)
        self._peer_roots = [r.rstrip("/") for r in peer_roots] if peer_roots else None
        self._replica_roots = (
            [r.rstrip("/") for r in replica_roots] if replica_roots is not None else None
        )
        self._promote_every_n = promote_every_n
        self.chunk_size = int(chunk_size_bytes or knobs.get_cas_chunk_size_bytes())
        self.retain_steps = max(1, int(retain_steps))
        self._topology = topology
        self.device = device
        self._stores: Dict[str, ContinuousStore] = {}
        self._holds: Dict[str, Set[str]] = {}
        self._target_heads: Dict[str, int] = {}
        self._recent: List[Tuple[int, Set[str]]] = []
        self._targets: Optional[List[str]] = None  # resolved at the first step
        self._ns: Optional[str] = None
        self._step_count = 0
        self._last_step: Optional[int] = None
        self._inflight: Optional[_StepJob] = None
        self._queue: "queue.Queue[Optional[_StepJob]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._target_pool: Optional[ThreadPoolExecutor] = None
        self._io_loop: Any = None  # one scheduler._LoopThread for every write
        self._closed = False
        # the peer leg's transport, resolved once on the worker; None for
        # the KV engine (its device_move is the identity)
        self._transport: Any = None
        self._transport_resolved = False
        # durable promotion: CONFIRMED-durable keys (the delta basis),
        # the groups in flight, and step manifests whose local GC waits
        # for their promotion
        self._durable_confirmed: Set[str] = set()
        self._durable_head_step: Optional[int] = None
        self._durable_manifest_steps: Set[int] = set()
        self._manifest_gc_pending: Set[int] = set()
        # chunks a FAILED promotion may have half-copied: swept with the
        # confirmed set at the next successful promotion
        self._durable_orphans: Set[str] = set()
        # guards all promotion bookkeeping and the holds; the worker and
        # the accessor threads (summary, last_durable_step) both sweep,
        # and physical deletes run outside it
        self._promo_lock = threading.Lock()
        self._promotions: List[Tuple[PromotionGroup, Set[str], Set[str], int]] = []
        # guards the lazy singletons (_ns, _targets, _target_pool,
        # _io_loop, _transport); the work that resolves them runs outside
        self._init_lock = threading.Lock()
        self._preemption_handle: Optional[int] = None
        if preemption_hook:
            self._preemption_handle = preemption.on_preemption(self._preemption_drain)
        global _ACTIVE
        _ACTIVE = weakref.ref(self)
        # seed the durable dedup basis from an existing mirror, so a
        # restarted job does not promote every byte again
        if self.durable_root is not None:
            self._seed_durable()

    # ---------------------------------------------------------- plumbing

    @property
    def _coord(self) -> Coordinator:
        if self._coordinator is None:
            self._coordinator = get_default_coordinator()
        return self._coordinator

    @property
    def rank(self) -> int:
        return self._coord.rank

    def _rank_store_root(self, host_root: str) -> str:
        return f"{host_root.rstrip('/')}/r{self.rank}"

    @property
    def local_store_root(self) -> str:
        return self._rank_store_root(self.local_root)

    @property
    def durable_store_root(self) -> Optional[str]:
        if self.durable_root is None:
            return None
        return self._rank_store_root(self.durable_root)

    def _store(self, root: str) -> ContinuousStore:
        store = self._stores.get(root)
        if store is None:
            store = self._stores[root] = ContinuousStore(root)
        return store

    def _ensure_executor(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=knobs.get_staging_threads(),
                thread_name_prefix="tsnp-torch-continuous-digest",
            )
        return self._executor

    def _ensure_target_pool(self) -> ThreadPoolExecutor:
        with self._init_lock:
            if self._target_pool is None:
                self._target_pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="tsnp-torch-continuous-target"
                )
            return self._target_pool

    def _ensure_io_loop(self) -> Any:
        """One long-lived event-loop thread for every chunk write of every
        step: a thread and loop per call would sit on the per-step path."""
        with self._init_lock:
            if self._io_loop is None:
                from ..scheduler import _LoopThread

                self._io_loop = _LoopThread("tsnp-torch-continuous-io")
            return self._io_loop

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_run, name="tsnp-torch-continuous-replicate", daemon=True
            )
            self._worker.start()

    def promote_every_n(self) -> int:
        return (
            knobs.get_continuous_promote_every_n()
            if self._promote_every_n is None
            else max(0, int(self._promote_every_n))
        )

    # ----------------------------------------------------- target choice

    def _ensure_ns(self) -> str:
        """The checkpointer's KV namespace (heartbeats, exchanges): a uid
        of the coordinator's program-order counter, alike on every rank
        that builds and uses its checkpointer in the same order."""
        with self._init_lock:
            if self._ns is None:
                self._ns = self._coord._next_uid("cc")
            return self._ns

    def _exchange_peer_roots(self) -> Optional[List[str]]:
        """Every rank's host root by rank, exchanged over the KV on first
        need (collective: every rank reaches it in the same order)."""
        if self._peer_roots is None and self._coord.world_size > 1:
            self._peer_roots = [
                r.rstrip("/")
                for r in self._coord.kv_exchange(f"{self._ensure_ns()}/roots", self.local_root)
            ]
        return self._peer_roots

    def _ensure_targets(self) -> List[str]:
        """The target STORE roots, resolved at the first step: the local
        store first, then ``replica_roots`` as given, else peers chosen
        from the exchanged roots by topology (another slice first)."""
        with self._init_lock:
            if self._targets is not None:
                return self._targets
        coord = self._coord
        self._ensure_ns()
        if self._replica_roots is not None:
            hosts = list(self._replica_roots)
        elif coord.world_size > 1:
            from ..topology import replica_candidate_order

            peers = self._exchange_peer_roots()
            topo = self._topology
            if topo is None:
                topo = self._detect_topology()
            order = replica_candidate_order(topo, coord.rank, len(peers))
            hosts = []
            for c in order:
                if len(hosts) >= self.replica_count:
                    break
                if peers[c] != self.local_root and peers[c] not in hosts:
                    hosts.append(peers[c])
        else:
            hosts = []
            logger.warning(
                "continuous checkpointing without peers (world_size 1, no replica_roots): "
                "a lost host falls back to the durable mirror only"
            )
        targets = [self.local_store_root] + [self._rank_store_root(h) for h in hosts]
        with self._init_lock:
            self._targets = targets
        for root in targets:
            self._seed_holds(root)
        return targets

    def _detect_topology(self) -> Any:
        try:
            from ..topology import detect_topology

            return detect_topology(self._coord, exchange_prefix=f"{self._ensure_ns()}/topo")
        except Exception as e:  # noqa: BLE001 — placement is an optimisation
            obs.swallowed_exception("continuous.topology_detect", e)
            return None

    def _head_keys(self, root: str) -> Optional[Tuple[int, Set[str]]]:
        store = self._store(root)
        head = store.read_head()
        if head is None:
            return None
        manifest = store.read_step_manifest(str(head["manifest"]))
        return int(head["step"]), {k for rec in manifest["leaves"].values() for k in rec["keys"]}

    def _seed_holds(self, root: str) -> None:
        """Warm start against a surviving store: trust the chunks its
        HEAD step references, so a restart does not send them again."""
        try:
            found = self._head_keys(root)
            if found is None:
                return
            step, keys = found
            with self._promo_lock:
                self._holds.setdefault(root, set()).update(keys)
                self._target_heads[root] = step
                self._recent.append((step, keys))
        except Exception as e:  # noqa: BLE001 — a cold start is correct
            obs.swallowed_exception("continuous.seed_holds", e)

    def _seed_durable(self) -> None:
        try:
            found = self._head_keys(self.durable_store_root)
            if found is None:
                return
            step, keys = found
            with self._promo_lock:
                self._durable_confirmed |= keys
                self._durable_head_step = step
        except Exception as e:  # noqa: BLE001 — a full promotion instead
            obs.swallowed_exception("continuous.seed_durable", e)

    # ------------------------------------------------------------- step

    def step(self, app_state: Dict[str, Any], step: int) -> bool:
        """Record one completed training step: digest the state, stage
        the changed chunks and hand them to the replication thread.
        Returns False when the CONTINUOUS knob is off (nothing recorded).
        The state may change as soon as this returns."""
        if not knobs.continuous_enabled() or self._closed:
            return False
        t_begin = goodput.take_begin(self.local_store_root)
        with obs.span("continuous/step", step=step):
            # at most ONE step's replication in flight: it lands before
            # this step's delta is computed, which also bounds the loss
            self._join_inflight()
            targets = self._ensure_targets()
            job = self._build_job(app_state, step, targets, t_begin)
            self._step_count += 1
            self._last_step = step
            self._ensure_worker()
            self._inflight = job
            self._queue.put(job)
        blocked = goodput.take_unblocked(self.local_store_root, t_begin)
        obs.histogram(obs.CONTINUOUS_STEP_OVERHEAD_S).observe(blocked)
        obs.counter(obs.CONTINUOUS_STEPS).inc()
        return True

    def _wait_job(self, job: _StepJob, timeout_s: float) -> None:
        if not job.done.wait(timeout_s):
            raise TimeoutError(
                f"continuous replication of step {job.step} still running after "
                f"{timeout_s:g} s (targets: {sorted(job.target_items)})"
            )

    def _join_inflight(self) -> None:
        job = self._inflight
        if job is not None:
            self._wait_job(job, DRAIN_DEADLINE_S)
            self._inflight = None

    def _build_job(
        self, app_state: Dict[str, Any], step: int, targets: List[str], t_begin: float
    ) -> _StepJob:
        executor = self._ensure_executor()
        state_tree = {
            k: (v.state_dict() if hasattr(v, "state_dict") else v) for k, v in app_state.items()
        }
        _manifest, flattened = flatten(state_tree)
        leaves: Dict[str, Dict[str, Any]] = {}
        # a chunk is skipped only when EVERY target holds it (the
        # intersection): a target whose last replication failed lacks
        # chunks its peers hold, and its next HEAD may name them only once
        # they were sent again
        inter_holds: Optional[Set[str]] = None
        with self._promo_lock:
            for tgt in targets:
                h = self._holds.get(tgt, set())
                inter_holds = set(h) if inter_holds is None else (inter_holds & h)
            holds_by_target = {tgt: set(self._holds.get(tgt, ())) for tgt in targets}
        inter_holds = inter_holds or set()
        all_keys: Set[str] = set()
        staged: Dict[str, bytes] = {}
        m_skip_b = obs.counter(obs.CONTINUOUS_BYTES_SKIPPED)
        m_skip_c = obs.counter(obs.CONTINUOUS_CHUNKS_SKIPPED)
        m_new_c = obs.counter(obs.CONTINUOUS_CHUNKS_REPLICATED)

        def _digest(view: memoryview, lo: int, hi: int) -> str:
            crc, adler = digest(view[lo:hi])
            return chunk_key((crc, adler, hi - lo))

        for path in sorted(flattened):
            rec, view = encode_leaf(flattened[path])
            spans = plan_parts(view.nbytes, self.chunk_size)
            keys = list(executor.map(lambda s, v=view: _digest(v, s[0], s[1]), spans))
            rec["keys"] = keys
            leaves[path] = rec
            for key, (lo, hi) in zip(keys, spans):
                if key in all_keys:
                    continue  # a repeat within the step (tied weights)
                all_keys.add(key)
                if key in inter_holds:
                    m_skip_b.inc(hi - lo)
                    m_skip_c.inc()
                elif key not in staged:
                    # a private copy: the training loop mutates the state
                    # the moment step() returns, and a CPU tensor's view
                    # is its own storage
                    staged[key] = bytes(view[lo:hi])
                    m_new_c.inc()
        target_items: Dict[str, List[Tuple[str, bytes]]] = {}
        for tgt in targets:
            holds = holds_by_target[tgt]
            target_items[tgt] = [
                (chunk_location(k), staged[k]) for k in sorted(staged) if k not in holds
            ]
        promote_n = self.promote_every_n()
        # the count is taken before this step's increment: the FIRST step
        # promotes (a durable baseline at once), then every Nth
        promote = (
            self.durable_root is not None and promote_n > 0 and self._step_count % promote_n == 0
        )
        return _StepJob(
            step=step,
            t_begin=t_begin,
            target_items=target_items,
            all_keys=all_keys,
            manifest_payload=encode_step_manifest(step, self.chunk_size, leaves),
            head_payload=encode_head(step),
            promote=promote,
        )

    # ------------------------------------------------------ worker side

    def _worker_run(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                self._run_job(job)
            except BaseException:  # noqa: BLE001 — a background thread: the peer keeps its previous step
                obs.counter(obs.CONTINUOUS_REPLICATION_ERRORS).inc()
                logger.exception(
                    "continuous replication job for step %s failed", getattr(job, "step", "?")
                )
            finally:
                if job is not None:
                    job.done.set()
                self._queue.task_done()

    def _transport_for_peers(self) -> Any:
        """The peer leg's engine, resolved once on the worker: the
        collective engine when the runtime offers it (its device round
        trip, digest-verified), else None (KV's leg is the identity)."""
        with self._init_lock:
            if not self._transport_resolved:
                self._transport_resolved = True
                from ..transport import resolve_transport

                t = resolve_transport(self._coordinator, topology=self._topology, device=self.device)
                self._transport = t if t.engine == "collective" else None
            return self._transport

    def _run_job(self, job: _StepJob) -> None:
        from ..scheduler import get_process_memory_budget_bytes, sync_execute_buffer_writes

        # ONE budget for the step's targets, split evenly between them
        per_target_budget = max(
            1, get_process_memory_budget_bytes() // max(1, len(job.target_items))
        )
        # made before the targets run concurrently (two pool threads
        # creating them would race)
        io_loop = self._ensure_io_loop()
        transport = self._transport_for_peers()

        def _one_target(root: str, items) -> bool:
            store = self._store(root)
            try:
                if items:
                    sync_execute_buffer_writes(
                        items,
                        store.storage,
                        per_target_budget,
                        counter_name=obs.CONTINUOUS_BYTES_REPLICATED,
                        failpoint_site="continuous.replicate",
                        span_label="continuous/replicate_object",
                        loop_thread=io_loop,
                        # the device round trip for bytes leaving this host
                        transport=transport if root != self.local_store_root else None,
                    )
                store.write_manifest(job.step, job.manifest_payload)
                store.write_head(job.head_payload)
            except Exception as e:  # noqa: BLE001 — this target keeps its previous complete step
                # (marker-last), and its holds do not advance, so the next
                # step sends whatever it lacks
                obs.counter(obs.CONTINUOUS_REPLICATION_ERRORS).inc()
                logger.warning(
                    "continuous replication of step %d to %r failed (%r); the target stays "
                    "at its previous step", job.step, root, e,
                )
                return False
            with self._promo_lock:
                self._holds.setdefault(root, set()).update(job.all_keys)
                self._target_heads[root] = job.step
            return True

        with obs.span("continuous/replicate", step=job.step, targets=len(job.target_items)):
            items_by_root = list(job.target_items.items())
            if len(items_by_root) > 1:
                # the targets replicate CONCURRENTLY: the window in which a
                # host's death loses this step is the slowest target's
                pool = self._ensure_target_pool()
                list(pool.map(lambda kv: _one_target(*kv), items_by_root))
            else:
                for root, items in items_by_root:
                    _one_target(root, items)
        lag = time.monotonic() - job.t_begin
        obs.histogram(obs.CONTINUOUS_REPLICATION_LAG_S).observe(lag)
        last = self._last_step if self._last_step is not None else job.step
        peer = self.last_peer_step()
        obs.gauge(obs.CONTINUOUS_REPLICATION_LAG_STEPS).set(
            max(0, last - peer) if peer is not None else 0
        )
        self._record_recent(job)
        # reconcile settled promotions every step, not only when the next
        # one is queued (a manual-promote run would keep a stale durable
        # step and pin the group's keys against pruning)
        if self._pending_promotions():
            self._sweep_promotions()
        if job.promote and self._target_heads.get(self.local_store_root) == job.step:
            self._enqueue_promotion(job)
        coord = self._coordinator
        with self._init_lock:
            ns = self._ns
            targets = self._targets
        if coord is not None and ns is not None:
            # what the peers HOLD: -1 while peers exist and none holds a
            # complete step; without peers the local HEAD is the truth
            lp = self.last_peer_step()
            if lp is None:
                has_peers = len(targets or ()) > 1
                lp = -1 if has_peers else self._target_heads.get(self.local_store_root, -1)
            heartbeat.publish(coord, ns, coord.rank, lp)

    def _record_recent(self, job: _StepJob) -> None:
        """Retention: keep the last ``retain_steps`` steps' manifests and
        the union of their chunks, prune older ones, but only from targets
        whose HEAD is current: a lagging target still serves its older
        step.  Chunks a pending promotion reads from the local store are
        kept too."""
        deletions: List[Tuple[str, str]] = []
        with self._promo_lock:
            self._recent.append((job.step, set(job.all_keys)))
            while len(self._recent) > self.retain_steps:
                old_step, _old_keys = self._recent.pop(0)
                keep: Set[str] = set()
                for _s, ks in self._recent:
                    keep |= ks
                protect = set(keep)
                pending_steps: Set[int] = set()
                for _g, new_keys, step_keys, s in self._promotions:
                    protect |= new_keys | step_keys
                    pending_steps.add(s)
                if old_step in pending_steps:
                    # a queued promotion still copies this manifest: its
                    # GC waits for the sweep that settles the group
                    self._manifest_gc_pending.add(old_step)
                for root in list(self._holds):
                    if root == self.durable_store_root:
                        continue
                    if self._target_heads.get(root) != job.step:
                        continue  # a lagging target's HEAD still needs these
                    holds = self._holds[root]
                    for key in sorted(holds - protect):
                        deletions.append((root, chunk_location(key)))
                        holds.discard(key)
                    if old_step not in pending_steps:
                        deletions.append((root, step_manifest_path(old_step)))
        for root, path in deletions:
            self._store(root).delete_quiet(path)

    # -------------------------------------------------------- promotion

    def _pending_promotions(self) -> int:
        with self._promo_lock:
            return len(self._promotions)

    def _enqueue_promotion(self, job: _StepJob) -> None:
        """Hand this step to the write-back promoter: its data job copies
        the chunks not yet durable and the step manifest from the local
        store, its commit job writes the PINNED HEAD last, so an
        interrupted promotion leaves the mirror at its previous step."""
        self._sweep_promotions()
        durable_root = self.durable_store_root
        assert durable_root is not None
        # the delta is against CONFIRMED residency only: an earlier
        # pending group may still fail mid-copy, and a group that assumed
        # its keys would commit a HEAD naming chunks nobody copied
        with self._promo_lock:
            new_keys = set(job.all_keys) - self._durable_confirmed
            group = PromotionGroup(self.local_store_root, durable_root)
            group.paths = {chunk_location(k) for k in new_keys}
            group.paths.add(step_manifest_path(job.step))
            group.marker_payload = job.head_payload
            self._promotions.append((group, new_keys, set(job.all_keys), job.step))
        promoter = get_promoter()
        promoter.enqueue_data(group)
        promoter.enqueue_commit(group)
        obs.counter(obs.CONTINUOUS_PROMOTIONS).inc()

    def _sweep_promotions(self) -> None:
        """Settle finished promotion groups: a completed one makes its step
        the durable HEAD and releases durable chunks nothing references
        any more; a failed one leaves (its keys never counted as durable).
        Also runs the manifest GC deferred for steps whose promotion
        settled after retention dropped them.  Bookkeeping under
        ``_promo_lock``, deletes outside it."""
        deletions: List[Tuple[str, str]] = []
        with self._promo_lock:
            still: List[Tuple[PromotionGroup, Set[str], Set[str], int]] = []
            confirmed: Optional[Tuple[Set[str], int]] = None
            for group, new_keys, step_keys, step in self._promotions:
                if group.completed:
                    self._durable_confirmed |= new_keys
                    self._durable_manifest_steps.add(step)
                    if confirmed is None or step > confirmed[1]:
                        confirmed = (step_keys, step)
                elif group.failed:
                    # its data job may have copied some before dying
                    self._durable_orphans |= new_keys
                else:
                    still.append((group, new_keys, step_keys, step))
            self._promotions = still
            pending_steps = {s for _g, _nk, _sk, s in still}
            gc_now = {s for s in self._manifest_gc_pending if s not in pending_steps}
            if gc_now:
                self._manifest_gc_pending -= gc_now
                retained = {s for s, _ks in self._recent}
                for s in gc_now:
                    if s in retained:
                        continue
                    for root in list(self._holds):
                        if root == self.durable_store_root:
                            continue
                        deletions.append((root, step_manifest_path(s)))
            if confirmed is not None:
                step_keys, step = confirmed
                if self._durable_head_step is None or step > self._durable_head_step:
                    self._durable_head_step = step
                # drop confirmed chunks the new durable HEAD no longer
                # names and no pending promotion needs
                protect = set(step_keys)
                for _g, nk, sk, _s in still:
                    protect |= nk | sk
                stale = (self._durable_confirmed | self._durable_orphans) - protect
                if stale:
                    for key in sorted(stale):
                        deletions.append((self.durable_store_root, chunk_location(key)))
                    self._durable_confirmed -= stale
                    self._durable_orphans -= stale
                self._durable_orphans &= protect
                # the durable mirror keeps the HEAD step's manifest (and
                # any pending one's), not one per promotion forever
                old_manifests = {
                    s for s in self._durable_manifest_steps if s < step and s not in pending_steps
                }
                for s in sorted(old_manifests):
                    deletions.append((self.durable_store_root, step_manifest_path(s)))
                self._durable_manifest_steps -= old_manifests
        for root, path in deletions:
            self._store(root).delete_quiet(path)

    def promote(self) -> bool:
        """Promote the newest fully replicated step to the durable mirror
        now, outside the every-N cadence (before a planned scale-down).
        False when there is nothing to promote or no durable root."""
        with obs.span("continuous/promote"):
            if self.durable_root is None or self._last_step is None:
                return False
            self._join_inflight()
            head = self._target_heads.get(self.local_store_root)
            if head is None:
                return False
            manifest_keys: Set[str] = set()
            with self._promo_lock:
                recent = list(self._recent)
            for s, ks in recent:
                if s == head:
                    manifest_keys = ks
                    break
            if not manifest_keys:
                # the head step left _recent (failed local writes moved
                # the list past it): read its keys back from the local
                # manifest; an EMPTY set would pin a HEAD whose chunks
                # were never copied
                try:
                    m = self._store(self.local_store_root).read_step_manifest(
                        step_manifest_path(head)
                    )
                    manifest_keys = {k for rec in m["leaves"].values() for k in rec["keys"]}
                except Exception as e:  # noqa: BLE001 — refuse rather than tear the mirror
                    logger.warning(
                        "promote(): cannot resolve the chunks of head step %d (%r); "
                        "no promotion", head, e,
                    )
                    return False
            job = _StepJob(
                step=head,
                t_begin=time.monotonic(),
                target_items={},
                all_keys=manifest_keys,
                manifest_payload=b"",
                head_payload=encode_head(head),
                promote=True,
            )
            self._enqueue_promotion(job)
            return True

    # -------------------------------------------------- drain/close/obs

    def drain(self, deadline: Optional[float] = None) -> bool:
        """Wait until the in-flight replication landed on every reachable
        target.  ``deadline`` (monotonic) bounds the wait and a miss
        returns False (the preemption drain); without one the wait is
        bounded by ``DRAIN_DEADLINE_S`` and a miss raises
        ``TimeoutError`` naming the step."""
        with obs.span("continuous/drain"):
            job = self._inflight
            if job is None:
                return True
            if deadline is None:
                self._wait_job(job, DRAIN_DEADLINE_S)
                ok = True
            else:
                ok = job.done.wait(max(0.0, deadline - time.monotonic()))
            if ok:
                self._inflight = None
            return ok

    def _preemption_drain(self, deadline: float) -> None:
        done = self.drain(deadline)
        logger.warning(
            "preemption drain %s (last step %s, peers at %s)",
            "complete" if done else "TIMED OUT", self._last_step, self.last_peer_step(),
        )

    def close(self, drain: bool = True) -> None:
        """Stop the loop: drain the in-flight replication (optionally),
        stop the worker, clear this rank's heartbeat and release the
        preemption hook.  A drain that times out raises after the rest
        of the shutdown ran."""
        with obs.span("continuous/close"):
            if self._closed:
                return
            self._closed = True
            try:
                if drain:
                    self.drain()
            finally:
                self._shutdown()

    def _shutdown(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=_WORKER_JOIN_S)
            if self._worker.is_alive():
                logger.warning(
                    "continuous replication thread still running %g s after close(); "
                    "left behind (a daemon)", _WORKER_JOIN_S,
                )
        if self._preemption_handle is not None:
            preemption.remove_handler(self._preemption_handle)
            self._preemption_handle = None
        coord = self._coordinator
        with self._init_lock:
            ns = self._ns
        if coord is not None and ns is not None:
            heartbeat.clear(coord, ns, coord.rank)
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        with self._init_lock:
            pool, self._target_pool = self._target_pool, None
            io_loop, self._io_loop = self._io_loop, None
            t, self._transport = self._transport, None
        if pool is not None:
            pool.shutdown(wait=False)
        if io_loop is not None:
            io_loop.shutdown()
        if t is not None:
            try:
                t.close()
            except Exception as e:  # noqa: BLE001 — best-effort
                obs.swallowed_exception("continuous.transport", e)
        for store in self._stores.values():
            store.sync_close()
        self._stores.clear()

    def restore_latest(
        self, app_state: Dict[str, Any], strict: bool = True, device: Any = None
    ) -> Optional[Dict[str, Any]]:
        """Recover this rank's state from the freshest reachable source
        (local store, peers with another slice first, the durable mirror;
        ``recover.recover_state``) onto ``device`` (default: the
        checkpointer's).  Returns the recovery's result, or None on a cold
        start.  Without ``peer_roots`` the roots are exchanged over the KV
        here, so every rank of a restarted fleet calls it before its first
        step; a lone rank recovering out of band passes ``peer_roots``."""
        with obs.span("continuous/restore_latest"):
            from .recover import recover_state

            peer_stores: List[str] = []
            if self._replica_roots:
                peer_stores = [self._rank_store_root(r) for r in self._replica_roots]
            else:
                from ..topology import replica_candidate_order

                peers = self._exchange_peer_roots()
                if peers:
                    # recover_state restores freshest-first; this order
                    # only breaks ties, aligned with the write placement
                    order = replica_candidate_order(self._topology, self._coord.rank, len(peers))
                    peer_stores = [
                        self._rank_store_root(peers[c]) for c in order if peers[c] != self.local_root
                    ]
            return recover_state(
                app_state,
                local=self.local_store_root,
                peers=peer_stores,
                durable=self.durable_store_root,
                strict=strict,
                device=self.device if device is None else device,
            )

    def last_step(self) -> Optional[int]:
        return self._last_step

    def last_peer_step(self) -> Optional[int]:
        """The newest step EVERY peer target holds completely (the loss
        floor); None before the first replication or without peers."""
        with self._init_lock:
            all_targets = self._targets or ()
        targets = [t for t in all_targets if t != self.local_store_root]
        if not targets:
            return None
        with self._promo_lock:
            heads = [self._target_heads.get(t) for t in targets]
        if any(h is None for h in heads):
            return None
        return min(heads)

    def last_durable_step(self) -> Optional[int]:
        # settle any promotion that finished since the last job (a final
        # promote() + drain() + close() has no job left to sweep it)
        if self._pending_promotions():
            self._sweep_promotions()
        with self._promo_lock:
            return self._durable_head_step

    def heartbeats(self) -> Optional[Dict[int, Optional[int]]]:
        """Every rank's last heartbeat step (None before the namespace)."""
        coord = self._coordinator
        with self._init_lock:
            ns = self._ns
        if coord is None or ns is None:
            return None
        return heartbeat.read_all(coord, ns, coord.world_size)

    def summary(self) -> Dict[str, Any]:
        """JSON-safe state for flight records, ``doctor`` and ``stats``."""
        if self._pending_promotions():
            self._sweep_promotions()
        peer_step = self.last_peer_step()
        with self._init_lock:
            targets = self._targets
        with self._promo_lock:
            durable_head = self._durable_head_step
            pending = len(self._promotions)
            target_heads = dict(self._target_heads)
        return {
            "last_step": self._last_step,
            "local_head_step": target_heads.get(self.local_store_root),
            "last_peer_step": peer_step,
            "last_durable_step": durable_head,
            "replication_lag_steps": (
                max(0, self._last_step - peer_step)
                if self._last_step is not None and peer_step is not None
                else None
            ),
            "peer_targets": max(0, len(targets or ()) - 1),
            "target_heads": {root: head for root, head in sorted(target_heads.items())},
            "promotions_pending": pending,
        }
