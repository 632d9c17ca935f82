"""Background write-back promoter: fast-tier payloads → durable tier.

Counterpart of ``torchsnapshot_tpu/tier/promoter.py``.  One process-
global daemon thread drains a FIFO of promotion jobs, two kinds, always
enqueued in this order per take (so the FIFO alone gives the durability
invariant):

- ``data``: copy one rank's fast-tier data objects to the durable tier
  under the staging memory budget (``scheduler.sync_execute_copy_reqs``:
  storage to storage through host buffers, never the card), then publish
  this rank's done key ``{uid}/tierdone/{rank}`` over the coordination KV;
- ``commit`` (rank 0): wait for every rank's done key, then copy the
  flight record (best-effort) and ``.snapshot_metadata`` (fsync'd, the
  commit point) and record the promotion lag.  A crash anywhere before
  leaves the durable tier WITHOUT metadata: an aborted snapshot, never a
  committed and incomplete one.

The handshake uses explicit keys only, so it is legal from this thread.
Each data job heartbeats under ``{uid}/tier`` (``resilience/
liveness.py``); the commit job's wait skips a peer the monitor declares
dead (``takeover.promoter_dead_peers``) and then writes the marker only
after re-proving that every location of the marker's own manifest is
durable-resident.  Recovery groups (``SnapshotManager.repromote``) copy
what this host's fast root holds and write the marker only once every
location is durable.  Failpoints: ``tier.promote.data``,
``tier.promote.commit``.

A group may pin its commit marker (``marker_payload``: the continuous
loop's HEAD as of enqueue time) and reports ``completed`` once its
marker landed.  Every wait is bounded: the done keys by ``_DONE_TIMEOUT_S`` and
``drain`` by ``DRAIN_DEADLINE_S`` (600 s each), past which a
``TimeoutError`` names the job still running.  ``pause``/``resume``
exist for tests (an interrupted promotion).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional, Set, Tuple

from .. import obs

logger = logging.getLogger(__name__)

_METADATA_FNAME = ".snapshot_metadata"  # == snapshot.SNAPSHOT_METADATA_FNAME
_OBSRECORD_FNAME = ".snapshot_obsrecord"  # == obs.aggregate.OBSRECORD_FNAME
_DONE_TIMEOUT_S = 600.0
DRAIN_DEADLINE_S = 600.0


class PromotionGroup:
    """One take's promotion state on one rank: which fast-tier paths
    need copying (linked/deduped objects are already durable) plus the
    coordination handle for the cross-rank done handshake."""

    def __init__(self, fast_url: str, durable_url: str) -> None:
        self.fast_url = fast_url
        self.durable_url = durable_url
        self.paths: Set[str] = set()
        self.linked: Set[str] = set()
        self.coordinator = None
        self.uid: Optional[str] = None
        self.commit_enqueued_ts: Optional[float] = None
        # set when this rank's data job failed: the commit job fails
        # fast instead of stalling the FIFO for the full done-key
        # timeout (cross-RANK failures still time out — rank 0 cannot
        # see a peer's failure except by its key never appearing)
        self.failed = False
        # crash-recovery re-promotion (SnapshotManager.repromote): paths
        # are the GLOBAL manifest locations, of which this host's fast
        # root may hold only its own rank's share — the data job skips
        # absent objects, and the commit job writes the durable marker
        # only once EVERY location is durable-resident (so a partial
        # multi-host recovery can never fabricate a committed-but-
        # incomplete durable snapshot)
        self.recovery = False
        # a pinned commit marker (continuous/loop.py): the commit job
        # writes these bytes as the durable marker instead of copying
        # the fast root's live one, whose HEAD keeps advancing while the
        # promotion waits in this queue
        self.marker_payload: Optional[bytes] = None
        # set by the worker once the commit job wrote the marker: the
        # continuous loop polls it instead of blocking on drain()
        self.completed = False


class Promoter:
    """Process-global promotion queue (see module docstring)."""

    def __init__(self) -> None:
        self._queue: "queue.Queue[Tuple[str, PromotionGroup]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._resume = threading.Event()
        self._resume.set()
        self._errors: List[Tuple[str, BaseException]] = []
        self._running: Optional[str] = None

    # ------------------------------------------------------------ queue

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="tsnp-tier-promoter", daemon=True
                )
                self._thread.start()

    def enqueue_data(self, group: PromotionGroup) -> None:
        with obs.span(
            "tier/enqueue_data", durable=group.durable_url,
            objects=len(group.paths),
        ):
            self._ensure_thread()
            self._queue.put(("data", group))

    def enqueue_commit(self, group: PromotionGroup) -> None:
        with obs.span("tier/enqueue_commit", durable=group.durable_url):
            group.commit_enqueued_ts = time.monotonic()
            self._ensure_thread()
            self._queue.put(("commit", group))

    # ------------------------------------------------------- test hooks

    def pause(self) -> None:
        """Stop processing (jobs keep queueing) — simulates a promotion
        stall/crash window for tests."""
        self._resume.clear()

    def resume(self) -> None:
        self._resume.set()

    def drain(
        self, raise_on_error: bool = True, timeout_s: Optional[float] = None
    ) -> None:
        """Block until every queued job finished (at most ``timeout_s``,
        default ``DRAIN_DEADLINE_S``; past it a ``TimeoutError`` names the
        job still running); re-raise the first job error (promotion
        failures are otherwise background warnings)."""
        timeout = DRAIN_DEADLINE_S if timeout_s is None else timeout_s
        with obs.span("tier/drain"):
            deadline = time.monotonic() + timeout
            q = self._queue
            with q.all_tasks_done:
                while q.unfinished_tasks:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        with self._lock:
                            running = self._running
                        raise TimeoutError(
                            f"tier promotion drain: {q.unfinished_tasks} job(s) "
                            f"unfinished after {timeout:g} s; running: "
                            f"{running or 'none (paused?)'}"
                        )
                    q.all_tasks_done.wait(remaining)
            with self._lock:
                errors, self._errors = self._errors, []
            if errors and raise_on_error:
                raise RuntimeError(
                    f"{len(errors)} promotion job(s) failed"
                ) from errors[0][1]

    # ------------------------------------------------------------ worker

    def _run(self) -> None:
        while True:
            kind, group = self._queue.get()
            try:
                self._resume.wait()
                with self._lock:
                    self._running = f"{kind} job for {group.durable_url!r}"
                self._run_job(kind, group)
            except BaseException as e:  # noqa: BLE001 — background thread
                group.failed = True
                logger.exception(
                    "tier promotion %s job for %r failed", kind,
                    group.durable_url,
                )
                # cross-rank abort: rank 0's commit job is (or will be)
                # blocked waiting for every rank's done-key — poison the
                # promotion scope so it withholds the durable commit
                # marker within one poll interval instead of stalling
                # the FIFO for the full done-key timeout
                coord = group.coordinator
                if coord is not None and group.uid is not None:
                    coord.poison(
                        f"{group.uid}/tier",
                        cause=repr(e),
                        site=f"tier.promote.{kind}/rank{coord.rank}",
                    )
                with self._lock:
                    self._errors.append((kind, e))
            finally:
                with self._lock:
                    self._running = None
                self._queue.task_done()

    def _run_job(self, kind: str, group: PromotionGroup) -> None:
        from ..scheduler import (
            get_process_memory_budget_bytes,
            sync_execute_copy_reqs,
        )
        from ..storage import url_to_storage_plugin

        from ..resilience.failpoints import failpoint

        src = url_to_storage_plugin(group.fast_url)
        dst = url_to_storage_plugin(group.durable_url)
        try:
            if kind == "data":
                failpoint("tier.promote.data", durable=group.durable_url)
                paths = sorted(group.paths - group.linked)
                if group.recovery:
                    # this host's fast root holds only its own share of
                    # the global manifest — copy what exists locally
                    paths = [p for p in paths if _stat_ok(src, p)]
                coord = group.coordinator
                hb = None
                if coord is not None and group.uid is not None:
                    # heartbeat for the commit job's done-key wait: a
                    # SLOW copy keeps stamping (never declared dead); a
                    # killed process leaves a frozen/absent stamp and is
                    # skipped instead of wedging the handshake
                    from ..resilience.liveness import LivenessSession

                    hb = LivenessSession(
                        coord, f"{group.uid}/tier"
                    ).start()
                try:
                    with obs.span(
                        "tier/promote_data", durable=group.durable_url,
                        objects=len(paths),
                    ):
                        sync_execute_copy_reqs(
                            paths,
                            src,
                            dst,
                            get_process_memory_budget_bytes(),
                        )
                    if coord is not None and group.uid is not None:
                        coord.kv_set(
                            f"{group.uid}/tierdone/{coord.rank}", "ok"
                        )
                finally:
                    # strictly after the done-key: the stamp must stay
                    # live until peers can observe completion
                    if hb is not None:
                        hb.stop()
                return
            # commit: all ranks durable → metadata last
            with obs.span(
                "tier/promote_commit", durable=group.durable_url
            ):
                failpoint("tier.promote.commit", durable=group.durable_url)
                if group.failed:
                    raise RuntimeError(
                        f"durable commit for {group.durable_url!r} "
                        f"withheld: this rank's data promotion failed"
                    )
                coord = group.coordinator
                dead_skipped: List[int] = []
                if coord is not None and group.uid is not None:
                    # abort-aware, death-aware done-key wait: a peer
                    # whose data promotion FAILED poisons {uid}/tier and
                    # this raises SnapshotAbortedError promptly; a peer
                    # that DIED (frozen/never-appearing heartbeat) is
                    # skipped so the handshake can't wedge — the
                    # residency re-proof below decides whether the
                    # marker may still land
                    dead_skipped = self._await_done_keys(coord, group)
                if group.recovery:
                    # no cross-rank handshake in recovery mode: gate the
                    # commit marker on every manifest location actually
                    # being durable-resident instead
                    missing = [
                        p for p in sorted(group.paths)
                        if not _stat_ok(dst, p)
                    ]
                    if missing:
                        raise RuntimeError(
                            f"recovery promotion for {group.durable_url!r}"
                            f" incomplete: {len(missing)} object(s) not "
                            f"yet durable (other hosts' shares?); durable"
                            f" commit marker withheld — e.g. {missing[:3]}"
                        )
                from ..io_types import ReadIO, WriteIO

                if group.marker_payload is not None:
                    # a pinned marker (continuous promotion): the HEAD as
                    # of enqueue time; such groups have no flight record
                    marker = group.marker_payload
                else:
                    # flight-record sidecar first, best-effort: the
                    # durable tier keeps the record-lands-before-marker
                    # ordering, and a missing/unreadable record never
                    # blocks the durable commit (it is telemetry, not
                    # payload — the tier plugin keeps it out of
                    # group.paths)
                    try:
                        rec_io = ReadIO(path=_OBSRECORD_FNAME)
                        src.sync_read(rec_io)
                        dst.sync_write(
                            WriteIO(
                                path=_OBSRECORD_FNAME,
                                buf=bytes(memoryview(rec_io.buf).cast("B")),
                            )
                        )
                    except Exception as e:  # noqa: BLE001 — best-effort
                        obs.swallowed_exception("tier.promote.obsrecord", e)
                    read_io = ReadIO(path=_METADATA_FNAME)
                    src.sync_read(read_io)
                    marker = bytes(memoryview(read_io.buf).cast("B"))
                if dead_skipped:
                    self._require_durable_complete(
                        dst, marker, dead_skipped, group
                    )
                dst.sync_write(
                    WriteIO(
                        path=_METADATA_FNAME, buf=marker, durable=True
                    )
                )
            group.completed = True
            if group.commit_enqueued_ts is not None:
                obs.histogram(obs.PROMOTION_LAG_S).observe(
                    time.monotonic() - group.commit_enqueued_ts
                )
            # goodput: under write-back, THIS is the durable commit —
            # the take→durable lag ends when the durable marker lands,
            # not when the fast tier acked
            obs.goodput.durable_commit(group.durable_url)
            obs.maybe_write_metrics_textfile()
        finally:
            src.sync_close()
            dst.sync_close()


    def _await_done_keys(
        self, coord, group: PromotionGroup
    ) -> List[int]:
        """Wait for every rank's ``{uid}/tierdone/{r}`` key.  Returns
        the ranks SKIPPED because the liveness monitor declared them
        dead (frozen or never-appearing ``{uid}/tier`` heartbeat) with
        their done-key still absent.  A dead rank whose done-key DID
        land is just a finished rank — death only matters while its
        key is missing."""
        from .. import knobs
        from ..resilience.liveness import LivenessMonitor

        # absence rule ON: every live peer's data job starts stamping
        # as soon as it dequeues, so prolonged absence here means the
        # process never got that far (or is gone)
        monitor = LivenessMonitor(
            coord,
            f"{group.uid}/tier",
            absent_after_s=knobs.get_liveness_timeout_s(),
        )
        deadline = time.monotonic() + _DONE_TIMEOUT_S
        skipped: List[int] = []
        for r in range(coord.world_size):
            while True:
                if coord.kv_try_get(f"{group.uid}/tierdone/{r}") is not None:
                    break
                coord.raise_if_poisoned(f"{group.uid}/tier")
                if r != coord.rank and r in monitor.dead_ranks():
                    skipped.append(r)
                    obs.counter(
                        obs.TAKEOVER_PROMOTER_DEAD_PEERS
                    ).inc()
                    logger.warning(
                        "tier promotion %r: rank %d declared dead "
                        "before publishing its done-key; skipping it "
                        "in the handshake", group.durable_url, r,
                    )
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"tier promotion for {group.durable_url!r}: "
                        f"done-key for live rank {r} never appeared "
                        f"within {_DONE_TIMEOUT_S:g}s"
                    )
                time.sleep(0.1)
        return skipped

    def _require_durable_complete(
        self,
        dst,
        marker: bytes,
        dead_skipped: List[int],
        group: PromotionGroup,
    ) -> None:
        """Dead peers were skipped in the handshake — the marker may
        only land if the durable tier is provably complete anyway (the
        peer died AFTER its copies landed but before its done-key).
        The marker bytes carry the global manifest, so completeness is
        re-proven directly against the durable tier; anything missing
        withholds the marker exactly like a failed job."""
        from ..manifest import SnapshotMetadata

        md = SnapshotMetadata.from_yaml(marker.decode())
        chunked = set((md.cas or {}).get("chunks") or {})
        locs: Set[str] = set()
        for entry in md.manifest.values():
            loc = getattr(entry, "location", None)
            if isinstance(loc, str):
                locs.add(loc)
            for attr in ("shards", "chunks"):
                for shard in getattr(entry, attr, None) or ():
                    locs.add(shard.location)
        missing = sorted(
            p for p in locs - chunked if not _stat_ok(dst, p)
        )
        if missing:
            raise RuntimeError(
                f"durable commit for {group.durable_url!r} withheld: "
                f"dead peer(s) {dead_skipped} skipped in the "
                f"done-handshake and {len(missing)} manifest "
                f"object(s) are not durable-resident — e.g. "
                f"{missing[:3]}"
            )
        logger.warning(
            "tier promotion %r: committing despite dead peer(s) %s — "
            "all %d manifest locations are durable-resident",
            group.durable_url, dead_skipped, len(locs - chunked),
        )


def _stat_ok(storage, path: str) -> bool:
    try:
        storage.sync_stat(path)
        return True
    except Exception:  # noqa: BLE001 — absent or unreachable
        return False


_PROMOTER = Promoter()


def get_promoter() -> Promoter:
    return _PROMOTER


def drain_promotions(
    raise_on_error: bool = True, timeout_s: Optional[float] = None
) -> None:
    """Block until all pending write-back promotions landed (tests,
    benchmarks, and clean shutdowns before the host may be lost), at most
    ``timeout_s`` (default ``DRAIN_DEADLINE_S``)."""
    _PROMOTER.drain(raise_on_error=raise_on_error, timeout_s=timeout_s)
