"""Rank liveness: heartbeat stamps, dead-rank detection.

Counterpart of ``torchsnapshot_tpu/resilience/liveness.py``.  The abort
protocol (``abort.py``) covers ranks that FAIL; a rank that DIES (killed,
out of memory, hung) never reaches its ``poison`` call.  A
``LivenessSession`` stamps ``{ns}/hb/{rank}`` over the coordination KV
with an advancing sequence every ``LIVENESS_INTERVAL_S``; a
``LivenessMonitor`` tracks, per peer, the last sequence it saw and when
it last changed on the observer's own monotonic clock (no cross-process
clock is ever compared), and declares a peer dead when its stamp is
present but frozen for more than ``LIVENESS_TIMEOUT_S`` — or, with
``absent_after_s``, never appeared in that long.  ``stop()`` deletes the
rank's own stamp, so a clean exit reads as absence, never as death.

In the port only the tier promoter's done handshake uses them
(``tier/promoter.py``).  ``Coordinator.liveness_scope`` (death-aware
waits on the take path), write takeover and degraded commits are ROADMAP
queue A item 5; ``DegradedSnapshotError`` is raised by the restore of a
degraded snapshot the JAX package wrote.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from .. import knobs, obs

logger = logging.getLogger(__name__)


class RankDeadError(RuntimeError):
    """A peer rank was declared dead: its liveness stamp stopped
    advancing for longer than ``LIVENESS_TIMEOUT_S``.  Carries the
    first dead rank observed (``rank``) and every rank dead at raise
    time (``dead_ranks``) so the takeover path can plan against the
    full set without re-probing."""

    def __init__(self, rank: int, dead_ranks: Optional[Iterable[int]] = None,
                 ns: str = "") -> None:
        self.rank = int(rank)
        self.dead_ranks = sorted(
            set(dead_ranks) if dead_ranks is not None else {self.rank}
        )
        self.ns = ns
        super().__init__(
            f"rank {self.rank} declared dead (no liveness progress under "
            f"{ns or '?'} for > {knobs.get_liveness_timeout_s():g}s; dead "
            f"set {self.dead_ranks})"
        )


class DegradedSnapshotError(RuntimeError):
    """A restore would read logical paths the snapshot's ``degraded``
    section declares lost with a rank that died during the take."""

    def __init__(self, path: str, degraded_paths: Iterable[str]) -> None:
        self.path = path
        self.degraded_paths = sorted(degraded_paths)
        super().__init__(
            f"snapshot {path!r} is degraded: {len(self.degraded_paths)} logical "
            f"path(s) were lost with a dead rank and not healed: "
            f"{self.degraded_paths[:5]}"
        )


class _PeerState:
    __slots__ = ("seq", "changed_at")

    def __init__(self, seq: Optional[int], now: float) -> None:
        self.seq = seq
        self.changed_at = now


class LivenessMonitor:
    """Observer half: samples every OTHER rank's ``{ns}/hb/{r}`` stamp
    (at most once per ``LIVENESS_INTERVAL_S`` — ``check()`` is called
    from hot poll loops) and declares a peer dead when its stamp is
    present but frozen for > ``LIVENESS_TIMEOUT_S``.

    ``absent_after_s``: when set, a peer whose stamp NEVER appeared
    within that many seconds of monitor start is also declared dead —
    for handshakes where every live peer is known to start stamping
    promptly (tier promoter).  Default off, because an absent key is
    ambiguous (a cleanly-finished rank deletes its own stamp)."""

    def __init__(
        self,
        coordinator: Any,
        ns: str,
        absent_after_s: Optional[float] = None,
    ) -> None:
        self._coordinator = coordinator
        self._ns = ns
        self._absent_after_s = absent_after_s
        self._lock = threading.Lock()
        self._started_at = time.monotonic()
        self._last_sample = 0.0
        self._peers: Dict[int, _PeerState] = {}
        self._declared: set = set()

    @property
    def ns(self) -> str:
        return self._ns

    def _sample_locked(self, now: float) -> None:
        interval = knobs.get_liveness_interval_s()
        if now - self._last_sample < interval:
            return
        self._last_sample = now
        coord = self._coordinator
        for r in range(coord.world_size):
            if r == coord.rank:
                continue
            try:
                raw = coord.kv_try_get(f"{self._ns}/hb/{r}")
            except Exception as e:  # noqa: BLE001 — a flaky probe must
                # not fabricate a death; skip this tick
                obs.swallowed_exception("liveness.sample", e)
                continue
            seq: Optional[int]
            try:
                seq = int(raw) if raw is not None else None
            except ValueError:
                seq = None
            st = self._peers.get(r)
            if st is None:
                self._peers[r] = _PeerState(seq, now)
            elif seq != st.seq:
                st.seq = seq
                st.changed_at = now

    def dead_ranks(self) -> List[int]:
        """Every peer currently considered dead (see class docstring
        for the rule).  Samples lazily; pure-local otherwise."""
        now = time.monotonic()
        timeout = knobs.get_liveness_timeout_s()
        out: List[int] = []
        with self._lock:
            self._sample_locked(now)
            for r, st in self._peers.items():
                if st.seq is None:
                    # never appeared (or already cleaned up): dead only
                    # under the opt-in absence rule
                    if (
                        self._absent_after_s is not None
                        and now - self._started_at > self._absent_after_s
                    ):
                        out.append(r)
                elif now - st.changed_at > timeout:
                    out.append(r)
            newly = [r for r in out if r not in self._declared]
            if newly:
                self._declared.update(newly)
                obs.counter(obs.LIVENESS_DEAD_RANKS).inc(len(newly))
                logger.warning(
                    "liveness: rank(s) %s declared dead under %r "
                    "(stamp frozen > %gs)", newly, self._ns, timeout,
                )
        return sorted(out)

    def check(self) -> None:
        """Raise ``RankDeadError`` if any peer is dead — the one call
        the coordinator's poll loops make per tick."""
        dead = self.dead_ranks()
        if dead:
            raise RankDeadError(dead[0], dead, ns=self._ns)


class LivenessSession:
    """Publisher + monitor for one operation scope: starts a daemon
    thread stamping ``{ns}/hb/{rank}`` with an advancing sequence every
    ``LIVENESS_INTERVAL_S``; ``stop()`` joins the thread and deletes
    this rank's stamp (clean exit leaves no key).  Use as a context
    manager; the monitor is exposed for ``Coordinator.liveness_scope``.
    """

    def __init__(
        self,
        coordinator: Any,
        ns: str,
        absent_after_s: Optional[float] = None,
    ) -> None:
        self._coordinator = coordinator
        self._ns = ns
        self.monitor = LivenessMonitor(
            coordinator, ns, absent_after_s=absent_after_s
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _publish_loop(self) -> None:
        coord = self._coordinator
        key = f"{self._ns}/hb/{coord.rank}"
        seq = 0
        while not self._stop.is_set():
            try:
                coord.kv_set(key, str(seq))
                obs.counter(obs.LIVENESS_HEARTBEATS).inc()
            except Exception as e:  # noqa: BLE001 — heartbeat is
                # best-effort: a flaky KV must not crash the publisher
                # (peers see a frozen stamp only if EVERY retry fails
                # for the full timeout, which is a real outage)
                obs.swallowed_exception("liveness.publish", e)
            seq += 1
            self._stop.wait(knobs.get_liveness_interval_s())

    def start(self) -> "LivenessSession":
        if self._thread is None and self._coordinator.world_size > 1:
            self._thread = threading.Thread(
                target=self._publish_loop,
                name=f"tsnp-liveness-{self._coordinator.rank}",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Clean shutdown: stop stamping and DELETE this rank's key, so
        peers see absence (ambiguous, not dead) rather than an
        eternally-frozen stamp after this operation ends."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self._coordinator.kv_try_delete(
                f"{self._ns}/hb/{self._coordinator.rank}"
            )
        except Exception as e:  # noqa: BLE001 — cleanup is best-effort
            obs.swallowed_exception("liveness.clear", e)

    def __enter__(self) -> "LivenessSession":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
