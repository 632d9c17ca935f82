"""Goodput/SLO accounting: what checkpointing costs the training loop.

Counterpart of ``torchsnapshot_tpu/obs/goodput.py``.  Three numbers,
tracked per process and exposed as always-on gauges and flight-record
blocks (obs/aggregate.py):

- **time-to-unblock-train** (``goodput.time_to_unblock_s``) — how long
  the last take blocked its caller.  For ``async_take`` this is the
  blocked window before the handle returns (the library's headline
  value prop); for a sync ``take`` it is the whole call.
- **durability lag** (``goodput.durability_lag_s``) — last
  take-begin → durable-commit interval: it ends when the
  ``.snapshot_metadata`` marker lands (for ``async_take``, on the
  background commit thread).
- **checkpoint overhead fraction** (``goodput.overhead_fraction``) —
  cumulative blocked seconds divided by wall time since the first take
  began: the fraction of the training run spent NOT training because of
  checkpointing (the goodput loss attributable to this library).

State is keyed by snapshot path so overlapping async takes to distinct
steps account independently; all updates are lock-guarded (take and
async-commit threads both report here).  A flight record is
written BEFORE its own take's durable commit, so the record's
``durability_lag_s`` describes the most recent COMPLETED commit —
step-over-step inspection is exactly what ``doctor --diff`` is for.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from .metrics import (
    GOODPUT_DURABILITY_LAG_S,
    GOODPUT_OVERHEAD_FRACTION,
    GOODPUT_TIME_TO_UNBLOCK_S,
    gauge,
)

_lock = threading.Lock()
# path -> monotonic begin timestamp of the most recent take of it.
# Bounded: durable_commit pops its entry, and takes whose commit never
# arrives (aborted, crashed promoter) are evicted oldest-first past the
# cap — a per-step SnapshotManager must not leak one entry per
# checkpoint for the life of the process.
_begin_ts: Dict[str, float] = {}
_MAX_PENDING_BEGINS = 64


def _key(path: str) -> str:
    # normalize so "ck/" and "ck" land on one entry
    return str(path).rstrip("/")


# cumulative seconds the caller was blocked inside take()/async_take()
_blocked_total_s = 0.0
# monotonic timestamp of the FIRST take begin (overhead denominator)
_first_begin_ts: Optional[float] = None
_takes = 0
_durable_commits = 0
_last_unblock_s: Optional[float] = None
_last_durability_lag_s: Optional[float] = None


def take_begin(path: str) -> float:
    """A take of ``path`` is starting; returns the begin timestamp the
    caller hands back to ``take_unblocked``."""
    from .. import obs

    with obs.span("goodput/take_begin", path=path):
        now = time.monotonic()
        global _first_begin_ts, _takes
        with _lock:
            k = _key(path)
            # re-insert at the tail so eviction order tracks recency
            _begin_ts.pop(k, None)
            _begin_ts[k] = now
            while len(_begin_ts) > _MAX_PENDING_BEGINS:
                _begin_ts.pop(next(iter(_begin_ts)))
            if _first_begin_ts is None:
                _first_begin_ts = now
            _takes += 1
        return now


def take_unblocked(path: str, begin_ts: float) -> float:
    """The caller regained control (sync take returned / async_take
    handed back its handle): record time-to-unblock and fold the
    blocked window into the overhead fraction.  Returns the blocked
    seconds."""
    from .. import obs

    with obs.span("goodput/take_unblocked", path=path):
        now = time.monotonic()
        blocked = max(0.0, now - begin_ts)
        global _blocked_total_s, _last_unblock_s
        with _lock:
            _blocked_total_s += blocked
            _last_unblock_s = blocked
            first = _first_begin_ts
            total_blocked = _blocked_total_s
        gauge(GOODPUT_TIME_TO_UNBLOCK_S).set(blocked)
        if first is not None and now > first:
            gauge(GOODPUT_OVERHEAD_FRACTION).set(
                min(1.0, total_blocked / (now - first))
            )
        return blocked


def durable_commit(path: str) -> Optional[float]:
    """The durable ``.snapshot_metadata`` marker for ``path`` landed
    (sync or async commit):
    record the end-to-end durability lag.  Returns the lag, or None
    when no begin was recorded for the path in this process (e.g. a
    recovery re-promotion of a pre-crash take)."""
    from .. import obs

    with obs.span("goodput/durable_commit", path=path):
        now = time.monotonic()
        global _durable_commits, _last_durability_lag_s
        with _lock:
            # pop, not get: the committed entry's job is done (and the
            # dict stays bounded over a long per-step training run)
            begin = _begin_ts.pop(_key(path), None)
            _durable_commits += 1
            if begin is None:
                return None
            lag = max(0.0, now - begin)
            _last_durability_lag_s = lag
        gauge(GOODPUT_DURABILITY_LAG_S).set(lag)
        return lag


def block() -> Dict[str, Any]:
    """JSON-safe goodput block for flight records."""
    with _lock:
        first = _first_begin_ts
        out: Dict[str, Any] = {
            "takes": _takes,
            "durable_commits": _durable_commits,
            "time_to_unblock_s": (
                round(_last_unblock_s, 6)
                if _last_unblock_s is not None
                else None
            ),
            "durability_lag_s": (
                round(_last_durability_lag_s, 6)
                if _last_durability_lag_s is not None
                else None
            ),
            "blocked_total_s": round(_blocked_total_s, 6),
        }
    now = time.monotonic()
    out["overhead_fraction"] = (
        round(
            min(1.0, out["blocked_total_s"] / (now - first)), 6
        )
        if first is not None and now > first
        else None
    )
    return out


def reset() -> None:
    """Zero the tracker (tests; the metrics-registry gauges reset
    separately via ``obs.reset_metrics``)."""
    global _blocked_total_s, _first_begin_ts, _takes
    global _durable_commits, _last_unblock_s, _last_durability_lag_s
    with _lock:
        _begin_ts.clear()
        _blocked_total_s = 0.0
        _first_begin_ts = None
        _takes = 0
        _durable_commits = 0
        _last_unblock_s = None
        _last_durability_lag_s = None
