"""The arithmetic of the yardstick: a window of operations, rates,
percentiles, spreads, and the busy share of a device timeline."""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple


@dataclass
class Op:
    """One operation of a measured window, on the host clock (seconds).
    ``t_unblock`` is when the call returned to its caller (an
    ``async_take``'s return); ``t_end`` when its result was complete."""

    t_start: float
    t_unblock: float
    t_end: float
    nbytes: int
    ok: bool = True


@dataclass
class Window:
    """Operations issued between ``t_start`` and the deadline; the
    window ends when the last of them completed (``t_end``)."""

    t_start: float
    t_end: float = 0.0
    ops: List[Op] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    @property
    def done(self) -> List[Op]:
        return [o for o in self.ops if o.ok]

    @property
    def failed(self) -> int:
        return sum(1 for o in self.ops if not o.ok)


def rate_gbps(window: Window) -> Optional[float]:
    """Bytes of every completed operation ÷ the window's seconds, in GB/s
    (10**9 bytes)."""
    if not window.done or window.seconds <= 0:
        return None
    return sum(o.nbytes for o in window.done) / window.seconds / 1e9


def mean_unblock_ms(window: Window) -> Optional[float]:
    """Mean of the seconds each call held its caller, in ms."""
    held = [o.t_unblock - o.t_start for o in window.done]
    return 1e3 * sum(held) / len(held) if held else None


def median_unblock_ms(window: Window) -> Optional[float]:
    """Median of the seconds each call held its caller, in ms."""
    return percentile([1e3 * (o.t_unblock - o.t_start) for o in window.done], 50.0)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks, over every value given."""
    if not values:
        return None
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latency_p95_ms(window: Window) -> Optional[float]:
    return percentile([1e3 * (o.t_end - o.t_start) for o in window.done], 95.0)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles, as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    merged: List[Tuple[float, float]] = []
    for a, b in clipped:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def busy_seconds(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    return sum(b - a for a, b in union(intervals, lo, hi))


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi] between sorted disjoint ``busy`` ones."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def roofline_pct(nbytes: int, seconds: float, bytes_per_s: float) -> Optional[float]:
    """The least time the bytes need at the peak rate, as a share of the
    time the kernel took."""
    if nbytes <= 0 or seconds <= 0:
        return None
    return 100.0 * (nbytes / bytes_per_s) / seconds
