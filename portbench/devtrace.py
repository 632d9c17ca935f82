"""The device trace of a traced run: ``torch.profiler`` over the measured
window, exported as a Chrome trace under the checkout's ``build/``, and
reduced to busy seconds, kernel seconds by name, the device operations
that took most time and the idle time by what the harness was doing.

The harness records its own calls as ``Spans`` named ``pb/...``, on the
host clock and, in a traced run, as ``record_function`` marks too;
``pb/window`` spans the measured window and ties the two clocks.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .stats import busy_seconds, gaps, union

WINDOW = "pb/window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LABELLED_GAPS = 2000


class Spans:
    """The harness's own spans on the host clock (``time.perf_counter``),
    from every thread; in a traced run each is also a ``record_function``
    in the profiler's trace."""

    def __init__(self, traced: bool) -> None:
        self.traced = traced
        self.spans: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            from torch.profiler import record_function

            cm = record_function(name)
        else:
            cm = contextlib.nullcontext()
        with cm:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.spans.append((name, t0, t1))


@contextlib.contextmanager
def profiled(path: str):
    """Profile host and device activity in the block and write the trace
    to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, substring: str) -> float:
        return sum(s for name, s in self.kernel_s.items() if substring in name)


def reduce(events: List[dict], spans: Sequence[Tuple[str, float, float]] = ()) -> Optional[Trace]:
    """The trace of the ``pb/window`` span in Chrome trace ``events``
    (times in microseconds); None when the span is missing.  Idle time
    is named by the innermost of the harness's host-clock ``spans``
    (``Spans.spans``, the window's among them) around each idle
    stretch's midpoint: the longest stretches one by one, the rest as
    ``pb/short_gaps``."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    lo = windows[0]["ts"]
    hi = lo + windows[0]["dur"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATEGORIES]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    by_name: Dict[str, float] = defaultdict(float)
    kernel_s: Dict[str, float] = defaultdict(float)
    for e in device:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        by_name[e["name"]] += (b - a) / 1e6
        if e["cat"] == "kernel":
            kernel_s[e["name"]] += (b - a) / 1e6
    # host spans onto the trace's clock, by the window's start on both
    host_window = [s for s in spans if s[0] == WINDOW]
    offset = lo - 1e6 * host_window[0][1] if host_window else 0.0
    marks = sorted(
        ((n, offset + 1e6 * a, offset + 1e6 * b) for n, a, b in spans if n != WINDOW),
        key=lambda m: m[2] - m[1],
    )
    starts = np.array([m[1] for m in marks], dtype=np.float64)
    ends = np.array([m[2] for m in marks], dtype=np.float64)
    idle: Dict[str, float] = defaultdict(float)
    stretches = sorted(gaps(union(intervals, lo, hi), lo, hi), key=lambda g: g[0] - g[1])
    for i, (a, b) in enumerate(stretches):
        label = "pb/short_gaps"
        if i < LABELLED_GAPS:
            mid = (a + b) / 2
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            label = marks[inside[0]][0] if inside.size else "pb/other"
        idle[label] += (b - a) / 1e6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return Trace(
        window_s=(hi - lo) / 1e6,
        busy_s=busy_seconds(intervals, lo, hi) / 1e6,
        kernel_s=dict(kernel_s),
        device_ops=[[n[:120], s] for n, s in top(by_name)],
        idle_gaps=[[n, s] for n, s in top(idle)],
    )


def load(path: str, spans: Sequence[Tuple[str, float, float]] = ()) -> Optional[Trace]:
    with open(path) as f:
        doc = json.load(f)
    return reduce(doc.get("traceEvents", []) if isinstance(doc, dict) else doc, spans)
