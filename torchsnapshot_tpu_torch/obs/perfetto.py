"""Perfetto / Chrome ``trace_event`` JSON export for recorded spans.

Counterpart of ``torchsnapshot_tpu/obs/perfetto.py`` (the same events for
the same spans).
The output loads directly in https://ui.perfetto.dev (or
chrome://tracing): one named track per pipeline stage (``pipeline/…``,
``storage/…`` spans are grouped by span name), one track per remaining
Python thread, and flow arrows ("s"/"f" events) linking staging
completion to storage-I/O start via the spans' ``flow_out``/``flow_in``
ids.

Complete ("X") events on one tid must be properly nested, but a stage's
spans are concurrent siblings (several staging ops in flight at once),
so each stage track is interval-partitioned: overlapping same-stage
spans spill onto ``<stage> #2``, ``#3``… tracks.  Same-name stage spans
never nest (they are independent pipeline items), and thread tracks
carry only synchronous — properly nested — spans, so the remaining
single-track cases are well-formed.

Each "X" (complete) event carries ``span_id``/``parent_id`` in ``args``
so the span TREE survives the export — tests (and humans) can check
nesting without re-deriving it from timestamps.

``merge_into`` writes the same events into a torch profiler Chrome
trace, on that trace's clock, beside the device's kernels and copies.
The profiler records ``record_function`` marks only on the thread that
started the profiler, while staging, consuming and ``async_take``'s background
loop run on worker threads: the spans are written after the run.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .tracer import Span, Tracer, clock_on, clock_pair, get_tracer

# Span-name prefixes that get one track per NAME (the pipeline stages);
# anything else is tracked by its recording thread.  ``stripe/`` is
# here so per-PART slices (stripe/stage_part, stripe/write_part) land
# on stage tracks with interval partitioning — on thread tracks the
# concurrent parts of one object would violate complete-event nesting
# and striped pipelining would be invisible.  The sub-phase clocks'
# leaf spans (``stage/``, ``write/``, ``consume/``, ``read/``) overlap
# the same way: ``stage/queue`` opens on the loop thread per submit.
_STAGE_PREFIXES = (
    "pipeline/", "storage/", "offload/", "stripe/", "stage/", "write/", "consume/", "read/",
)


def _track_key(s: Span) -> str:
    for prefix in _STAGE_PREFIXES:
        if s.name.startswith(prefix):
            return s.name
    return f"thread:{s.thread_name}"


def to_trace_events(spans: List[Span], pid: int = 1) -> Dict[str, Any]:
    """Build the ``{"traceEvents": [...]}`` dict for ``spans``."""
    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}

    def tid_for(key: str) -> int:
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = len(tids) + 1
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": key},
                }
            )
        return tid

    slot_ends: Dict[str, List[int]] = {}
    # Slot cap per stage: admission spans all open at pipeline start, so
    # unbounded partitioning would mint one track per request (and an
    # O(n^2) scan) on a 10k-leaf take.  Past the cap, the earliest-
    # ending slot is reused — a rare, slightly-overlapping slice beats
    # ten thousand tracks.
    _MAX_SLOTS = 32

    def _slotted_track(s: Span, key: str) -> str:
        """First stage-track slot whose previous span ended before this
        one starts (greedy interval partitioning, bounded); overlapping
        siblings spill onto numbered sibling tracks."""
        ends = slot_ends.setdefault(key, [])
        for i, end in enumerate(ends):
            if s.start_ns >= end:
                ends[i] = s.end_ns
                return key if i == 0 else f"{key} #{i + 1}"
        if len(ends) >= _MAX_SLOTS:
            i = min(range(len(ends)), key=ends.__getitem__)
            ends[i] = max(ends[i], s.end_ns)
            return key if i == 0 else f"{key} #{i + 1}"
        ends.append(s.end_ns)
        slot = len(ends) - 1
        return key if slot == 0 else f"{key} #{slot + 1}"

    for s in sorted(spans, key=lambda s: s.start_ns):
        if not s.end_ns:
            continue  # never closed (crashed mid-span): skip
        key = _track_key(s)
        if key.startswith(_STAGE_PREFIXES):
            key = _slotted_track(s, key)
        tid = tid_for(key)
        ts = s.start_ns / 1000.0  # trace_event timestamps are µs
        dur = s.duration_ns / 1000.0
        events.append(
            {
                "ph": "X",
                "name": s.name,
                "cat": s.name.split("/", 1)[0],
                "pid": pid,
                "tid": tid,
                "ts": ts,
                "dur": dur,
                "args": {
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "thread": s.thread_name,
                    **({"task": s.task_name} if s.task_name else {}),
                    **s.attrs,
                },
            }
        )
        # Flow arrows: staging completion -> I/O start.  The start step
        # anchors at this span's END, the finish step (binding point
        # "e" = enclosing slice) at the consuming span's START.
        if s.flow_out is not None:
            events.append(
                {
                    "ph": "s",
                    "cat": "flow",
                    "name": "staged→io",
                    "id": s.flow_out,
                    "pid": pid,
                    "tid": tid,
                    "ts": ts + dur,
                }
            )
        if s.flow_in is not None:
            events.append(
                {
                    "ph": "f",
                    "bp": "e",
                    "cat": "flow",
                    "name": "staged→io",
                    "id": s.flow_in,
                    "pid": pid,
                    "tid": tid,
                    "ts": ts,
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(path: str, tracer: Optional[Tracer] = None) -> int:
    """Write the tracer's recorded spans as Perfetto JSON; returns the
    number of spans exported."""
    tracer = tracer or get_tracer()
    spans = tracer.spans()
    doc = to_trace_events(spans)
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for s in spans if s.end_ns)


# what a torch profiler trace counts as device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SPAN = "(no span)"


def _wall_clock_rate(first: Optional[Tuple[int, int]], now: Tuple[int, int]) -> float:
    """Wall-clock ns per monotonic ns between the clock pairs ``first``
    and ``now``: 1 without an earlier pair."""
    if first is None or now[0] <= first[0]:
        return 1.0
    return (now[1] - first[1]) / (now[0] - first[0])


def _idle_by_span(
    device: List[Tuple[float, float]], marks: List[Tuple[str, float, float]],
    lo: float, hi: float,
) -> Dict[str, float]:
    """Seconds of [lo, hi] (µs) that no ``device`` interval covers, each
    idle stretch named by the shortest of ``marks`` around its midpoint."""
    stretches = []
    t = lo
    for a, b in sorted(device):
        if a > t:
            stretches.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        stretches.append((t, hi))
    marks = sorted(marks, key=lambda m: m[2] - m[1])  # innermost first
    starts = np.array([m[1] for m in marks])
    ends = np.array([m[2] for m in marks])
    idle: Dict[str, float] = {}
    for a, b in stretches:
        mid = (a + b) / 2
        inside = (starts <= mid) & (ends >= mid)
        i = int(inside.argmax())
        label = marks[i][0] if inside[i] else NO_SPAN
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def merge_into(chrome_trace_path: str, spans: Optional[List[Span]] = None) -> Dict[str, float]:
    """Write ``spans`` (default: the tracer's) into the torch profiler
    Chrome trace at ``chrome_trace_path``, on its clock, under a process
    of their own and on the tracks ``to_trace_events`` lays out; returns
    the device's idle seconds by innermost span, largest first.

    The trace stamps ``ts`` in µs of the wall clock less its
    ``baseTimeNanoseconds``.  A span's ``monotonic_ns`` stamps map onto
    the wall clock by interpolating between the clock pair read when
    tracing turned on and one read now.  Idle time is the part of the
    window (where the spans and the trace's events both lie) that no
    device event (``DEVICE_CATEGORIES``) covers; each idle stretch is
    named by the shortest closed span around its midpoint, or
    ``NO_SPAN``."""
    if spans is None:
        spans = get_tracer().spans()
    with open(chrome_trace_path) as f:
        doc = json.load(f)
    if isinstance(doc, list):
        doc = {"traceEvents": doc}
    events: List[Dict[str, Any]] = doc.setdefault("traceEvents", [])
    base_ns = int(doc.get("baseTimeNanoseconds", 0))
    mono_now, wall_now = clock_pair()
    rate = _wall_clock_rate(clock_on(), (mono_now, wall_now))
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in xs if e.get("cat") in DEVICE_CATEGORIES]
    ours = to_trace_events(spans, pid)["traceEvents"]
    marks = []
    for e in ours:
        if "ts" in e:
            # to_trace_events stamps µs of the monotonic clock
            e["ts"] = (wall_now - base_ns + (e["ts"] * 1e3 - mono_now) * rate) / 1e3
        if e["ph"] == "X":
            e["dur"] *= rate
            marks.append((e["name"], e["ts"], e["ts"] + e["dur"]))
    events.append(
        {"ph": "M", "name": "process_name", "pid": pid, "args": {"name": "torchsnapshot_tpu_torch"}}
    )
    events.extend(ours)
    with open(chrome_trace_path, "w") as f:
        json.dump(doc, f)
    if not marks:
        return {}
    lo = min(m[1] for m in marks)
    hi = max(m[2] for m in marks)
    if xs:
        lo = max(lo, min(e["ts"] for e in xs))
        hi = min(hi, max(e["ts"] + e["dur"] for e in xs))
    return _idle_by_span(device, marks, lo, hi) if hi > lo else {}
