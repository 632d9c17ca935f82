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
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .tracer import Span, Tracer, get_tracer

# Span-name prefixes that get one track per NAME (the pipeline stages);
# anything else is tracked by its recording thread.  ``stripe/`` is
# here so per-PART slices (stripe/stage_part, stripe/write_part) land
# on stage tracks with interval partitioning — on thread tracks the
# concurrent parts of one object would violate complete-event nesting
# and striped pipelining would be invisible.
_STAGE_PREFIXES = ("pipeline/", "storage/", "offload/", "stripe/")


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
