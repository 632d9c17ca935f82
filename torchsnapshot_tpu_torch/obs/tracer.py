"""In-process structured tracing: a span tree with monotonic timestamps.

Counterpart of ``torchsnapshot_tpu/obs/tracer.py``, the same spans,
parents and export.  Spans are host wall time: a span around a CUDA
launch closes when the launch returns, not when the kernel ends, unless
the code inside it waits on the kernel's event.

Spans record where a ``take()``/``restore()`` spent its time: each span
carries monotonic start/end (ns), free-form attributes, its recording
thread and (when applicable) asyncio task identity, and a parent link so
exports can reconstruct the tree.  Parenthood propagates through a
``contextvars.ContextVar``, which is the one mechanism that is correct
across BOTH threads (each thread has its own context) and asyncio tasks
(each task snapshots the context at creation) — exactly the two
execution domains the scheduler pipeline spans (caller thread, staging
executor threads, loop-thread tasks).

Cost discipline: tracing is OFF by default and the disabled path is
allocation-free — ``span()`` checks the module-level ``ENABLED`` flag
and returns one shared ``nullcontext`` singleton before any Span object,
attrs dict copy, or clock read happens.  The flag is owned by the
``TORCHSNAPSHOT_TPU_TORCH_TRACE`` knob (knobs.py); ``knobs.override_trace``
refreshes it so tests can toggle tracing without touching this module.

Completed spans also feed the existing ``log_event`` fan-out: when any
event handler is registered, each finished span fires an
``Event("span/<name>")`` through the same handler chain, so existing
telemetry collectors see span-level detail without a second
registration API.  (Spans created BY ``log_event``'s own bracketing are
excluded — the original event already fired for those.)
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from contextvars import ContextVar
from typing import Any, Dict, Iterator, List, Optional

from .. import knobs

# Shared disabled-path singleton: ``span()`` returns this before any
# allocation when tracing is off.
NULL_CM = contextlib.nullcontext(None)

# Module-level enabled flag — read directly (``tracer.ENABLED``) by hot
# paths that want to skip even the ``span()`` call's argument packing.
ENABLED = False

_ids = itertools.count(1)
_flow_ids = itertools.count(1)
_current: ContextVar[Optional["Span"]] = ContextVar("tsnp_span", default=None)

# Bound the recorded-span list: a runaway traced loop must degrade to
# dropped spans, never to unbounded host memory.
_MAX_SPANS = 200_000


class Span:
    """One timed operation.  ``start_ns``/``end_ns`` are
    ``time.monotonic_ns`` values; ``end_ns`` is 0 until the span closes."""

    __slots__ = (
        "name",
        "span_id",
        "parent_id",
        "start_ns",
        "end_ns",
        "attrs",
        "thread_id",
        "thread_name",
        "task_name",
        "flow_in",
        "flow_out",
    )

    def __init__(
        self,
        name: str,
        parent_id: Optional[int],
        attrs: Dict[str, Any],
    ) -> None:
        self.name = name
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.attrs = attrs
        self.start_ns = 0
        self.end_ns = 0
        t = threading.current_thread()
        self.thread_id = t.ident or 0
        self.thread_name = t.name
        self.task_name = _current_task_name()
        # Perfetto flow (async arrow) endpoints: ``flow_out`` emits an
        # arrow start at this span's END, ``flow_in`` an arrow end at
        # this span's START.  The scheduler links staging completion to
        # storage-I/O start this way.
        self.flow_in: Optional[int] = None
        self.flow_out: Optional[int] = None

    @property
    def duration_ns(self) -> int:
        return max(0, self.end_ns - self.start_ns)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "thread_id": self.thread_id,
            "thread_name": self.thread_name,
            "task_name": self.task_name,
            "flow_in": self.flow_in,
            "flow_out": self.flow_out,
            "attrs": dict(self.attrs),
        }


def _current_task_name() -> Optional[str]:
    try:
        import asyncio

        task = asyncio.current_task()
    except RuntimeError:  # no running event loop on this thread
        return None
    return task.get_name() if task is not None else None


class Tracer:
    """Lock-protected recorder of finished spans.

    ``begin``/``end`` exist for spans whose lifetime crosses loop
    iterations (e.g. budget-admission waits); the ``span()`` context
    manager is the ergonomic path for lexically-scoped spans and is the
    only one that establishes parenthood for code nested under it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self.dropped = 0

    # ----------------------------------------------------------- record

    def begin(
        self, name: str, parent: Optional[Span] = None, **attrs: Any
    ) -> Span:
        """Open a span WITHOUT making it the context parent (it can be
        closed from any thread/task via ``end``)."""
        if parent is None:
            parent = _current.get()
        s = Span(name, parent.span_id if parent else None, attrs)
        s.start_ns = time.monotonic_ns()
        return s

    def end(self, s: Span, fire_event: bool = False) -> None:
        if s.end_ns:  # already closed — idempotent
            return
        s.end_ns = time.monotonic_ns()
        self._record(s)
        if fire_event:
            _fire_span_event(s)

    def _record(self, s: Span) -> None:
        with self._lock:
            if len(self._spans) >= _MAX_SPANS:
                self.dropped += 1
                return
            self._spans.append(s)

    # ---------------------------------------------------------- inspect

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def current_span() -> Optional[Span]:
    return _current.get()


def next_flow_id() -> int:
    return next(_flow_ids)


# ------------------------------------------------------------- enabling


def tracing_enabled() -> bool:
    return ENABLED


def set_tracing(on: bool) -> None:
    global ENABLED
    ENABLED = bool(on)


def refresh_enabled() -> bool:
    """Re-resolve the ``TORCHSNAPSHOT_TPU_TORCH_TRACE`` knob into the module
    flag (called by ``knobs.override_trace`` and at import)."""
    set_tracing(knobs.is_trace_enabled())
    return ENABLED


refresh_enabled()


# ----------------------------------------------------------------- span


def span(name: str, fire_event: bool = True, **attrs: Any):
    """Context manager recording one span, or a shared no-op when
    tracing is disabled.  Yields the ``Span`` (None when disabled) so
    callers can attach late attributes (``s.attrs["bytes"] = n``)."""
    if not ENABLED:
        return NULL_CM
    return _span_cm(name, fire_event, attrs)


@contextlib.contextmanager
def _span_cm(
    name: str, fire_event: bool, attrs: Dict[str, Any]
) -> Iterator[Span]:
    parent = _current.get()
    s = Span(name, parent.span_id if parent else None, attrs)
    token = _current.set(s)
    s.start_ns = time.monotonic_ns()
    try:
        yield s
    except BaseException:
        s.attrs["error"] = True
        raise
    finally:
        s.end_ns = time.monotonic_ns()
        _current.reset(token)
        _TRACER._record(s)
        if fire_event:
            _fire_span_event(s)


def _fire_span_event(s: Span) -> None:
    """Feed the finished span into the event-handler fan-out (lazy
    import: event_handlers composes with this module in both
    directions)."""
    from .. import event_handlers

    # entry-point discovery must run before the emptiness check, or a
    # collector registered solely via the entry-point group would miss
    # every span of the first traced operation (discovery is cached, so
    # this is one flag check per span after the first)
    event_handlers._load_entry_point_handlers()
    if not (
        event_handlers._handlers or event_handlers._entry_point_handlers
    ):
        return
    from ..event import Event

    event_handlers._fire(
        Event(
            f"span/{s.name}",
            {
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "duration_s": s.duration_ns / 1e9,
                **s.attrs,
            },
        )
    )
