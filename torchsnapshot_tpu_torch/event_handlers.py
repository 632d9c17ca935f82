"""Event fan-out: registered handlers + entry-point discovery.

Counterpart of ``torchsnapshot_tpu/event_handlers.py``: every public API
call is bracketed with an event carrying a unique id, duration and
success flag.  Handlers are registered directly or discovered under the
entry-point group ``torchsnapshot_tpu_torch.event_handlers``.
"""

from __future__ import annotations

import contextlib
import logging
import time
import uuid
from typing import Callable, Iterator, List

from .event import Event

# module-level on purpose: these run inside `except` blocks, where a
# lazy import could itself raise during interpreter teardown and
# escape into the operation being observed (obs never imports this
# module at import time, so no cycle)
from .obs import swallowed_exception
from .obs.metrics import EVENT_HANDLER_ERRORS, counter

logger = logging.getLogger(__name__)

_ENTRY_POINT_GROUP = "torchsnapshot_tpu_torch.event_handlers"
_handlers: List[Callable[[Event], None]] = []
_entry_point_handlers: List[Callable[[Event], None]] = []
_entry_points_loaded = False


def register_event_handler(handler: Callable[[Event], None]) -> None:
    _handlers.append(handler)


def unregister_event_handler(handler: Callable[[Event], None]) -> None:
    try:
        _handlers.remove(handler)
    except ValueError:
        raise ValueError(
            f"cannot unregister event handler {handler!r}: it was never "
            f"registered (or was already unregistered)"
        ) from None


def _load_entry_point_handlers() -> None:
    global _entry_points_loaded
    if _entry_points_loaded:
        return
    _entry_points_loaded = True
    try:
        from importlib.metadata import entry_points

        eps = entry_points()
        group = (
            eps.select(group=_ENTRY_POINT_GROUP)
            if hasattr(eps, "select")
            else eps.get(_ENTRY_POINT_GROUP, [])
        )
        for ep in group:
            try:
                _entry_point_handlers.append(ep.load())
            except Exception:
                logger.exception("failed to load event handler %r", ep.name)
    except Exception as e:
        # no importlib.metadata / broken distribution metadata: events
        # still fire to directly-registered handlers — but leave a
        # trace, a silently-skipped discovery would read as "my
        # entry-point collector never sees events" with zero evidence
        swallowed_exception("event_handlers.entry_point_discovery", e)


def _fire(event: Event) -> None:
    _load_entry_point_handlers()
    if event.timestamp is None:
        event.timestamp = time.monotonic()
    for handler in _handlers + _entry_point_handlers:
        try:
            handler(event)
        except Exception:
            # log first: telemetry accounting must never displace the
            # primary evidence if the inc itself misbehaves
            logger.exception("event handler raised for %r", event.name)
            counter(EVENT_HANDLER_ERRORS).inc()


def _obs_span_cm(event: Event):
    """A tracer span bracketing the event's operation when tracing is
    enabled, else the shared no-op (lazy import: obs.tracer fires span
    events back through this module)."""
    from .obs import tracer as _tracer

    if not _tracer.ENABLED:
        return _tracer.NULL_CM
    # fire_event=False: the event itself fires below — a span/<name>
    # echo of the same bracket would double every telemetry record
    return _tracer.span(event.name, fire_event=False)


@contextlib.contextmanager
def log_event(event: Event) -> Iterator[Event]:
    """Bracket an operation: fires the event on exit with a monotonic
    timestamp, unique_id, duration and is_success attached.  When span
    tracing is enabled, the bracket also records a span of the same
    name, so top-level API events appear in Perfetto traces."""
    event.metadata.setdefault("unique_id", uuid.uuid4().hex)
    begin = time.monotonic()
    with _obs_span_cm(event):
        try:
            yield event
            event.metadata["is_success"] = True
        except BaseException:
            event.metadata["is_success"] = False
            raise
        finally:
            event.timestamp = time.monotonic()
            event.metadata["duration_s"] = event.timestamp - begin
            _fire(event)
