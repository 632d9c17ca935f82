"""Event fan-out to registered handlers.

Counterpart of ``torchsnapshot_tpu/event_handlers.py``: every public API
call is bracketed with an event carrying a unique id, duration and
success flag.  Entry-point discovery of handlers is not ported yet.
"""

from __future__ import annotations

import contextlib
import logging
import time
import uuid
from typing import Callable, Iterator, List

from . import obs
from .event import Event

logger = logging.getLogger(__name__)

_handlers: List[Callable[[Event], None]] = []


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


def _fire(event: Event) -> None:
    if event.timestamp is None:
        event.timestamp = time.monotonic()
    for handler in list(_handlers):
        try:
            handler(event)
        except Exception:
            logger.exception("event handler raised for %r", event.name)
            obs.counter(obs.EVENT_HANDLER_ERRORS).inc()


@contextlib.contextmanager
def log_event(event: Event) -> Iterator[Event]:
    """Bracket an operation: fires the event on exit with a monotonic
    timestamp, unique_id, duration and is_success attached."""
    event.metadata.setdefault("unique_id", uuid.uuid4().hex)
    begin = time.monotonic()
    with obs.span(event.name):
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
