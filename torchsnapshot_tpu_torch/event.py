"""Telemetry event type (reference torchsnapshot/event.py:15-27)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class Event:
    name: str
    metadata: Dict[str, Any] = field(default_factory=dict)
    # time.monotonic() stamped when the event fires (log_event / _fire):
    # handlers can order events by it instead of relying on arrival
    # order, which interleaves across threads
    timestamp: Optional[float] = None
