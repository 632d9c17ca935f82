"""Per-backend circuit breaker: fail fast while a backend is down.

Counterpart of ``torchsnapshot_tpu/resilience/breaker.py``, fed by the
retry engine (``retry.py``) with completed outcomes only (an operation
that recovered on a retry is a success):

- **closed**: normal; consecutive failures are counted;
- **open**: ``BREAKER_THRESHOLD`` consecutive failures tripped it;
  ``check()`` raises ``CircuitOpenError`` at once until
  ``BREAKER_COOLDOWN_S`` has passed;
- **half-open**: after the cooldown one probe goes through; its success
  closes the breaker, its failure opens it again.

Nothing here waits: an open breaker raises, it never blocks.  The state
is the gauge ``resilience.breaker_state.<name>`` (0 closed, 1 half-open,
2 open); trips count in ``resilience.breaker_trips``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from .. import knobs, obs

logger = logging.getLogger(__name__)

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

_STATE_GAUGE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitOpenError(OSError):
    """The backend's breaker is open.  An ``OSError``, so the callers'
    I/O error handling treats it as the failure it stands in for."""

    def __init__(self, name: str, op_name: str, retry_in_s: float) -> None:
        super().__init__(
            f"circuit breaker for {name!r} is open ({op_name}): backend "
            f"failing consecutively; next probe allowed in "
            f"{max(0.0, retry_in_s):.1f}s"
        )
        self.breaker_name = name


class CircuitBreaker:
    def __init__(
        self, name: str, threshold: Optional[int] = None, cooldown_s: Optional[float] = None
    ) -> None:
        self.name = name
        self._threshold = threshold
        self._cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._state = CLOSED
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._gauge = obs.gauge(f"resilience.breaker_state.{name}")
        self._gauge.set(0)

    # read from the knobs on every use, so test overrides apply mid-life
    @property
    def threshold(self) -> int:
        return knobs.get_breaker_threshold() if self._threshold is None else self._threshold

    @property
    def cooldown_s(self) -> float:
        return knobs.get_breaker_cooldown_s() if self._cooldown_s is None else self._cooldown_s

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:
        # lock held: an open breaker past its cooldown is half-open
        if self._state == OPEN and time.monotonic() - self._opened_at >= self.cooldown_s:
            self._state = HALF_OPEN
            self._probe_in_flight = False
            self._gauge.set(_STATE_GAUGE_VALUES[HALF_OPEN])
        return self._state

    def allow(self) -> bool:
        """Whether an operation may be issued now; half-open admits one
        probe until its outcome is recorded."""
        with self._lock:
            state = self._effective_state()
            if state == CLOSED:
                return True
            if state == OPEN or self._probe_in_flight:
                return False
            self._probe_in_flight = True
            return True

    def check(self, op_name: str = "") -> None:
        """``allow()`` or raise ``CircuitOpenError``."""
        if not self.allow():
            with self._lock:
                retry_in = self.cooldown_s - (time.monotonic() - self._opened_at)
            raise CircuitOpenError(self.name, op_name, retry_in)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            if self._state != CLOSED:
                logger.info("circuit breaker %r closed (probe succeeded)", self.name)
            self._state = CLOSED
            self._gauge.set(_STATE_GAUGE_VALUES[CLOSED])

    def release_probe(self) -> None:
        """The outcome said nothing about the backend's health (a genuine
        not-found): free the half-open probe slot."""
        with self._lock:
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            self._probe_in_flight = False
            self._consecutive_failures += 1
            failures = self._consecutive_failures
            tripped = self._state == HALF_OPEN or (
                self._state == CLOSED and failures >= self.threshold
            )
            if tripped:
                self._state = OPEN
                self._opened_at = time.monotonic()
                self._gauge.set(_STATE_GAUGE_VALUES[OPEN])
        if tripped:
            obs.counter(obs.RESILIENCE_BREAKER_TRIPS).inc()
            logger.warning(
                "circuit breaker %r tripped open after %d consecutive failure(s); "
                "failing fast for %.1fs", self.name, failures, self.cooldown_s,
            )

    def reset(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._state = CLOSED
            self._probe_in_flight = False
            self._gauge.set(0)


_REGISTRY: Dict[str, CircuitBreaker] = {}
_REGISTRY_LOCK = threading.Lock()


def get_breaker(name: str) -> CircuitBreaker:
    """The process-wide breaker of a backend, made on first use."""
    with _REGISTRY_LOCK:
        b = _REGISTRY.get(name)
        if b is None:
            b = _REGISTRY[name] = CircuitBreaker(name)
        return b


def reset_breakers() -> None:
    """Close every registered breaker (tests)."""
    with _REGISTRY_LOCK:
        breakers = list(_REGISTRY.values())
    for b in breakers:
        b.reset()
