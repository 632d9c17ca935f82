"""The preemption-notice hook: SIGTERM → bounded drain → exit as before.

Counterpart of ``torchsnapshot_tpu/resilience/preemption.py``, with this
module's own state (lock, drains, previous handler), so both packages'
hooks may sit in one process.  Preemptible fleets send a termination
notice (SIGTERM) a grace window before the kill; what this library then
holds only in RAM is the continuous loop's in-flight replication
(``continuous/loop.py``), one bounded flush away from a peer host:

1. ``on_preemption(drain)`` registers ``drain(deadline_monotonic)`` and,
   on first use from the main thread, installs the SIGTERM handler
   (Python refuses signal handlers on other threads: registration still
   works there, and ``notify_preemption()`` runs the drains without a
   signal, for tests and for orchestrators that send notices over an
   API).
2. On SIGTERM every registered drain runs under ONE deadline,
   ``CONTINUOUS_GRACE_S`` from now: a drain that overruns spends the
   rest of the window, not a sibling's.  Drain errors are swallowed and
   counted (a drain bug must not turn a clean preemption into a hang);
   ``continuous.preemption_drains`` counts the drains that completed.
3. The signal is then delivered again through the handler installed
   before ours (the default disposition included), so the process dies
   a normal SIGTERM death.
"""

from __future__ import annotations

import itertools
import logging
import os
import signal
import threading
import time
from typing import Callable, Dict, Optional

from .. import knobs, obs

logger = logging.getLogger(__name__)

# reentrant: the handler runs ON the main thread, possibly while main-
# thread code (on_preemption, remove_handler, uninstall) holds the lock
_LOCK = threading.RLock()
_DRAINS: Dict[int, Callable[[float], None]] = {}
_IDS = itertools.count(1)
_PREV_HANDLER: Optional[object] = None
_INSTALLED = False
_REQUESTED = threading.Event()


def preemption_requested() -> bool:
    """True once this process saw a preemption notice (a training loop
    may poll it to stop scheduling steps)."""
    return _REQUESTED.is_set()


def on_preemption(drain: Callable[[float], None]) -> int:
    """Register ``drain(deadline)`` for the grace window; returns the
    handle ``remove_handler`` takes.  Installs the SIGTERM handler on
    first use from the main thread; elsewhere the drain still runs under
    ``notify_preemption()`` and a warning says so."""
    global _INSTALLED, _PREV_HANDLER
    with _LOCK:
        handle = next(_IDS)
        _DRAINS[handle] = drain
        need_install = not _INSTALLED
    if need_install:
        try:
            prev = signal.signal(signal.SIGTERM, _sigterm_handler)
            with _LOCK:
                _PREV_HANDLER = prev
                _INSTALLED = True
        except ValueError as e:
            logger.warning(
                "cannot install the SIGTERM preemption handler off the main thread (%r); "
                "call notify_preemption() from your own notice watcher", e,
            )
    return handle


def remove_handler(handle: int) -> None:
    with _LOCK:
        _DRAINS.pop(handle, None)


def uninstall() -> None:
    """Restore the SIGTERM disposition from before the hook and drop
    every registered drain."""
    global _INSTALLED, _PREV_HANDLER
    with _LOCK:
        prev = _PREV_HANDLER
        installed = _INSTALLED
        _DRAINS.clear()
        _PREV_HANDLER = None
        _INSTALLED = False
        _REQUESTED.clear()
    if installed:
        try:
            signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
        except (ValueError, TypeError) as e:
            logger.warning("could not restore the SIGTERM handler: %r", e)


def notify_preemption(grace_s: Optional[float] = None) -> int:
    """Run every registered drain under one grace deadline (the entry
    point without a signal).  Returns the number of drains that
    completed without raising."""
    _REQUESTED.set()
    grace = knobs.get_continuous_grace_s() if grace_s is None else grace_s
    deadline = time.monotonic() + grace
    with _LOCK:
        drains = list(_DRAINS.values())
    completed = 0
    with obs.span("resilience/preemption_drain", drains=len(drains), grace_s=grace):
        for drain in drains:
            try:
                drain(deadline)
                completed += 1
            except Exception as e:  # noqa: BLE001 — a drain bug must not hang or crash the exit
                obs.swallowed_exception("resilience.preemption_drain", e)
    if completed:
        obs.counter(obs.CONTINUOUS_PREEMPTION_DRAINS).inc(completed)
    return completed


def _sigterm_handler(signum, frame) -> None:
    logger.warning(
        "SIGTERM preemption notice: draining in-flight work inside a %.1f s grace window",
        knobs.get_continuous_grace_s(),
    )
    notify_preemption()
    # deliver again through the disposition from before the hook
    with _LOCK:
        prev = _PREV_HANDLER
    if callable(prev):
        prev(signum, frame)
        return
    if prev is signal.SIG_IGN:
        return
    try:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    except ValueError:
        # off the main thread (an embedder's): exit with SIGTERM's status
        os._exit(128 + int(signum))
    os.kill(os.getpid(), signal.SIGTERM)
