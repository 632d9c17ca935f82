"""Minimal observability: named spans and counters.

The take/restore path calls ``obs.span(name, **attrs)`` and
``obs.counter(name).inc()`` under the same names as
``torchsnapshot_tpu/obs``, so later tracing work can hang exporters on
them.  In this slice a span records its wall time into a per-name total
(``span_totals()``) and counters are plain locked integers; aggregation
across ranks, goodput, Perfetto export and the metrics textfile are not
ported yet.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator

SLABS_PACKED = "slabs.packed"
BYTES_STAGED = "bytes.staged"
BYTES_WRITTEN = "bytes.written"
BYTES_READ = "bytes.read"
BYTES_OFFLOADED = "bytes.offloaded"
TILES_READ = "tiles.read"
RESILIENCE_ABORTS = "resilience.aborts"
# which coordinator get_default_coordinator chose
COORDINATOR_STORE = "coordination.default.store"
COORDINATOR_LOCAL = "coordination.default.local"
EVENT_HANDLER_ERRORS = "event_handler.errors"
# The fast-I/O engine (storage/fastio.py): bytes it moved, digests fused
# into a write, waits for an exhausted bounce-buffer pool, legs that went
# O_DIRECT or buffered, and reads that advised DONTNEED where the
# filesystem refused O_DIRECT.
FASTIO_BYTES_WRITTEN = "storage.fastio.bytes_written"
FASTIO_BYTES_READ = "storage.fastio.bytes_read"
FASTIO_FUSED_DIGESTS = "storage.fastio.fused_digests"
FASTIO_POOL_WAITS = "storage.fastio.pool_waits"
FASTIO_DIRECT_PARTS = "storage.fastio.direct_parts"
FASTIO_BUFFERED_PARTS = "storage.fastio.buffered_parts"
FASTIO_DONTNEED_READS = "storage.fastio.dontneed_reads"

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}
_SPAN_TOTALS: Dict[str, float] = {}


class _Counter:
    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            _COUNTERS[self.name] = _COUNTERS.get(self.name, 0) + n


def counter(name: str) -> _Counter:
    return _Counter(name)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Bracket a phase; its wall seconds add to ``span_totals()[name]``.
    ``attrs`` are accepted for call-site parity with the JAX package."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            _SPAN_TOTALS[name] = _SPAN_TOTALS.get(name, 0.0) + dt


def counters() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def span_totals() -> Dict[str, float]:
    with _LOCK:
        return dict(_SPAN_TOTALS)


def reset() -> None:
    with _LOCK:
        _COUNTERS.clear()
        _SPAN_TOTALS.clear()
