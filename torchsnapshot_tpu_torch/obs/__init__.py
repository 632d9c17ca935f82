"""Observability: structured spans, a metrics registry, Perfetto export.

Counterpart of ``torchsnapshot_tpu/obs``, with the same import surface,
span names, metric names and flight-record format.  Three layers:

- **Spans** (``span``, ``get_tracer``) — opt-in via the
  ``TORCHSNAPSHOT_TPU_TORCH_TRACE`` knob (``knobs.override_trace``);
  zero-cost (one module-flag check, no allocation) when disabled.  See
  ``tracer.py``.
- **Metrics** (``counter``/``gauge``/``histogram``,
  ``metrics_snapshot``) — always on; the hot path records bytes
  staged/written/read, budget high-water, queue depths, phase seconds
  and per-backend storage latency.  See ``metrics.py``.
- **Export** (``write_trace``; ``export_openmetrics``) — recorded spans
  as Chrome ``trace_event`` JSON for ui.perfetto.dev, and the registry
  as an OpenMetrics textfile.  See ``perfetto.py`` and ``export.py``.

The cross-rank flight record (``aggregate``) and the goodput tracker
(``goodput``) are submodules.  Spans and phase clocks are host wall
time: where a phase ends on the card is set by the code inside it
(staging ends once the host holds the bytes, after the device-to-host
copy's event was waited on; consume ends once the host-to-device copy
and its kernel are enqueued).
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Any, Dict

from .metrics import (  # noqa: F401
    CODEC_BYTES_IN,
    GOODPUT_DURABILITY_LAG_S,
    GOODPUT_OVERHEAD_FRACTION,
    GOODPUT_TIME_TO_UNBLOCK_S,
    PHASE_BARRIER_S,
    PHASE_CONSUME_S,
    PHASE_ENCODE_S,
    PHASE_PREFIX,
    PHASE_READ_S,
    PHASE_STAGE_S,
    PHASE_WRITE_S,
    CODEC_BYTES_OUT,
    CODEC_PARTS_DECODED,
    CODEC_PARTS_ENCODED,
    CODEC_PARTS_RAW_FALLBACK,
    BUDGET_BYTES_IN_USE,
    BYTES_DEDUPED,
    BYTES_OFFLOADED,
    BYTES_PROMOTED,
    BYTES_READ,
    BYTES_REPLICATED,
    BYTES_STAGED,
    BYTES_WRITTEN,
    BYTES_BUCKETS,
    CACHE_BYTES_FILLED,
    CACHE_EVICTIONS,
    CACHE_HITS,
    CACHE_MISSES,
    CACHE_SINGLEFLIGHT_WAITS,
    MMAP_BYTES_MAPPED,
    MMAP_READS,
    CAS_BYTES_SHARED,
    CAS_BYTES_SWEPT,
    CAS_BYTES_WRITTEN,
    CAS_CHUNKS_SHARED,
    CAS_CHUNKS_SWEPT,
    CAS_CHUNKS_WRITTEN,
    CAS_FSCKS,
    CONTINUOUS_BYTES_REPLICATED,
    CONTINUOUS_BYTES_SKIPPED,
    CONTINUOUS_CHUNKS_REPLICATED,
    CONTINUOUS_CHUNKS_SKIPPED,
    CONTINUOUS_PREEMPTION_DRAINS,
    CONTINUOUS_PROMOTIONS,
    CONTINUOUS_REPLICATION_ERRORS,
    CONTINUOUS_REPLICATION_LAG_S,
    CONTINUOUS_REPLICATION_LAG_STEPS,
    CONTINUOUS_RESTORE_S,
    CONTINUOUS_RESTORES_FROM_DURABLE,
    CONTINUOUS_RESTORES_FROM_LOCAL,
    CONTINUOUS_RESTORES_FROM_PEER,
    CONTINUOUS_STEP_OVERHEAD_S,
    CONTINUOUS_STEPS,
    EVENT_HANDLER_ERRORS,
    EXCEPTIONS_SWALLOWED,
    COORDINATOR_LOCAL,
    COORDINATOR_STORE,
    TILES_READ,
    FASTIO_BUFFERED_PARTS,
    FASTIO_BYTES_READ,
    FASTIO_BYTES_WRITTEN,
    FASTIO_DIRECT_PARTS,
    FASTIO_DONTNEED_READS,
    FASTIO_FUSED_DIGESTS,
    FASTIO_POOL_WAITS,
    GC_BYTES_RECLAIMED,
    IO_QUEUE_DEPTH,
    LATENCY_BUCKETS_S,
    LIVENESS_DEAD_RANKS,
    LIVENESS_HEARTBEATS,
    PROMOTION_LAG_S,
    REGISTRY,
    RESILIENCE_ABORTS,
    RESILIENCE_BACKOFF_DELAY_S,
    RESILIENCE_BREAKER_TRIPS,
    RESILIENCE_FAILPOINTS_FIRED,
    RESILIENCE_RETRIES,
    RSS_PEAK_DELTA_BYTES,
    SLABS_PACKED,
    STRIPE_ABORTS,
    STRIPE_BYTES_READ,
    STRIPE_BYTES_WRITTEN,
    STRIPE_PART_READ_LATENCY_S,
    STRIPE_PART_WRITE_LATENCY_S,
    STRIPE_PARTS_READ,
    STRIPE_PARTS_WRITTEN,
    STRIPE_READS,
    STRIPE_STREAMED_WRITES,
    STRIPE_WRITES,
    TIER_FAST_CORRUPT,
    TIER_FAST_HITS,
    TIER_FAST_MISSES,
    TIER_FAST_REPAIRS,
    TIER_PEER_HITS,
    TAKEOVER_OBJECTS,
    TAKEOVER_BYTES,
    TAKEOVER_DEGRADED_COMMITS,
    TAKEOVER_PATHS_REPAIRED,
    TAKEOVER_PROMOTER_DEAD_PEERS,
    TOPOLOGY_SLICES,
    TOPOLOGY_REPLICATED_OBJECTS_WRITTEN,
    TOPOLOGY_REPLICATED_BYTES_WRITTEN,
    FANOUT_DURABLE_READS,
    FANOUT_DURABLE_GETS_SAVED,
    FANOUT_BYTES_REDISTRIBUTED,
    FANOUT_PUBLISHES,
    FANOUT_FALLBACKS,
    TRANSPORT_COLLECTIVE_OPS,
    TRANSPORT_COLLECTIVE_BYTES,
    TRANSPORT_KV_OPS,
    TRANSPORT_KV_BYTES,
    TRANSPORT_FALLBACKS,
    TRANSPORT_DEVICE_MOVES,
    TRANSPORT_SWEPT_PARTS,
    TRANSPORT_COLLECTIVE_S,
    TRANSPORT_KV_S,
    PUBLISH_RECORDS,
    PUBLISH_BYTES_DELTA,
    PUBLISH_CHUNKS_DELTA,
    PUBLISH_ANNOUNCE_FAILURES,
    PUBLISH_SUB_SWAPS,
    PUBLISH_SUB_BYTES_FETCHED,
    PUBLISH_SUB_CHUNKS_FETCHED,
    PUBLISH_SUB_CHUNKS_REUSED,
    PUBLISH_SUB_LAG_S,
    PUBLISH_SUB_APPLY_S,
    PUBLISH_FALLBACK_POLLS,
    PUBLISH_WATCH_ERRORS,
    PUBLISH_LEAVES_SKIPPED,
    PUBLISH_GENERATION,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    metrics_snapshot,
    record_storage_io,
    reset_metrics,
)
from .export import (  # noqa: F401
    export_openmetrics,
    maybe_write_metrics_textfile,
    write_metrics_textfile,
)
from .perfetto import to_trace_events, write_trace  # noqa: F401
from .tracer import (  # noqa: F401
    Span,
    Tracer,
    current_span,
    get_tracer,
    next_flow_id,
    refresh_enabled,
    set_tracing,
    span,
    tracing_enabled,
)

__all__ = [
    "Span",
    "Tracer",
    "span",
    "get_tracer",
    "current_span",
    "tracing_enabled",
    "set_tracing",
    "refresh_enabled",
    "counter",
    "gauge",
    "histogram",
    "metrics_snapshot",
    "reset_metrics",
    "record_storage_io",
    "buf_nbytes",
    "swallowed_exception",
    "instrument_storage",
    "to_trace_events",
    "write_trace",
    "REGISTRY",
    "MetricsRegistry",
    "aggregate",
    "goodput",
    "export_openmetrics",
    "write_metrics_textfile",
    "maybe_write_metrics_textfile",
    "counters",
]

# The distributed/persistent half (cross-rank aggregation + flight
# records) and the goodput tracker are reached as submodules:
# ``obs.aggregate.read_obsrecord(...)``, ``obs.goodput.block()``.
from . import aggregate, goodput  # noqa: E402,F401


_swallow_logger = logging.getLogger(__name__)


def swallowed_exception(site: str, exc: BaseException) -> None:
    """Record a deliberately-swallowed exception on a fallback path:
    one counter increment (``exceptions.swallowed``) plus a debug log
    carrying the site and the exception.  One shared counter, not one
    per site — site names are free-form and must not grow the registry
    unboundedly; per-site attribution lives in the log line.  Cheap
    enough for hot paths (a lock-guarded int add; the log call is lazy
    below DEBUG level)."""
    counter(EXCEPTIONS_SWALLOWED).inc()
    _swallow_logger.debug("swallowed exception at %s: %r", site, exc)


def buf_nbytes(buf: Any) -> int:
    """Byte length of a staged/read buffer, 0 for None.  ``.nbytes``
    first: numpy arrays and tensors report it, and ``len()`` on a
    multi-dim array is the first-dim length, not bytes."""
    if buf is None:
        return 0
    n = getattr(buf, "nbytes", None)
    if isinstance(n, int):
        return n
    try:
        return memoryview(buf).cast("B").nbytes
    except (TypeError, ValueError):
        try:
            return len(buf)
        except TypeError:
            return 0


def instrument_storage(backend: str):
    """Class decorator for ``StoragePlugin`` subclasses: wraps ``write``
    and ``read`` with a (knob-gated) span plus always-on per-backend
    latency/byte metrics.  Subclasses that override ``write``/``read``
    (e.g. fault-injection test doubles) simply shadow the wrapper —
    behavior is unchanged for them."""

    def deco(cls):
        orig_write = cls.write
        orig_read = cls.read

        @functools.wraps(orig_write)
        async def write(self, write_io):
            nbytes = buf_nbytes(write_io.buf)
            with span(
                "storage/write", backend=backend,
                path=write_io.path, bytes=nbytes,
            ):
                t0 = time.perf_counter()
                await orig_write(self, write_io)
                record_storage_io(
                    backend, "write", nbytes, time.perf_counter() - t0
                )

        @functools.wraps(orig_read)
        async def read(self, read_io):
            with span(
                "storage/read", backend=backend, path=read_io.path
            ) as s:
                t0 = time.perf_counter()
                await orig_read(self, read_io)
                nbytes = buf_nbytes(read_io.buf)
                if s is not None:
                    s.attrs["bytes"] = nbytes
                record_storage_io(
                    backend, "read", nbytes, time.perf_counter() - t0
                )

        cls.write = write
        cls.read = read
        return cls

    return deco


def counters() -> Dict[str, int]:
    """Every counter's value by name (a view of ``metrics_snapshot``)."""
    return metrics_snapshot()["counters"]
