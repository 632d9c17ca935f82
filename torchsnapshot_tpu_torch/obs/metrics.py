"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``torchsnapshot_tpu/obs/metrics.py``, the same
instruments, buckets and names.  Always on (unlike spans): the
instruments below are updated a handful of times per storage op or
pipeline transition, and each update is one lock-protected arithmetic
op.  The names are the schema the flight record (``aggregate.py``)
merges across ranks and the JAX package's ``doctor`` renders, so every
name of the JAX package is carried, including those of subsystems this
package does not have yet (stripe, codec, cas, tier, topology,
transport, continuous, publish): those emit nothing until they arrive.

Snapshot format (``snapshot()``) is plain JSON-safe dicts:

    {"counters": {name: int},
     "gauges": {name: {"value": float, "max": float}},
     "histograms": {name: {"count": int, "sum": float, "min": float,
                           "max": float, "bounds": [...], "counts": [...]}}}

``counts`` has ``len(bounds) + 1`` entries; the last is the overflow
bucket (values above every bound) — no ``Infinity`` literals, so the
snapshot survives strict JSON parsers.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Default bucket ladders.  Latency in seconds (sub-ms to a minute);
# bytes from 1KB to 4GB in powers of ~4 — both chosen to straddle the
# ranges the storage plugins and scheduler actually produce.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
BYTES_BUCKETS: Tuple[float, ...] = (
    1024.0, 16384.0, 262144.0, 1048576.0, 4194304.0, 16777216.0,
    67108864.0, 268435456.0, 1073741824.0, 4294967296.0,
)

# Well-known instrument names (the instrumented hot path uses these; a
# single source of truth keeps bench/docs/tests from drifting).
BYTES_STAGED = "bytes_staged"
BYTES_WRITTEN = "bytes_written"
BYTES_READ = "bytes_read"
BYTES_DEDUPED = "bytes_deduped"
BYTES_OFFLOADED = "bytes_offloaded"
BUDGET_BYTES_IN_USE = "budget_bytes_in_use"
IO_QUEUE_DEPTH = "io_queue_depth"
# the read pipeline's twins: an async_take's background drain can
# overlap a restore in the same process, so the two pipelines must not
# interleave writes to one gauge
BUDGET_BYTES_IN_USE_READ = "budget_bytes_in_use_read"
IO_QUEUE_DEPTH_READ = "io_queue_depth_read"
RSS_PEAK_DELTA_BYTES = "rss_peak_delta_bytes"
SLABS_PACKED = "slabs_packed"
# tiered storage (tier/): read-path residency + write-back promotion.
# hits/misses count tier-plugin reads served by the fast tier vs fallen
# back (peer or durable); repairs count fast-tier copies rewritten from
# a fallback source; corrupt counts fast copies that failed their
# digest/parse check.  bytes_promoted/promotion_lag_s describe the
# write-back promoter (fast-commit → durable-commit).
TIER_FAST_HITS = "tier.fast_hits"
TIER_FAST_MISSES = "tier.fast_misses"
TIER_FAST_REPAIRS = "tier.fast_repairs"
TIER_FAST_CORRUPT = "tier.fast_corrupt"
TIER_PEER_HITS = "tier.peer_hits"
BYTES_PROMOTED = "tier.bytes_promoted"
BYTES_REPLICATED = "tier.bytes_replicated"
PROMOTION_LAG_S = "tier.promotion_lag_s"
# Striped storage I/O (storage/stripe.py): whole-object writes/reads
# that were split into parts, the parts themselves, bytes moved through
# the striped paths, and aborted striped writes (failure/poison cleanup
# that tore down a multipart upload).  Part-level latencies land in the
# storage.stripe.part_write_latency_s / part_read_latency_s histograms;
# per-backend byte/latency instruments keep recording per part via
# record_storage_io, so backend dashboards see striped traffic too.
STRIPE_WRITES = "storage.stripe.writes"
STRIPE_READS = "storage.stripe.reads"
STRIPE_PARTS_WRITTEN = "storage.stripe.parts_written"
STRIPE_PARTS_READ = "storage.stripe.parts_read"
STRIPE_BYTES_WRITTEN = "storage.stripe.bytes_written"
STRIPE_BYTES_READ = "storage.stripe.bytes_read"
STRIPE_ABORTS = "storage.stripe.aborts"
STRIPE_STREAMED_WRITES = "storage.stripe.streamed_writes"
STRIPE_PART_WRITE_LATENCY_S = "storage.stripe.part_write_latency_s"
STRIPE_PART_READ_LATENCY_S = "storage.stripe.part_read_latency_s"
# Per-part compression (codec.py): raw bytes entering the encode stage,
# stored (frame) bytes leaving it, parts that kept their encoded frame
# vs fell back to store-raw (min-ratio check), and frames decoded on
# restore.  Per-codec encode/decode latencies land in
# storage.codec.{encode,decode}_latency_s.<codec> histograms.
CODEC_BYTES_IN = "storage.codec.bytes_in"
CODEC_BYTES_OUT = "storage.codec.bytes_out"
CODEC_PARTS_ENCODED = "storage.codec.parts_encoded"
CODEC_PARTS_RAW_FALLBACK = "storage.codec.parts_raw_fallback"
CODEC_PARTS_DECODED = "storage.codec.parts_decoded"
# Shared-host object cache (storage/hostcache.py): a hit served the
# read from the per-host cache directory without touching the durable
# tier; a miss performed the one durable GET that fills the entry; a
# singleflight wait blocked behind another process's in-flight fill of
# the SAME object and then served the filled entry (no GET of its own)
# — on an N-reader cold start hits+waits should approach N-1 per
# object while misses stay at exactly 1.
CACHE_HITS = "storage.cache.hits"
CACHE_MISSES = "storage.cache.misses"
CACHE_SINGLEFLIGHT_WAITS = "storage.cache.singleflight_waits"
CACHE_BYTES_FILLED = "storage.cache.bytes_filled"
CACHE_EVICTIONS = "storage.cache.evictions"
# Native fast-I/O engine (storage/fastio.py): bytes moved through the
# engine's GIL-free part readers/writers, parts that took the O_DIRECT
# leg vs the buffered (pwritev-batched) leg, part digests fused into
# the same native pass that moved the bytes (each one is a full read
# pass the old path paid separately), waits for an exhausted aligned
# bounce-buffer pool (backpressure — size FASTIO_BUFFER_POOL_BYTES up
# if this grows), and reads that applied the posix_fadvise(DONTNEED)
# fallback where O_DIRECT was unavailable.
FASTIO_BYTES_WRITTEN = "storage.fastio.bytes_written"
FASTIO_BYTES_READ = "storage.fastio.bytes_read"
FASTIO_DIRECT_PARTS = "storage.fastio.direct_parts"
FASTIO_BUFFERED_PARTS = "storage.fastio.buffered_parts"
FASTIO_FUSED_DIGESTS = "storage.fastio.fused_digests"
FASTIO_POOL_WAITS = "storage.fastio.pool_waits"
FASTIO_DONTNEED_READS = "storage.fastio.dontneed_reads"
# Zero-copy mmap reads (io_types.ReadIO.want_mmap): reads served as
# read-only file-backed mappings instead of heap copies, and the bytes
# mapped (pages fault in lazily — mapped ≠ resident).
MMAP_READS = "storage.mmap.reads"
MMAP_BYTES_MAPPED = "storage.mmap.bytes_mapped"
# Phase timing (cross-rank straggler attribution, obs/aggregate.py):
# always-on histograms of where a take/restore spent its wall time on
# THIS rank.  One observe per pipeline task / coordination wait — cheap
# enough to leave running; per-operation deltas ride the flight-record
# exchange so rank 0 can name "rank 3, write phase" without a re-run.
# stage/encode/write are take-side, read/consume restore-side, barrier
# covers coordination waits in both directions.
PHASE_STAGE_S = "phase.stage_s"
PHASE_ENCODE_S = "phase.encode_s"
PHASE_WRITE_S = "phase.write_s"
PHASE_READ_S = "phase.read_s"
PHASE_CONSUME_S = "phase.consume_s"
PHASE_BARRIER_S = "phase.barrier_s"
PHASE_PREFIX = "phase."
# Goodput/SLO accounting (obs/goodput.py): how long the training loop
# was blocked by the last checkpoint, last take→durable-commit lag
# (covers write-back promotion), and the cumulative fraction of wall
# time spent blocked on checkpointing since the first take.
GOODPUT_TIME_TO_UNBLOCK_S = "goodput.time_to_unblock_s"
GOODPUT_DURABILITY_LAG_S = "goodput.durability_lag_s"
GOODPUT_OVERHEAD_FRACTION = "goodput.overhead_fraction"
# GC/retention: bytes of storage objects reclaimed by delete_snapshot.
# Under the chunk store (cas/) this counts per-step objects PLUS only
# the chunks whose refcount dropped to zero — shared chunks are not
# reclaimed by deleting one of their referencing steps.
GC_BYTES_RECLAIMED = "snapshot.gc.bytes_reclaimed"
# Content-addressed chunk store (cas/): chunks/bytes a take actually
# wrote vs skipped because an earlier committed step already stored the
# content (bytes_shared / bytes_written is the take's dedup win), chunks
# physically deleted by the two-phase GC sweep, and index rebuilds.
CAS_CHUNKS_WRITTEN = "cas.chunks_written"
CAS_CHUNKS_SHARED = "cas.chunks_shared"
CAS_BYTES_WRITTEN = "cas.bytes_written"
CAS_BYTES_SHARED = "cas.bytes_shared"
CAS_CHUNKS_SWEPT = "cas.chunks_swept"
CAS_BYTES_SWEPT = "cas.bytes_swept"
CAS_FSCKS = "cas.fscks"
# Multislice topology (topology/): write-side replicated objects/bytes
# this rank wrote under the topology-aware partition (explicit
# topologies only; a chunk-split object counts once per rank carrying
# any of its chunks — per-slice rollups come from grouping ranks by
# their flight-record slice id), and the
# fan-out restore's ledger — inner durable-tier GETs issued for shared
# (replicated) objects by this rank (designated reads + fallbacks; the
# per-slice sum is the bounded quantity: O(objects), not
# O(objects × ranks)), reads served from a sibling's publication
# instead of the durable tier, bytes redistributed over the
# coordination KV, publications performed, and timeouts/digest
# mismatches that degraded a read to a direct durable GET.
TOPOLOGY_SLICES = "topology.slices"
TOPOLOGY_REPLICATED_OBJECTS_WRITTEN = "topology.replicated_objects_written"
TOPOLOGY_REPLICATED_BYTES_WRITTEN = "topology.replicated_bytes_written"
FANOUT_DURABLE_READS = "topology.fanout_durable_reads"
FANOUT_DURABLE_GETS_SAVED = "topology.durable_gets_saved"
FANOUT_BYTES_REDISTRIBUTED = "topology.fanout_bytes_redistributed"
FANOUT_PUBLISHES = "topology.fanout_publishes"
FANOUT_FALLBACKS = "topology.fanout_fallbacks"
# Payload transport (transport/): how redistribution bytes physically
# moved.  collective_ops/collective_bytes count payload transfers the
# device-collective engine carried (bytes are pre-padding payload
# bytes, so KV and collective numbers compare directly);
# kv_ops/kv_bytes the same for the chunked-KV engine (fan-out blob
# publishes ride these too once routed through a Transport);
# fallbacks counts per-op degrades collective→KV (probe said
# collective but the transfer failed or the runtime lost the mesh) —
# the never-wedge contract's visible trace; device_moves counts
# host→device→host payload round-trips the continuous peer-delta leg
# performed; swept_parts counts leaked blob chunk keys reclaimed by
# the publish-path sweep (a publisher killed between meta-key and
# delete leaves parts — the sweep is the regression fix's counter).
# Latency histograms transport.collective_s / transport.kv_s time one
# payload transfer end-to-end (publish→consume on the measuring side).
TRANSPORT_COLLECTIVE_OPS = "transport.collective_ops"
TRANSPORT_COLLECTIVE_BYTES = "transport.collective_bytes"
TRANSPORT_KV_OPS = "transport.kv_ops"
TRANSPORT_KV_BYTES = "transport.kv_bytes"
TRANSPORT_FALLBACKS = "transport.fallbacks"
TRANSPORT_DEVICE_MOVES = "transport.device_moves"
TRANSPORT_SWEPT_PARTS = "transport.swept_parts"
TRANSPORT_COLLECTIVE_S = "transport.collective_s"
TRANSPORT_KV_S = "transport.kv_s"
# Continuous per-step checkpointing (continuous/): every training
# step's changed chunks replicate to a peer host's RAM.  steps counts
# step() calls that ran; bytes/chunks replicated vs skipped is the
# per-step delta win (skipped = content the targets already held);
# step_overhead_s is the BLOCKED window inside step() (digest + delta
# staging — the seconds the training loop actually lost, also folded
# into goodput.overhead_fraction); replication_lag_s is step-begin →
# all-targets-complete (the at-risk window: a host killed inside it
# loses that one step); replication_lag_steps gauges how far the
# background writer trails the training loop; replication_errors
# counts steps whose replication failed (training continues — the peer
# simply keeps the previous step); restore_s is the measured
# recovery-time objective of recover(), per source; preemption_drains
# counts SIGTERM grace-window drains that completed.
CONTINUOUS_STEPS = "continuous.steps"
CONTINUOUS_BYTES_REPLICATED = "continuous.bytes_replicated"
CONTINUOUS_BYTES_SKIPPED = "continuous.bytes_skipped"
CONTINUOUS_CHUNKS_REPLICATED = "continuous.chunks_replicated"
CONTINUOUS_CHUNKS_SKIPPED = "continuous.chunks_skipped"
CONTINUOUS_STEP_OVERHEAD_S = "continuous.step_overhead_s"
CONTINUOUS_REPLICATION_LAG_S = "continuous.replication_lag_s"
CONTINUOUS_REPLICATION_LAG_STEPS = "continuous.replication_lag_steps"
CONTINUOUS_REPLICATION_ERRORS = "continuous.replication_errors"
CONTINUOUS_PROMOTIONS = "continuous.promotions"
CONTINUOUS_RESTORES_FROM_LOCAL = "continuous.restores_from_local"
CONTINUOUS_RESTORES_FROM_PEER = "continuous.restores_from_peer"
CONTINUOUS_RESTORES_FROM_DURABLE = "continuous.restores_from_durable"
CONTINUOUS_RESTORE_S = "continuous.restore_s"
CONTINUOUS_PREEMPTION_DRAINS = "continuous.preemption_drains"
# Live weight publication (publish/): the training→serving hot-swap
# channel.  Publisher side: records counts publication records
# committed (marker-last), bytes/chunks_delta the NEW bytes/chunks
# this record introduced vs the previous one (the wire cost of one
# update), announce_failures the best-effort KV announces that failed
# (subscribers degrade to durable polling — this counter is the only
# trace).  Subscriber side: swaps counts completed generation bumps,
# bytes/chunks_fetched the actual delta traffic, chunks_reused the
# chunks the held generation already had (the savings), lag_s is
# record-publish-time → swap-complete (the propagation lag a serving
# fleet cares about), apply_s the staged-apply + swap wall time,
# fallback_polls counts durable-poll wake-ups that found a new record
# the announce channel never delivered, watch_errors counts watcher
# iterations that failed and were retried (degrade-never-wedge),
# leaves_skipped counts record leaves a subscriber could not apply
# (template mismatch in non-strict mode) or a publisher could not
# reference (codec'd/sharded sources); generation gauges the
# subscriber's current swap generation.
PUBLISH_RECORDS = "publish.records"
PUBLISH_BYTES_DELTA = "publish.bytes_delta"
PUBLISH_CHUNKS_DELTA = "publish.chunks_delta"
PUBLISH_ANNOUNCE_FAILURES = "publish.announce_failures"
PUBLISH_SUB_SWAPS = "publish.subscriber_swaps"
PUBLISH_SUB_BYTES_FETCHED = "publish.subscriber_bytes_fetched"
PUBLISH_SUB_CHUNKS_FETCHED = "publish.subscriber_chunks_fetched"
PUBLISH_SUB_CHUNKS_REUSED = "publish.subscriber_chunks_reused"
PUBLISH_SUB_LAG_S = "publish.subscriber_lag_s"
PUBLISH_SUB_APPLY_S = "publish.subscriber_apply_s"
PUBLISH_FALLBACK_POLLS = "publish.fallback_polls"
PUBLISH_WATCH_ERRORS = "publish.watch_errors"
PUBLISH_LEAVES_SKIPPED = "publish.leaves_skipped"
PUBLISH_GENERATION = "publish.generation"
# Resilience (resilience/): transient-error retries (total, plus
# per-backend twins named resilience.<backend>.retries), cross-rank
# aborts initiated via the poison protocol, deterministic failpoint
# fires, circuit-breaker trips (closed->open transitions; per-backend
# state gauges are named resilience.breaker_state.<backend>: 0 closed,
# 1 half-open, 2 open), and the backoff-delay histogram.
RESILIENCE_RETRIES = "resilience.retries"
RESILIENCE_ABORTS = "resilience.aborts"
RESILIENCE_FAILPOINTS_FIRED = "resilience.failpoints_fired"
RESILIENCE_BREAKER_TRIPS = "resilience.breaker_trips"
RESILIENCE_BACKOFF_DELAY_S = "resilience.backoff_delay_s"
# Rank liveness + write takeover (resilience/liveness.py,
# snapshot take recovery): heartbeat stamps published, peer ranks
# declared dead (stamp frozen past LIVENESS_TIMEOUT_S — each rank
# counts its own observations), replicated objects/bytes a survivor
# re-wrote on behalf of a dead writer, commits that landed with a
# `degraded` manifest section (sharded-only loss), degraded paths
# healed back to complete (next take / SnapshotManager.repair), and
# dead peers the tier promoter's done-handshake skipped instead of
# wedging on.
LIVENESS_HEARTBEATS = "liveness.heartbeats"
LIVENESS_DEAD_RANKS = "liveness.dead_ranks"
TAKEOVER_OBJECTS = "takeover.objects"
TAKEOVER_BYTES = "takeover.bytes"
TAKEOVER_DEGRADED_COMMITS = "takeover.degraded_commits"
TAKEOVER_PATHS_REPAIRED = "takeover.paths_repaired"
TAKEOVER_PROMOTER_DEAD_PEERS = "takeover.promoter_dead_peers"
# Exception hygiene (tools/lint exception-hygiene pass): every
# deliberate broad-except swallow on a fallback path increments this
# via obs.swallowed_exception, so "how often are we falling back" is a
# dashboard number instead of an invisible `pass`.
EXCEPTIONS_SWALLOWED = "exceptions.swallowed"
# Registered event handlers that raised from the log_event fan-out
# (the handler error is logged and suppressed so telemetry can never
# break the operation it observes — this counter keeps the failure
# visible).
EVENT_HANDLER_ERRORS = "events.handler_errors"
# This package's own instruments (no JAX package counterpart): row or
# flat tiles landed by budgeted reads (preparers/array.py, sharded.py),
# and which coordinator get_default_coordinator chose.
TILES_READ = "tiles.read"
COORDINATOR_STORE = "coordination.default.store"
COORDINATOR_LOCAL = "coordination.default.local"


class Counter:
    """Monotonically-increasing integer."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-set value plus its high-water mark (``max``) since reset —
    the high-water is what budget/queue-depth gauges exist for."""

    __slots__ = ("name", "_value", "_max", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            if v > self._max:
                self._max = v

    def set_max(self, v: float) -> None:
        """Record ``v`` only as a high-water candidate (value untouched)."""
        with self._lock:
            if v > self._max:
                self._max = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self._max = 0.0


class Histogram:
    """Fixed-bucket histogram: ``bounds`` are inclusive upper edges,
    observations above every bound land in the overflow bucket."""

    __slots__ = ("name", "bounds", "_counts", "_sum", "_min", "_max",
                 "_count", "_lock")

    def __init__(
        self, name: str, bounds: Sequence[float] = LATENCY_BUCKETS_S
    ) -> None:
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram bounds must be strictly increasing: {bounds}")
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "bounds": list(self.bounds),
                "counts": list(self._counts),
            }

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._min = None
            self._max = None
            self._count = 0


class MetricsRegistry:
    """Name → instrument, get-or-create.  One process-global instance
    (``REGISTRY``); independent registries exist only for tests."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(
        self, name: str, bounds: Sequence[float] = LATENCY_BUCKETS_S
    ) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, bounds)
            return h

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())
        return {
            "counters": {c.name: c.value for c in counters},
            "gauges": {
                g.name: {"value": g.value, "max": g.max} for g in gauges
            },
            "histograms": {h.name: h.to_dict() for h in histograms},
        }

    def reset(self) -> None:
        """Zero every instrument (instrument objects stay registered, so
        references held by instrumented code remain live)."""
        with self._lock:
            instruments: List[Any] = [
                *self._counters.values(),
                *self._gauges.values(),
                *self._histograms.values(),
            ]
        for inst in instruments:
            inst._reset()


REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(
    name: str, bounds: Sequence[float] = LATENCY_BUCKETS_S
) -> Histogram:
    return REGISTRY.histogram(name, bounds)


def metrics_snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def reset_metrics() -> None:
    REGISTRY.reset()


def record_storage_io(backend: str, op: str, nbytes: int, seconds: float) -> None:
    """One storage write/read completed: latency histogram + byte counter,
    labeled per backend (``storage.fs.write_latency_s`` …)."""
    REGISTRY.histogram(
        f"storage.{backend}.{op}_latency_s", LATENCY_BUCKETS_S
    ).observe(seconds)
    REGISTRY.counter(f"storage.{backend}.{op}_bytes").inc(nbytes)
