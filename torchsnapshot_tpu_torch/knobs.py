"""Main-path knobs with env-var overrides and context-manager test hooks.

PyTorch counterpart of ``torchsnapshot_tpu/knobs.py``: the same knob
names and defaults, read from ``TORCHSNAPSHOT_TPU_TORCH_``-prefixed
environment variables.  Only the knobs the take/restore main path reads
are carried; the rest arrive with the modules that read them.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

_logger = logging.getLogger(__name__)

_ENV_PREFIX = "TORCHSNAPSHOT_TPU_TORCH_"

_MAX_CHUNK_SIZE_BYTES = "MAX_CHUNK_SIZE_BYTES"
_MAX_SHARD_SIZE_BYTES = "MAX_SHARD_SIZE_BYTES"
_SLAB_SIZE_THRESHOLD_BYTES = "SLAB_SIZE_THRESHOLD_BYTES"
_SLAB_HOST_MEMBER_MAX_BYTES = "SLAB_HOST_MEMBER_MAX_BYTES"
_MAX_PER_RANK_IO_CONCURRENCY = "MAX_PER_RANK_IO_CONCURRENCY"
_DISABLE_BATCHING = "DISABLE_BATCHING"
_PER_RANK_MEMORY_BUDGET_BYTES = "PER_RANK_MEMORY_BUDGET_BYTES"
_ALLOW_PICKLE_OBJECTS = "ALLOW_PICKLE_OBJECTS"
_STAGING_THREADS = "STAGING_THREADS"
_DISABLE_EAGER_HOST_STAGING = "DISABLE_EAGER_HOST_STAGING"
_WRITE_CHECKSUMS = "WRITE_CHECKSUMS"
_VERIFY_ON_RESTORE = "VERIFY_ON_RESTORE"
_REPLICATION_VERIFY = "REPLICATION_VERIFY"
_ENABLE_NATIVE_EXT = "ENABLE_NATIVE_EXT"
_FS_VERIFY_WRITES = "FS_VERIFY_WRITES"
_FS_SYNC_DATA = "FS_SYNC_DATA"
_FASTIO = "FASTIO"
_FASTIO_DIRECT = "FASTIO_DIRECT"
_FASTIO_BUFFER_POOL_BYTES = "FASTIO_BUFFER_POOL_BYTES"
_TRACE = "TRACE"
_METRICS_TEXTFILE = "METRICS_TEXTFILE"
_CAS = "CAS"
_CAS_CHUNK_SIZE_BYTES = "CAS_CHUNK_SIZE_BYTES"
_CAS_GC_GRACE_S = "CAS_GC_GRACE_S"
_MMAP = "MMAP"
_FAILPOINTS = "FAILPOINTS"
_FAILPOINT_SEED = "FAILPOINT_SEED"
_RETRY_MAX_ATTEMPTS = "RETRY_MAX_ATTEMPTS"
_RETRY_PROGRESS_WINDOW_S = "RETRY_PROGRESS_WINDOW_S"
_RETRY_BACKOFF_CAP_S = "RETRY_BACKOFF_CAP_S"
_BREAKER_THRESHOLD = "BREAKER_THRESHOLD"
_BREAKER_COOLDOWN_S = "BREAKER_COOLDOWN_S"
_STRIPE_PART_SIZE_BYTES = "STRIPE_PART_SIZE_BYTES"
_STRIPE_MIN_OBJECT_SIZE_BYTES = "STRIPE_MIN_OBJECT_SIZE_BYTES"
_CODEC = "CODEC"
_CODEC_LEVEL = "CODEC_LEVEL"
_CODEC_MIN_RATIO = "CODEC_MIN_RATIO"
_TIER_POLICY = "TIER_POLICY"
_TIER_FAST_KEEP_LAST_N = "TIER_FAST_KEEP_LAST_N"
_TIER_VERIFY_FAST_READS = "TIER_VERIFY_FAST_READS"
_CACHE_DIR = "CACHE_DIR"
_CACHE_MAX_BYTES = "CACHE_MAX_BYTES"
_TOPOLOGY = "TOPOLOGY"
_TOPOLOGY_SLICE_ID = "TOPOLOGY_SLICE_ID"
_TOPOLOGY_HOST_ID = "TOPOLOGY_HOST_ID"
_LIVENESS_TIMEOUT_S = "LIVENESS_TIMEOUT_S"
_LIVENESS_INTERVAL_S = "LIVENESS_INTERVAL_S"
_TAKEOVER = "TAKEOVER"
_FANOUT = "FANOUT"
_FANOUT_PART_BYTES = "FANOUT_PART_BYTES"
_FANOUT_TIMEOUT_S = "FANOUT_TIMEOUT_S"
_TRANSPORT = "TRANSPORT"
_TRANSPORT_PART_BYTES = "TRANSPORT_PART_BYTES"
_TRANSPORT_TIMEOUT_S = "TRANSPORT_TIMEOUT_S"
_CONTINUOUS = "CONTINUOUS"
_CONTINUOUS_PROMOTE_EVERY_N = "CONTINUOUS_PROMOTE_EVERY_N"
_CONTINUOUS_GRACE_S = "CONTINUOUS_GRACE_S"
_S3_ENDPOINT_URL = "S3_ENDPOINT_URL"

_DEFAULTS = {
    # Arrays larger than this are chunked along dim 0 for pipelined I/O.
    _MAX_CHUNK_SIZE_BYTES: 512 * 1024 * 1024,
    # Sharded-array boxes larger than this are subdivided along their
    # largest dim into several stored shards.
    _MAX_SHARD_SIZE_BYTES: 512 * 1024 * 1024,
    # Host-staged members at or above this size skip slab packing (the
    # pack would be a pure extra memcpy); CUDA members stay eligible at
    # any size below the slab threshold, since the device pack turns N
    # device-to-host copies into one.
    _SLAB_HOST_MEMBER_MAX_BYTES: 4 * 1024 * 1024,
    # Write requests smaller than this are coalesced into slabs.
    _SLAB_SIZE_THRESHOLD_BYTES: 128 * 1024 * 1024,
    # Concurrent storage operations per process.
    _MAX_PER_RANK_IO_CONCURRENCY: 16,
    _DISABLE_BATCHING: 0,
    _PER_RANK_MEMORY_BUDGET_BYTES: 0,  # 0 = auto (see scheduler)
    # Objects the safe codec cannot encode fall back to pickle only when
    # this is on; reading a pickle payload always requires it.
    _ALLOW_PICKLE_OBJECTS: 1,
    # Threads for staging and consuming work.
    _STAGING_THREADS: 4,
    # 1: async_take returns only after every request is staged in host
    # memory (the reference torchsnapshot's unblock point) instead of
    # after the eager copies of host_offload.py.
    _DISABLE_EAGER_HOST_STAGING: 0,
    # Record crc32 content checksums of every payload in the manifest and
    # [crc32, adler32, size] of every object at staging time.  0 writes
    # none (a snapshot either package still restores, unverified).
    _WRITE_CHECKSUMS: 1,
    # Check recorded checksums during restore reads: a whole payload
    # before it is consumed, a tiled one from its tiles' folded crc32.
    # Off by default: restore is the latency-critical path.
    _VERIFY_ON_RESTORE: 0,
    # How a take verifies that state claimed replicated matches across
    # ranks: "full" (array content crc32), "shape" (arrays by dtype and
    # shape; small non-array leaves still by content) or "off".
    _REPLICATION_VERIFY: "full",
    # Native library (_csrc/fastio.cpp, built by g++ on first use) for
    # the digests and the fs plugin's legs.  0 takes zlib and the
    # pure-Python legs; with 1 a library that does not build raises.
    _ENABLE_NATIVE_EXT: 1,
    # Re-read every fs write and compare its crc32 (catches torn or
    # corrupted local writes at save time).
    _FS_VERIFY_WRITES: 0,
    # fdatasync every fs data write, not only the metadata commit point.
    _FS_SYNC_DATA: 0,
    # The fast-I/O engine (storage/fastio.py): each fs write or read is
    # one GIL-free native call, writes digest the bytes in the same
    # pass.  0 keeps the fs plugin's pure-Python legs.
    _FASTIO: 1,
    # O_DIRECT for payloads of 1 MiB and up, around the page cache; a
    # filesystem that refuses it gets buffered legs and
    # posix_fadvise(DONTNEED) on reads.  Bytes and digests are the same.
    _FASTIO_DIRECT: 0,
    # Aligned bounce buffers of the O_DIRECT legs, in 4 MiB buffers
    # (at least one); a part finding none waits (counted in
    # storage.fastio.pool_waits).
    _FASTIO_BUFFER_POOL_BYTES: 64 * 1024 * 1024,
    # Record a span tree of every operation (obs/tracer.py).  Off by
    # default: a disabled span costs one flag check and no allocation.
    _TRACE: 0,
    # Path of an OpenMetrics textfile rewritten after every take,
    # async commit and restore ("{pid}" expands to the process id); ""
    # writes none.
    _METRICS_TEXTFILE: "",
    # Content-addressed chunk store (cas/): SnapshotManager saves store
    # payload bytes as content-keyed chunks in a pool shared by the
    # root's steps (<root>/cas), write only the chunks no committed step
    # holds, and retention releases refs instead of deleting bytes.  0 =
    # per-step objects; SnapshotManager(cas=...) overrides it.
    _CAS: 0,
    # Chunk granularity of content addressing (floored at 4096): an
    # unchanged slice of a mutated tensor keeps its key from step to step.
    _CAS_CHUNK_SIZE_BYTES: 16 * 1024 * 1024,
    # Two-phase GC: a chunk whose last ref goes is only marked orphaned;
    # the sweep deletes it this many seconds later (above the longest
    # take, so a take that dedups against it commits its ref first).
    _CAS_GC_GRACE_S: 900.0,
    # Zero-copy reads: raw reads with no destination buffer of their own
    # (no codec frames, no chunk table, no pinned tile) are served by the
    # fs plugin as private file-backed mappings, admitted outside the
    # read budget (the pages are the page cache's and reclaimable).  0 =
    # every read copies into a buffer of its own.
    _MMAP: 1,
    # Fault injection (resilience/failpoints.py):
    # "site=error[:probability[:count]],..." specs; "" is disarmed.  Read
    # at import and by override_failpoints: set the variable before
    # importing the package.
    _FAILPOINTS: "",
    # Seed of each spec's own random stream: the same spec and seed fire
    # at the same evaluations.
    _FAILPOINT_SEED: 0,
    # Shared retry policy (resilience/retry.py): attempts per operation,
    # and the window without progress anywhere (any completion refreshes
    # it) after which an operation gives up.
    _RETRY_MAX_ATTEMPTS: 6,
    _RETRY_PROGRESS_WINDOW_S: 120.0,
    # Backoff: min(2**attempt, cap) seconds times a jitter in [0.5, 1.5).
    _RETRY_BACKOFF_CAP_S: 32.0,
    # Circuit breaker (resilience/breaker.py): consecutive failed
    # operations before a backend fails fast, and how long it does so
    # before one probe is let through.
    _BREAKER_THRESHOLD: 5,
    _BREAKER_COOLDOWN_S: 30.0,
    # Striped storage I/O (storage/stripe.py): objects of at least
    # STRIPE_MIN_OBJECT_SIZE_BYTES move as concurrent parts of
    # STRIPE_PART_SIZE_BYTES, written and read in parallel.  0 turns
    # striping off; a threshold is floored at one part plus one byte.
    _STRIPE_PART_SIZE_BYTES: 64 * 1024 * 1024,
    _STRIPE_MIN_OBJECT_SIZE_BYTES: 128 * 1024 * 1024,
    # Per-part compression (codec.py): "raw" (off), "zlib", "zstd" and
    # "lz4" (optional modules: a missing one writes raw with one
    # warning) or "huff" (the native block-Huffman coder).  Digests stay
    # over the raw bytes.
    _CODEC: "raw",
    # The codec's level; 0 is each codec's own default.
    _CODEC_LEVEL: 0,
    # A part keeps its encoded frame only when raw size >= ratio * frame
    # size; others are stored raw behind a 24-byte header.
    _CODEC_MIN_RATIO: 1.05,
    # Tiered storage (tier/) when the tier options name no policy:
    # "write_back" acknowledges a take when the FAST tier commits and
    # promotes to the durable tier in the background (its
    # .snapshot_metadata lands after every data object); "write_through"
    # commits both tiers synchronously.
    _TIER_POLICY: "write_back",
    # Committed steps that keep a fast-tier copy under a tiered
    # SnapshotManager; older fast copies are evicted once their step is
    # durably committed (durable copies follow keep_last_n).
    _TIER_FAST_KEEP_LAST_N: 2,
    # Verify each fast-tier object against its recorded digest on first
    # read; a mismatch falls back to a peer or the durable copy and
    # repairs the fast one.  Needs WRITE_CHECKSUMS at take time.
    _TIER_VERIFY_FAST_READS: 1,
    # Shared-host object cache (storage/hostcache.py): a directory path
    # routes durable reads through a per-host cache, so co-located
    # readers fetch each object from the durable tier once (a cross-
    # process flock with single-flight fills).  "" = off.
    _CACHE_DIR: "",
    # Soft cap of the cache; a fill past it unlinks the oldest entries
    # by mtime (never truncates: live maps stay valid).  0 = unbounded.
    _CACHE_MAX_BYTES: 0,
    # Rank → host → slice placement (topology/): "auto" exchanges the
    # per-process hints below (and the hostname) once per operation over
    # the coordination KV; "flat" turns topology awareness off; an
    # explicit per-rank slice list ("0,0,1,1", alike on every process)
    # pins the map.
    _TOPOLOGY: "auto",
    # This process's slice id hint for "auto"; "" = a single slice.
    _TOPOLOGY_SLICE_ID: "",
    # This process's host identity hint for "auto"; "" = the hostname.
    _TOPOLOGY_HOST_ID: "",
    # Rank liveness (resilience/liveness.py): a peer whose heartbeat
    # stamp stops advancing for longer than this is declared dead (the
    # take's commit waits raise RankDeadError, the tier promoter skips it
    # in its done handshake).
    _LIVENESS_TIMEOUT_S: 30.0,
    # Heartbeat cadence, and the monitor's sampling floor.
    _LIVENESS_INTERVAL_S: 1.0,
    # Write takeover: 1 = when a rank dies mid-take, the survivors re-write
    # its replicated share from their own copies and commit (complete, or
    # degraded for state only the dead rank held); 0 = the take fails
    # with RankDeadError.
    _TAKEOVER: 1,
    # Fan-out restore (topology/fanout.py): a designated reader per slice
    # reads each replicated object once and hands the bytes to its
    # siblings.  "auto" = on for an explicit topology whose slice has
    # more than one rank (and is not one host under the shared cache);
    # "1"/"0" force.
    _FANOUT: "auto",
    # Bytes per KV value of a fan-out blob (before base64).
    _FANOUT_PART_BYTES: 4 * 1024 * 1024,
    # How long a sibling waits for its designated reader's publication
    # before the slice re-elects (and, after a second window, reads
    # direct in host-staggered waves).
    _FANOUT_TIMEOUT_S: 60.0,
    # Payload transport (transport/): "kv" = chunked base64 over the
    # coordination KV; "collective" = device tensors (a torch.distributed
    # broadcast on the transport's own group across processes, a device
    # round-trip in one process); "auto" = collective when
    # torch.distributed runs the coordinator's world, else kv.  A
    # collective that cannot run degrades to kv, counted in
    # transport.fallbacks.
    _TRANSPORT: "auto",
    # Payload bytes per collective part.
    _TRANSPORT_PART_BYTES: 8 * 1024 * 1024,
    # The bound of every wait of the collective engine (a gate key, an
    # offer, a broadcast); past it the transfer degrades to kv.
    _TRANSPORT_TIMEOUT_S: 30.0,
    # The continuous loop's kill-switch (continuous/loop.py): 0 makes
    # every ContinuousCheckpointer.step() a no-op.
    _CONTINUOUS: 1,
    # Promote the continuous store to the durable mirror every N steps
    # (the first step always); 0 = never (promote() still works).
    _CONTINUOUS_PROMOTE_EVERY_N: 16,
    # The SIGTERM grace window (resilience/preemption.py): every
    # registered drain shares one deadline this many seconds away.
    _CONTINUOUS_GRACE_S: 10.0,
    # An S3-compatible endpoint (minio, localstack) for every s3:// URL;
    # None = the AWS default.  The JAX package's legacy spelling
    # TSNP_S3_ENDPOINT_URL is not read: the port has only this one.
    _S3_ENDPOINT_URL: None,
}

_OVERRIDES: dict = {}


def _get_raw(name: str):
    """One resolution chain for every knob: override → env → default."""
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    env = os.environ.get(_ENV_PREFIX + name)
    if env is not None:
        return env
    return _DEFAULTS[name]


def _get_int(name: str) -> int:
    return int(_get_raw(name))


def get_max_chunk_size_bytes() -> int:
    return _get_int(_MAX_CHUNK_SIZE_BYTES)


def get_max_shard_size_bytes() -> int:
    return _get_int(_MAX_SHARD_SIZE_BYTES)


def get_slab_size_threshold_bytes() -> int:
    return _get_int(_SLAB_SIZE_THRESHOLD_BYTES)


def get_slab_host_member_max_bytes() -> int:
    return _get_int(_SLAB_HOST_MEMBER_MAX_BYTES)


def get_max_per_rank_io_concurrency() -> int:
    return _get_int(_MAX_PER_RANK_IO_CONCURRENCY)


def is_batching_disabled() -> bool:
    return bool(_get_int(_DISABLE_BATCHING))


def get_per_rank_memory_budget_bytes() -> Optional[int]:
    v = _get_int(_PER_RANK_MEMORY_BUDGET_BYTES)
    return v if v > 0 else None


def is_pickle_allowed() -> bool:
    return bool(_get_int(_ALLOW_PICKLE_OBJECTS))


def get_staging_threads() -> int:
    return max(1, _get_int(_STAGING_THREADS))


def is_eager_host_staging_disabled() -> bool:
    return bool(_get_int(_DISABLE_EAGER_HOST_STAGING))


def write_checksums_enabled() -> bool:
    return bool(_get_int(_WRITE_CHECKSUMS))


def verify_on_restore() -> bool:
    return bool(_get_int(_VERIFY_ON_RESTORE))


def get_replication_verify() -> str:
    v = str(_get_raw(_REPLICATION_VERIFY)).lower()
    if v not in ("full", "shape", "off"):
        raise ValueError(
            f"{_ENV_PREFIX}{_REPLICATION_VERIFY} must be full|shape|off, got {v!r}"
        )
    return v


def is_native_ext_enabled() -> bool:
    return bool(_get_int(_ENABLE_NATIVE_EXT))


def is_fs_verify_writes() -> bool:
    return bool(_get_int(_FS_VERIFY_WRITES))


def is_fs_sync_data() -> bool:
    return bool(_get_int(_FS_SYNC_DATA))


def fastio_enabled() -> bool:
    return bool(_get_int(_FASTIO))


def fastio_direct_enabled() -> bool:
    return bool(_get_int(_FASTIO_DIRECT))


def get_fastio_buffer_pool_bytes() -> int:
    return max(4 * 1024 * 1024, _get_int(_FASTIO_BUFFER_POOL_BYTES))


def is_trace_enabled() -> bool:
    return bool(_get_int(_TRACE))


def get_metrics_textfile() -> Optional[str]:
    """Path for the OpenMetrics textfile dump, or None when export is off
    (the default)."""
    v = str(_get_raw(_METRICS_TEXTFILE) or "").strip()
    return v or None


def cas_enabled() -> bool:
    """Content addressing for SnapshotManager saves by default (the
    manager's ``cas=`` overrides it either way)."""
    return bool(_get_int(_CAS))


def get_cas_chunk_size_bytes() -> int:
    return max(4096, _get_int(_CAS_CHUNK_SIZE_BYTES))


def get_cas_gc_grace_s() -> float:
    return max(0.0, float(_get_raw(_CAS_GC_GRACE_S)))


def mmap_enabled() -> bool:
    return bool(_get_int(_MMAP))


def get_failpoints() -> str:
    return str(_get_raw(_FAILPOINTS) or "")


def get_failpoint_seed() -> int:
    return _get_int(_FAILPOINT_SEED)


def get_retry_max_attempts() -> int:
    return max(1, _get_int(_RETRY_MAX_ATTEMPTS))


def get_retry_progress_window_s() -> float:
    return float(_get_raw(_RETRY_PROGRESS_WINDOW_S))


def get_retry_backoff_cap_s() -> float:
    return float(_get_raw(_RETRY_BACKOFF_CAP_S))


def get_breaker_threshold() -> int:
    return max(1, _get_int(_BREAKER_THRESHOLD))


def get_breaker_cooldown_s() -> float:
    return float(_get_raw(_BREAKER_COOLDOWN_S))


def get_stripe_part_size_bytes() -> int:
    return max(1, _get_int(_STRIPE_PART_SIZE_BYTES))


def get_stripe_min_object_size_bytes() -> Optional[int]:
    """The striping threshold, or None when striping is off (0).  Floored
    at one part plus one byte, so a striped object has two parts at
    least."""
    v = _get_int(_STRIPE_MIN_OBJECT_SIZE_BYTES)
    if v <= 0:
        return None
    return max(v, get_stripe_part_size_bytes() + 1)


def get_codec() -> str:
    """The write-side codec's name; ``codec.resolve_codec`` degrades an
    unknown or missing one to raw."""
    return str(_get_raw(_CODEC)).lower()


def get_codec_level() -> int:
    return _get_int(_CODEC_LEVEL)


def get_codec_min_ratio() -> float:
    return max(1.0, float(_get_raw(_CODEC_MIN_RATIO)))


def get_tier_policy() -> str:
    v = str(_get_raw(_TIER_POLICY)).lower()
    if v not in ("write_back", "write_through"):
        raise ValueError(
            f"{_ENV_PREFIX}{_TIER_POLICY} must be write_back|write_through, got {v!r}"
        )
    return v


def get_tier_fast_keep_last_n() -> int:
    return max(1, _get_int(_TIER_FAST_KEEP_LAST_N))


def tier_verify_fast_reads() -> bool:
    return bool(_get_int(_TIER_VERIFY_FAST_READS))


def get_cache_dir() -> Optional[str]:
    """The shared-host cache directory, or None when the cache is off."""
    v = str(_get_raw(_CACHE_DIR) or "").strip()
    return v or None


def get_cache_max_bytes() -> Optional[int]:
    v = _get_int(_CACHE_MAX_BYTES)
    return v if v > 0 else None


def get_s3_endpoint_url() -> Optional[str]:
    """The S3 endpoint, or None for the AWS default.  An active override
    masks the environment, ``override_s3_endpoint_url(None)`` included
    (it forces the default)."""
    if _S3_ENDPOINT_URL in _OVERRIDES:
        return _OVERRIDES[_S3_ENDPOINT_URL] or None
    return os.environ.get(_ENV_PREFIX + _S3_ENDPOINT_URL) or None


def get_topology() -> str:
    """"auto", "flat", or an explicit per-rank slice list ("0,0,1,1")."""
    return str(_get_raw(_TOPOLOGY)).strip().lower() or "auto"


def get_topology_slice_id() -> Optional[int]:
    v = str(_get_raw(_TOPOLOGY_SLICE_ID) or "").strip()
    return int(v) if v else None


def get_topology_host_id() -> Optional[str]:
    v = str(_get_raw(_TOPOLOGY_HOST_ID) or "").strip()
    return v or None


def get_liveness_timeout_s() -> float:
    return max(0.1, float(_get_raw(_LIVENESS_TIMEOUT_S)))


def get_liveness_interval_s() -> float:
    return max(0.01, float(_get_raw(_LIVENESS_INTERVAL_S)))


def takeover_enabled() -> bool:
    """Whether survivors take over a dead rank's writes and commit
    instead of failing the take."""
    return bool(_get_int(_TAKEOVER))


def get_fanout() -> str:
    """"on" | "off" | "auto"; any other value is "auto" with a warning
    (fan-out is an optimization, never worth failing a restore over)."""
    v = str(_get_raw(_FANOUT)).strip().lower()
    if v in ("1", "true", "on"):
        return "on"
    if v in ("0", "false", "off"):
        return "off"
    if v != "auto":
        _logger.warning(
            "TORCHSNAPSHOT_TPU_TORCH_FANOUT=%r is not auto/on/off; treating as auto", v,
        )
    return "auto"


def get_fanout_part_bytes() -> int:
    return max(4096, _get_int(_FANOUT_PART_BYTES))


def get_fanout_timeout_s() -> float:
    return max(0.0, float(_get_raw(_FANOUT_TIMEOUT_S)))


def get_transport() -> str:
    """"auto" | "collective" | "kv"; any other value is "auto" with a
    warning."""
    v = str(_get_raw(_TRANSPORT)).strip().lower()
    if v in ("collective", "kv"):
        return v
    if v != "auto":
        _logger.warning(
            "TORCHSNAPSHOT_TPU_TORCH_TRANSPORT=%r is not auto/collective/kv; "
            "treating as auto", v,
        )
    return "auto"


def get_transport_part_bytes() -> int:
    return max(4096, _get_int(_TRANSPORT_PART_BYTES))


def get_transport_timeout_s() -> float:
    return max(0.0, float(_get_raw(_TRANSPORT_TIMEOUT_S)))


def continuous_enabled() -> bool:
    return bool(_get_int(_CONTINUOUS))


def get_continuous_promote_every_n() -> int:
    return max(0, _get_int(_CONTINUOUS_PROMOTE_EVERY_N))


def get_continuous_grace_s() -> float:
    return max(0.0, float(_get_raw(_CONTINUOUS_GRACE_S)))


@contextlib.contextmanager
def _override(name: str, value) -> Iterator[None]:
    had = name in _OVERRIDES
    prev = _OVERRIDES.get(name)
    _OVERRIDES[name] = value
    try:
        yield
    finally:
        if had:
            _OVERRIDES[name] = prev
        else:
            _OVERRIDES.pop(name, None)


def override_max_chunk_size_bytes(value: int):
    return _override(_MAX_CHUNK_SIZE_BYTES, value)


def override_max_shard_size_bytes(value: int):
    return _override(_MAX_SHARD_SIZE_BYTES, value)


def override_slab_size_threshold_bytes(value: int):
    return _override(_SLAB_SIZE_THRESHOLD_BYTES, value)


def override_disable_batching(value: bool):
    return _override(_DISABLE_BATCHING, int(value))


def override_allow_pickle_objects(value: bool):
    return _override(_ALLOW_PICKLE_OBJECTS, int(value))


def override_disable_eager_host_staging(value: bool):
    return _override(_DISABLE_EAGER_HOST_STAGING, int(value))


def override_write_checksums(value: bool):
    return _override(_WRITE_CHECKSUMS, int(value))


def override_verify_on_restore(value: bool):
    return _override(_VERIFY_ON_RESTORE, int(value))


def override_replication_verify(value: str):
    return _override(_REPLICATION_VERIFY, value)


def override_enable_native_ext(value: bool):
    return _override(_ENABLE_NATIVE_EXT, int(value))


def override_fs_verify_writes(value: bool):
    return _override(_FS_VERIFY_WRITES, int(value))


def override_fs_sync_data(value: bool):
    return _override(_FS_SYNC_DATA, int(value))


def override_fastio(value: bool):
    return _override(_FASTIO, int(value))


def override_fastio_direct(value: bool):
    return _override(_FASTIO_DIRECT, int(value))


def override_fastio_buffer_pool_bytes(value: int):
    return _override(_FASTIO_BUFFER_POOL_BYTES, value)


def override_cas(value: bool):
    return _override(_CAS, int(value))


def override_cas_chunk_size_bytes(value: int):
    return _override(_CAS_CHUNK_SIZE_BYTES, value)


def override_cas_gc_grace_s(value: float):
    return _override(_CAS_GC_GRACE_S, value)


def override_mmap(value: bool):
    return _override(_MMAP, int(value))


def override_metrics_textfile(value):
    return _override(_METRICS_TEXTFILE, value or "")


def override_failpoint_seed(value: int):
    return _override(_FAILPOINT_SEED, value)


def override_retry_max_attempts(value: int):
    return _override(_RETRY_MAX_ATTEMPTS, value)


def override_retry_progress_window_s(value: float):
    return _override(_RETRY_PROGRESS_WINDOW_S, value)


def override_retry_backoff_cap_s(value: float):
    return _override(_RETRY_BACKOFF_CAP_S, value)


def override_breaker_threshold(value: int):
    return _override(_BREAKER_THRESHOLD, value)


def override_breaker_cooldown_s(value: float):
    return _override(_BREAKER_COOLDOWN_S, value)


def override_stripe_part_size_bytes(value: int):
    return _override(_STRIPE_PART_SIZE_BYTES, value)


def override_stripe_min_object_size_bytes(value: int):
    return _override(_STRIPE_MIN_OBJECT_SIZE_BYTES, value)


def override_codec(value: str):
    return _override(_CODEC, value)


def override_codec_level(value: int):
    return _override(_CODEC_LEVEL, value)


def override_codec_min_ratio(value: float):
    return _override(_CODEC_MIN_RATIO, value)


def override_tier_policy(value: str):
    return _override(_TIER_POLICY, value)


def override_cache_dir(value):
    return _override(_CACHE_DIR, value or "")


def override_cache_max_bytes(value: int):
    return _override(_CACHE_MAX_BYTES, value)


def override_s3_endpoint_url(value):
    return _override(_S3_ENDPOINT_URL, value)


def override_topology(value):
    return _override(_TOPOLOGY, value or "auto")


def override_topology_slice_id(value):
    return _override(_TOPOLOGY_SLICE_ID, "" if value is None else str(value))


def override_liveness_timeout_s(value: float):
    return _override(_LIVENESS_TIMEOUT_S, value)


def override_liveness_interval_s(value: float):
    return _override(_LIVENESS_INTERVAL_S, value)


def override_takeover(value: bool):
    return _override(_TAKEOVER, int(value))


def override_fanout(value):
    return _override(_FANOUT, value)


def override_fanout_part_bytes(value: int):
    return _override(_FANOUT_PART_BYTES, value)


def override_fanout_timeout_s(value: float):
    return _override(_FANOUT_TIMEOUT_S, value)


def override_transport(value):
    return _override(_TRANSPORT, value or "auto")


def override_transport_part_bytes(value: int):
    return _override(_TRANSPORT_PART_BYTES, value)


def override_transport_timeout_s(value: float):
    return _override(_TRANSPORT_TIMEOUT_S, value)


def override_continuous(value: bool):
    return _override(_CONTINUOUS, int(value))


def override_continuous_promote_every_n(value: int):
    return _override(_CONTINUOUS_PROMOTE_EVERY_N, value)


def override_continuous_grace_s(value: float):
    return _override(_CONTINUOUS_GRACE_S, value)


@contextlib.contextmanager
def override_failpoints(value: str) -> Iterator[None]:
    """Override FAILPOINTS and re-arm the failpoint registry on entry and
    on exit.  A malformed spec raises here."""
    from .resilience import failpoints as _failpoints

    try:
        with _override(_FAILPOINTS, value or ""):
            _failpoints.refresh_from_knobs(strict=True)
            yield
    finally:
        _failpoints.refresh_from_knobs(strict=False)


@contextlib.contextmanager
def override_trace(value) -> Iterator[None]:
    """Override TRACE and refresh the tracer's module-level enabled flag
    on entry and on exit (the flag is the disabled path's one check, so
    it tracks the knob instead of re-reading it per span)."""
    from .obs import tracer as _tracer

    try:
        with _override(_TRACE, int(bool(int(value)))):
            _tracer.refresh_enabled()
            yield
    finally:
        _tracer.refresh_enabled()
