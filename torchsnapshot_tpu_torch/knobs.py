"""Main-path knobs with env-var overrides and context-manager test hooks.

PyTorch counterpart of ``torchsnapshot_tpu/knobs.py``: the same knob
names and defaults, read from ``TORCHSNAPSHOT_TPU_TORCH_``-prefixed
environment variables.  Only the knobs the take/restore main path reads
are carried; the rest arrive with the modules that read them.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

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
    # Content-addressed chunk store for SnapshotManager saves (cas/).  Not
    # ported yet: 1 makes the manager raise NotImplementedError.
    _CAS: 0,
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
    return bool(_get_int(_CAS))


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


def override_metrics_textfile(value):
    return _override(_METRICS_TEXTFILE, value or "")


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
