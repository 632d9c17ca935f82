"""Resilience: cross-rank abort, fault injection, retry and circuit
breaking.

Counterpart of ``torchsnapshot_tpu/resilience/``:

- ``abort``: the KV poison protocol's types (``SnapshotAbortedError``);
- ``failpoints``: the seeded fault-injection registry threaded through
  the storage plugins and the scheduler's pipelines;
- ``retry``: the shared retry and backoff policy with per-backend
  classifiers;
- ``breaker``: per-backend circuit breakers;
- ``liveness``: heartbeat stamps and dead-rank detection (the tier
  promoter's done handshake).

Not ported: ``preemption`` and the take path's liveness scope (ROADMAP
queue A item 5).
"""

from __future__ import annotations

from .abort import (  # noqa: F401
    AbortInfo,
    SnapshotAbortedError,
    decode_poison,
    encode_poison,
    poison_key,
)
from .breaker import (  # noqa: F401
    CircuitBreaker,
    CircuitOpenError,
    get_breaker,
    reset_breakers,
)
from .failpoints import (  # noqa: F401
    InjectedClientError,
    failpoint,
    parse_failpoints,
    refresh_from_knobs as refresh_failpoints,
    release_hangs,
)
from .liveness import (  # noqa: F401
    DegradedSnapshotError,
    LivenessMonitor,
    LivenessSession,
    RankDeadError,
)
from .retry import (  # noqa: F401
    FATAL,
    MISSING,
    RAISE,
    SUCCESS_NONE,
    TRANSIENT,
    SharedProgress,
    classify_fs,
    classify_generic,
    classify_s3,
    lazy_shared_progress,
    retry_call,
)

__all__ = [
    "AbortInfo",
    "SnapshotAbortedError",
    "DegradedSnapshotError",
    "LivenessMonitor",
    "LivenessSession",
    "RankDeadError",
    "poison_key",
    "encode_poison",
    "decode_poison",
    "CircuitBreaker",
    "CircuitOpenError",
    "get_breaker",
    "reset_breakers",
    "InjectedClientError",
    "failpoint",
    "parse_failpoints",
    "refresh_failpoints",
    "release_hangs",
    "SharedProgress",
    "retry_call",
    "lazy_shared_progress",
    "classify_fs",
    "classify_s3",
    "classify_generic",
    "TRANSIENT",
    "MISSING",
    "FATAL",
    "RAISE",
    "SUCCESS_NONE",
]
