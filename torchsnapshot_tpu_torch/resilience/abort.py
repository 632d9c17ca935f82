"""Cross-rank abort: the KV "poison" protocol's types and encoding.

Counterpart of ``torchsnapshot_tpu/resilience/abort.py``.  When a rank
hits an unrecoverable error in a take it *poisons* the operation's
scope: one KV key every peer can see.  Abort-aware waits
(``Coordinator.kv_get``/``barrier`` inside an ``abort_scope``) poll that
key while they block, so every rank raises a typed
``SnapshotAbortedError`` naming the origin rank and cause within a poll
interval instead of waiting out the timeout.  Rank 0 checks the key
again just before it writes ``.snapshot_metadata``, so a poisoned take
never commits.  The protocol itself lives on ``Coordinator``
(``coordination.py``); this module holds plain types and their encoding.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

# poison keys live outside every uid namespace the coordinators generate
# (commit/N, bar/N, ...)
POISON_PREFIX = "__poison__"


def poison_key(scope: str) -> str:
    return f"{POISON_PREFIX}/{scope}"


@dataclasses.dataclass(frozen=True)
class AbortInfo:
    """What a poison key carries: who aborted, where, and why."""

    origin_rank: int
    cause: str
    site: str = ""


class SnapshotAbortedError(RuntimeError):
    """A distributed snapshot operation was aborted by a peer (the origin
    rank and its cause are named here) or by this rank."""

    def __init__(self, info: AbortInfo, scope: str = "") -> None:
        self.info = info
        self.scope = scope
        super().__init__(
            f"snapshot operation aborted by rank {info.origin_rank}"
            + (f" at {info.site}" if info.site else "")
            + (f" (scope {scope})" if scope else "")
            + f": {info.cause}"
        )


def encode_poison(info: AbortInfo) -> str:
    return json.dumps(
        {"origin_rank": info.origin_rank, "cause": info.cause, "site": info.site}
    )


def decode_poison(raw: str) -> Optional[AbortInfo]:
    """A torn or garbled poison value still aborts (with an opaque cause)
    rather than wedging the waiter."""
    try:
        d = json.loads(raw)
        return AbortInfo(
            origin_rank=int(d.get("origin_rank", -1)),
            cause=str(d.get("cause", "")),
            site=str(d.get("site", "")),
        )
    except (ValueError, TypeError, AttributeError):
        return AbortInfo(origin_rank=-1, cause=f"unparseable poison: {raw!r}")
