"""Publication announce channel: the fast wake-up beside the durable
marker.

Counterpart of ``torchsnapshot_tpu/publish/announce.py``, with its key
and value.  The record and HEAD are the truth; one KV key per
publication root (``{ns}/pub/head`` → ``"<step>:<record path>"``),
re-set at every publication, only tells subscribers in milliseconds
instead of a poll interval.  Subscribers watch it with
``coordination.kv_watch`` and fall back to the durable poll, so a lost
announce (a publisher killed between marker and announce, a KV outage,
the knob off) costs latency, never correctness.  ``clear`` deletes the
key at a clean shutdown.
"""

from __future__ import annotations

import logging
import zlib
from typing import Any, Optional, Tuple

from .. import obs

logger = logging.getLogger(__name__)


def announce_key(ns: str) -> str:
    return f"{ns}/pub/head"


def announce(coordinator: Any, ns: str, step: int, record_path: str) -> bool:
    """Best-effort announce of a committed record; whether the KV write
    landed.  Never raises: the marker is already down."""
    try:
        coordinator.kv_set(announce_key(ns), f"{int(step)}:{record_path}")
        return True
    except Exception as e:  # noqa: BLE001 — announce is best-effort
        obs.counter(obs.PUBLISH_ANNOUNCE_FAILURES).inc()
        obs.swallowed_exception("publish.announce", e)
        return False


def current(coordinator: Any, ns: str) -> Optional[Tuple[int, str]]:
    """The announced ``(step, record path)``, or None (nothing announced,
    a failed probe, a malformed value): the subscriber's non-blocking
    precheck."""
    try:
        raw = coordinator.kv_try_get(announce_key(ns))
    except Exception as e:  # noqa: BLE001 — a KV outage degrades to the durable poll
        obs.swallowed_exception("publish.announce.current", e)
        return None
    return parse_announcement(raw)


def ns_for_root(root: str) -> str:
    """The announce namespace of a publication root, derived from its
    URL: publisher and subscribers are unrelated processes and share only
    the root."""
    root = root.rstrip("/")
    return f"tsnp-pub-{zlib.crc32(root.encode('utf-8')) & 0xFFFFFFFF:08x}"


def parse_announcement(raw: Optional[str]) -> Optional[Tuple[int, str]]:
    """``(step, record path)`` from an announce value; None for an absent
    or malformed one (which degrades to the durable poll)."""
    if raw is None:
        return None
    step_s, sep, path = str(raw).partition(":")
    if not sep or not step_s.isdigit() or not path:
        logger.warning("malformed publication announce: %r", raw)
        return None
    return int(step_s), path


def clear(coordinator: Any, ns: str) -> None:
    """Drop the announce key at a clean shutdown (``kv_try_delete`` is
    best-effort by contract)."""
    coordinator.kv_try_delete(announce_key(ns))
