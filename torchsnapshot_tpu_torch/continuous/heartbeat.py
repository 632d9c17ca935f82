"""Peer liveness over the coordination KV: heartbeats stamped with steps.

Counterpart of ``torchsnapshot_tpu/continuous/heartbeat.py``, with its
key layout.  The KV has no TTLs, so liveness is progress: after each
replication a rank republishes ``{ns}/hb/{rank}`` as the step its peers
now hold for it (``-1`` while it has peers and none holds a complete
step), and a reader compares the stamps with its own step.  ``ns`` is
the checkpointer's namespace (a uid both ranks derive in program
order), and each rank deletes its key at a clean shutdown (``clear``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from .. import obs

logger = logging.getLogger(__name__)


def publish(coordinator: Any, ns: str, rank: int, step: int) -> None:
    """Best effort: a heartbeat never fails the replication it reports."""
    try:
        coordinator.kv_set(f"{ns}/hb/{rank}", str(int(step)))
    except Exception as e:  # noqa: BLE001 — telemetry only
        obs.swallowed_exception("continuous.heartbeat_publish", e)


def read_all(coordinator: Any, ns: str, world_size: int) -> Dict[int, Optional[int]]:
    """Every rank's last heartbeat step (None: never published, or
    cleared)."""
    out: Dict[int, Optional[int]] = {}
    for r in range(world_size):
        raw = coordinator.kv_try_get(f"{ns}/hb/{r}")
        try:
            out[r] = int(raw) if raw is not None else None
        except ValueError:
            logger.warning("malformed heartbeat for rank %d under %r: %r", r, ns, raw)
            out[r] = None
    return out


def clear(coordinator: Any, ns: str, rank: int) -> None:
    """Drop this rank's heartbeat key (publish's pair, at shutdown)."""
    coordinator.kv_try_delete(f"{ns}/hb/{rank}")
