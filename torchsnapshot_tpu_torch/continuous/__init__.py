"""Continuous checkpointing: the per-rank state mirror's store.

Counterpart of ``torchsnapshot_tpu/continuous``, of which only the
store (``store.py``) is ported: ``Snapshot.repair_degraded`` and
``SnapshotManager.repair`` read the dead rank's mirror through it, and
either package reads and writes the other's mirrors.  The loop
(``ContinuousCheckpointer``), its recovery ladder and heartbeat are
ROADMAP queue A item 5, still to port.
"""

from __future__ import annotations

from .store import (  # noqa: F401
    HEAD_FNAME,
    ContinuousStore,
    decode_leaf,
    encode_leaf,
    step_manifest_path,
)

__all__ = [
    "ContinuousStore",
    "HEAD_FNAME",
    "decode_leaf",
    "encode_leaf",
    "step_manifest_path",
]
