"""Continuous checkpointing: sub-second peer deltas every step, with a
measured recovery time.

Counterpart of ``torchsnapshot_tpu/continuous``.  Preemptible fleets
should lose one step, not the minutes since the last durable snapshot.
The loop composes pieces the port already has (content-addressed chunk
deltas, budgeted background writes in the scheduler, the write-back
promoter, topology-aware placement, the payload transport and the
SIGTERM preemption hook):

- after every training step the CHANGED chunks of the flattened state
  go to this host's store and a peer host's, marker-last, so a store
  always names a complete step (``loop.py``);
- every N steps the local store promotes to a durable mirror through
  ``tier/promoter.py`` with a pinned HEAD;
- a preempted or killed host restores from the freshest source in
  seconds (``recover_state``, ``ContinuousCheckpointer.restore_latest``),
  falling back to the durable mirror when the peer is gone too.

Public surface: ``ContinuousCheckpointer``, ``recover_state``,
``ContinuousStore``, ``summary_block``.  Knobs: CONTINUOUS,
CONTINUOUS_PROMOTE_EVERY_N, CONTINUOUS_GRACE_S.  ``Snapshot.repair_degraded``
and ``SnapshotManager.repair`` read a dead rank's mirror through the store,
and either package reads and writes the other's stores.
"""

from __future__ import annotations

from .loop import ContinuousCheckpointer, summary_block  # noqa: F401
from .recover import TemplateMismatchError, recover_state  # noqa: F401
from .store import (  # noqa: F401
    HEAD_FNAME,
    ContinuousStore,
    decode_leaf,
    encode_leaf,
    step_manifest_path,
)

__all__ = [
    "ContinuousCheckpointer",
    "ContinuousStore",
    "HEAD_FNAME",
    "TemplateMismatchError",
    "decode_leaf",
    "encode_leaf",
    "recover_state",
    "step_manifest_path",
    "summary_block",
]
