"""Control-plane coordination between ranks.

Counterpart of ``torchsnapshot_tpu/coordination.py``, single-process
only in this slice: ``LocalCoordinator`` is what ``take``/``restore``
use when no coordinator is given.  The KV-store coordinators, abort
scopes and liveness belong to the multi-rank slice.
"""

from __future__ import annotations


class LocalCoordinator:
    """The single-process coordinator: rank 0 of a world of one."""

    rank = 0
    world_size = 1


def get_default_coordinator() -> LocalCoordinator:
    return LocalCoordinator()
