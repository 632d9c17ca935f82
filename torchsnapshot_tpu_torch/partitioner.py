"""Replicated-write load balancing across ranks.

Counterpart of ``torchsnapshot_tpu/partitioner.py`` without its
topology-aware (slice → host → rank) chooser and write-takeover
election, which arrive with the multi-rank slice.  The partition is a
pure deterministic function of its inputs, so every rank computes the
same assignment without communication.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def partition_replicated_writes(
    items: Sequence[Tuple[str, int]],
    world_size: int,
    preloads: Sequence[int] = (),
) -> Dict[str, int]:
    """Assign each replicated logical path to exactly one writer rank:
    largest item first to the least-loaded rank (``preloads``: bytes each
    rank already writes), ties broken by rank."""
    loads: List[int] = list(preloads) if preloads else [0] * world_size
    if len(loads) != world_size:
        raise ValueError(f"preloads len {len(loads)} != world_size {world_size}")
    assignment: Dict[str, int] = {}
    for path, nbytes in sorted(items, key=lambda kv: (-kv[1], kv[0])):
        writer = min(range(world_size), key=lambda r: (loads[r], r))
        assignment[path] = writer
        loads[writer] += nbytes
    return assignment
