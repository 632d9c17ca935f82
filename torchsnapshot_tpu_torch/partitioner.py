"""Replicated-write load balancing across ranks, slices and hosts.

Counterpart of ``torchsnapshot_tpu/partitioner.py``.  The partition is a
pure deterministic function of its inputs, so every rank computes the
same assignment without communication (one small gather of per-rank
preload bytes feeds it).

With an explicit ``Topology`` (identical on every rank), the least-loaded
choice is hierarchical: least-loaded slice first, least-loaded host
within it, then least-loaded rank, ties by rank.  Each replicated object
is still written once; the hierarchy decides by whom.  Without a
topology (or with a non-explicit one) the choice is the flat greedy.
``elect_takeover_writers`` re-assigns a dead writer's objects to the
live ranks by the same rules, preferring the dead writer's slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


def _topology_chooser(
    topology: Any, loads: List[int]
) -> Tuple[Callable[[int], Tuple], Callable[[int, int], None]]:
    """A (key, charge) pair balancing (slice, host, rank) loads.  The
    slice and host loads are kept from the same ``loads`` vector the
    greedy mutates, so the hierarchy composes with preloads and earlier
    assignments."""
    slice_loads = [0] * topology.num_slices
    host_loads = [0] * topology.num_hosts
    for r, load in enumerate(loads):
        slice_loads[topology.slice_of[r]] += load
        host_loads[topology.host_of[r]] += load

    def key(r: int) -> Tuple:
        return (
            slice_loads[topology.slice_of[r]],
            host_loads[topology.host_of[r]],
            loads[r],
            r,
        )

    def charge(r: int, nbytes: int) -> None:
        loads[r] += nbytes
        slice_loads[topology.slice_of[r]] += nbytes
        host_loads[topology.host_of[r]] += nbytes

    return key, charge


def _chooser(topology: Any, loads: List[int]):
    if topology is not None and getattr(topology, "explicit", False):
        return _topology_chooser(topology, loads)

    def key(r: int) -> Tuple:
        return (loads[r], r)

    def charge(r: int, nbytes: int) -> None:
        loads[r] += nbytes

    return key, charge


def _loads(preloads: Sequence[int], world_size: int) -> List[int]:
    loads: List[int] = list(preloads) if preloads else [0] * world_size
    if len(loads) != world_size:
        raise ValueError(f"preloads len {len(loads)} != world_size {world_size}")
    return loads


def partition_replicated_writes(
    items: Sequence[Tuple[str, int]],
    world_size: int,
    preloads: Sequence[int] = (),
    topology: Optional[Any] = None,
) -> Dict[str, int]:
    """Assign each replicated logical path to exactly one writer rank:
    largest item first to the least-loaded rank (``preloads``: bytes each
    rank already writes), ties broken by rank; slice → host → rank under
    an explicit ``topology``."""
    loads = _loads(preloads, world_size)
    key, charge = _chooser(topology, loads)
    assignment: Dict[str, int] = {}
    for path, nbytes in sorted(items, key=lambda kv: (-kv[1], kv[0])):
        writer = min(range(world_size), key=key)
        assignment[path] = writer
        charge(writer, nbytes)
    return assignment


def elect_takeover_writers(
    orphans: Sequence[Tuple[str, int]],
    dead_ranks: Sequence[int],
    world_size: int,
    preloads: Sequence[int] = (),
    topology: Optional[Any] = None,
    origin_of: Optional[Dict[str, int]] = None,
) -> Dict[str, int]:
    """Re-assign the replicated objects whose writer died (``orphans``:
    (logical_path, nbytes)) to live ranks, alike on every survivor.
    ``origin_of`` (path → dead writer) with an explicit topology prefers
    a live rank of the dead writer's slice, then the slice → host → rank
    order; greedy largest-first over the post-partition loads."""
    dead = set(dead_ranks)
    live = [r for r in range(world_size) if r not in dead]
    if not live:
        raise ValueError("takeover election with zero live ranks")
    loads = _loads(preloads, world_size)
    explicit = topology is not None and getattr(topology, "explicit", False)
    base_key, charge = _chooser(topology, loads)
    assignment: Dict[str, int] = {}
    for path, nbytes in sorted(orphans, key=lambda kv: (-kv[1], kv[0])):
        origin = (origin_of or {}).get(path)
        if explicit and origin is not None:
            dead_slice = topology.slice_of[origin]

            def key(r: int, dead_slice: int = dead_slice) -> Tuple:
                return (topology.slice_of[r] != dead_slice,) + base_key(r)
        else:
            key = base_key
        writer = min(live, key=key)
        assignment[path] = writer
        charge(writer, nbytes)
    return assignment
