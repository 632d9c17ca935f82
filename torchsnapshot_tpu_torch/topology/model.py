"""The topology model: rank → host → slice placement.

Counterpart of ``torchsnapshot_tpu/topology/model.py``.  ``Topology`` is
an immutable, identical-on-every-process placement; ``detect_topology``
builds it from the ``TOPOLOGY`` knob:

- an explicit per-rank slice list (``"0,0,1,1"``, optionally
  ``"0/h0,..."`` with host ids): parsed with no communication;
- ``"flat"``: topology awareness off;
- ``"auto"``: each process's hints (``TOPOLOGY_SLICE_ID``,
  ``TOPOLOGY_HOST_ID`` or the hostname) are exchanged once per operation
  over the coordination KV (``kv_exchange`` under the caller's prefix).

The JAX package also probes the local jax device's multislice
``slice_index`` (``_jax_slice_hint``); a torch process has no such
device attribute, so the port's slice hint comes from the knob (or the
caller) alone.  ``replica_candidate_order`` is the tier's replica
placement rule (``tier/plugin.py``); ``designated_reader`` and
``reader_candidates`` are the fan-out restore's (``fanout.py``), and the
writer elections of ``partitioner.py`` and ``preparers/sharded.py``
balance over ``slice_of``/``host_of``.
"""

from __future__ import annotations

import json
import logging
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import knobs, obs

logger = logging.getLogger(__name__)

# The last-detected topology of this process (``current_topology_info``).
_CURRENT: Optional["Topology"] = None

# Auto-detection memo: placement (hostname, knob hints) is static for a
# process's lifetime, so the O(world) KV gather runs once per (knob
# values, world, rank) instead of once per
# take/restore — at 1k ranks that's the difference between O(world²)
# KV gets per checkpoint step and O(world) sets.  The rank is part of
# the key so thread-per-rank test harnesses sharing one process each
# detect their own view.  Every rank still PUBLISHES its hint on every
# operation (one idempotent kv_set), so a peer whose cache key changed
# mid-job (knob flip) re-gathers without wedging on absent keys.
_DETECT_CACHE: Dict[Tuple, "Topology"] = {}


def _dense(ids: Sequence[Any]) -> Tuple[int, ...]:
    """Remap arbitrary (sortable-as-string) ids to dense 0..K-1, stable
    under the sorted order of their string forms — identical on every
    process given identical inputs."""
    order = {v: i for i, v in enumerate(sorted({str(x) for x in ids}))}
    return tuple(order[str(x)] for x in ids)


class Topology:
    """Immutable rank → (slice, host) placement for one job.

    ``explicit`` records whether the placement carries REAL co-location
    information (a spec or exchanged hints) vs the trivial fallback —
    replica placement follows it only when explicit, so a job that
    configured nothing keeps the successor ring."""

    __slots__ = ("rank", "world_size", "slice_of", "host_of", "explicit")

    def __init__(
        self,
        rank: int,
        world_size: int,
        slice_of: Sequence[Any],
        host_of: Optional[Sequence[Any]] = None,
        explicit: bool = True,
    ) -> None:
        if len(slice_of) != world_size:
            raise ValueError(
                f"slice_of has {len(slice_of)} entries for "
                f"world_size={world_size}"
            )
        if host_of is not None and len(host_of) != world_size:
            raise ValueError(
                f"host_of has {len(host_of)} entries for "
                f"world_size={world_size}"
            )
        self.rank = rank
        self.world_size = world_size
        self.slice_of = _dense(slice_of)
        # unknown hosts default to one host per rank: no false
        # co-location, and host-load tie-breaks degrade to rank loads
        self.host_of = (
            _dense(host_of) if host_of is not None else tuple(range(world_size))
        )
        self.explicit = explicit

    @classmethod
    def flat(cls, rank: int, world_size: int) -> "Topology":
        """The trivial topology: one slice, one rank per host, no
        co-location knowledge — every topology-aware behavior off."""
        return cls(
            rank, world_size, (0,) * world_size, explicit=False
        )

    @classmethod
    def from_spec(cls, spec: str, rank: int, world_size: int) -> "Topology":
        """Parse an explicit per-rank slice list ("0,0,1,1").  Each
        element may optionally carry a host id ("0/h0,0/h1,...")."""
        fields = [f.strip() for f in spec.split(",") if f.strip()]
        if len(fields) != world_size:
            raise ValueError(
                f"topology spec has {len(fields)} entries for "
                f"world_size={world_size}: {spec!r}"
            )
        slices: List[str] = []
        hosts: List[Optional[str]] = []
        for f in fields:
            s, _, h = f.partition("/")
            slices.append(s)
            hosts.append(h or None)
        # "\x00" can never appear in a spec field, so a generated
        # placeholder for an unknown host can't collide with a
        # user-supplied host id (a collision would fabricate false
        # co-location — the dangerous direction)
        host_of = (
            [h if h is not None else f"\x00r{i}" for i, h in enumerate(hosts)]
            if any(h is not None for h in hosts)
            else None
        )
        return cls(rank, world_size, slices, host_of)

    # ------------------------------------------------------- structure

    @property
    def num_slices(self) -> int:
        return len(set(self.slice_of))

    @property
    def num_hosts(self) -> int:
        return len(set(self.host_of))

    @property
    def slice_id(self) -> int:
        return self.slice_of[self.rank]

    @property
    def host_id(self) -> int:
        return self.host_of[self.rank]

    def ranks_in_slice(self, slice_id: int) -> Tuple[int, ...]:
        return tuple(r for r in range(self.world_size) if self.slice_of[r] == slice_id)

    def hosts_in_slice(self, slice_id: int) -> Tuple[int, ...]:
        return tuple(sorted({self.host_of[r] for r in self.ranks_in_slice(slice_id)}))

    @property
    def multislice(self) -> bool:
        return self.num_slices > 1

    def co_located(self, a: int, b: int) -> bool:
        return self.host_of[a] == self.host_of[b]

    def designated_reader(self, key: str, slice_id: Optional[int] = None) -> int:
        """The rank of ``slice_id`` (default: this rank's) that reads
        ``key`` from the durable tier for its slice; alike on every
        process, consecutive keys spread over the slice's hosts."""
        return self.reader_candidates(key, slice_id)[0]

    def reader_candidates(
        self, key: str, slice_id: Optional[int] = None
    ) -> Tuple[int, ...]:
        """The slice's failover order for ``key``: every member in the
        stable (host, rank) order, rotated by the key's crc32 so the
        designated reader comes first.  When it dies mid-restore the
        siblings agree with no communication that ``candidates[1]`` takes
        over."""
        members = self.ranks_in_slice(self.slice_id if slice_id is None else slice_id)
        ordered = sorted(members, key=lambda r: (self.host_of[r], r))
        idx = zlib.crc32(key.encode()) % len(ordered)
        return tuple(ordered[idx:] + ordered[:idx])

    def replica_preference(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """Every OTHER rank, ordered best-replica-target-first for
        ``rank`` (default: this rank): different-SLICE ranks before
        same-slice ones, different-HOST before co-hosted within each
        group, ring distance as the deterministic tiebreak.  A slice
        preemption takes out every host in the slice at once, so a
        replica that survives it must live across the slice boundary —
        same-slice (and worst, same-host) targets are kept only as the
        tail so a single-slice job still gets its ring placement.
        Pure and identical on every process (same inputs), like every
        other Topology assignment."""
        r = self.rank if rank is None else rank
        n = self.world_size
        return tuple(
            sorted(
                (c for c in range(n) if c != r),
                key=lambda c: (
                    self.slice_of[c] == self.slice_of[r],
                    self.host_of[c] == self.host_of[r],
                    (c - r) % n,
                ),
            )
        )

    def describe(self) -> Dict[str, Any]:
        """Small JSON-safe summary for flight records / logs."""
        return {
            "slice": self.slice_id,
            "host": self.host_id,
            "num_slices": self.num_slices,
            "num_hosts": self.num_hosts,
            "explicit": self.explicit,
        }


def replica_candidate_order(
    topology: Optional["Topology"], rank: int, n: int
) -> Tuple[int, ...]:
    """The one candidate ordering of replica placement (the tier's
    targets, ``tier/plugin.py``): ``Topology.replica_preference`` when
    the topology is explicit AND sized for the peer list, else the
    successor ring.  The JAX package's rule, so both packages place a
    job's replicas on the same peers."""
    if (
        topology is not None
        and getattr(topology, "explicit", False)
        and topology.world_size == n
    ):
        return topology.replica_preference(rank)
    return tuple((rank + d) % n for d in range(1, n))


def current_topology_info() -> Optional[Dict[str, Any]]:
    """The last-detected topology's summary (flight-record stamp), or
    None when nothing EXPLICIT was detected — flat/unconfigured jobs
    keep their flight records free of a topology section nobody
    configured."""
    if _CURRENT is None or not _CURRENT.explicit:
        return None
    return _CURRENT.describe()


def _host_hint() -> str:
    override = knobs.get_topology_host_id()
    if override:
        return override
    import socket

    return socket.gethostname()


def detect_topology(
    coordinator: Any,
    exchange_prefix: Optional[str] = None,
    slice_hint: Optional[int] = None,
    host_hint: Optional[str] = None,
) -> Topology:
    """Build this job's Topology (see module docstring).  In "auto"
    mode with world > 1 this performs ONE kv_exchange under
    ``exchange_prefix`` (callers derive it from their operation uid so
    every take/restore's exchange uses fresh keys; when omitted, the
    per-instance uid counter names it — foreground program order only).
    ``slice_hint``/``host_hint`` override the knob and hostname probes
    for tests and embedders that know their placement."""
    with obs.span("topology/detect", rank=coordinator.rank):
        rank, world = coordinator.rank, coordinator.world_size
        spec = knobs.get_topology()
        if spec == "flat":
            topo = Topology.flat(rank, world)
        elif spec != "auto":
            try:
                topo = Topology.from_spec(spec, rank, world)
            except ValueError as e:
                logger.warning(
                    "rank %d: unusable TOPOLOGY spec (%s); running flat",
                    rank, e,
                )
                topo = Topology.flat(rank, world)
        else:
            s_hint = (
                slice_hint
                if slice_hint is not None
                else knobs.get_topology_slice_id()
            )
            h_hint = host_hint if host_hint is not None else _host_hint()
            if world == 1:
                topo = Topology(
                    rank, 1, (0,), (0,), explicit=s_hint is not None
                )
            else:
                if exchange_prefix is None:
                    exchange_prefix = coordinator._next_uid("topo")
                # publish ALWAYS (idempotent, one kv_set) so a peer
                # re-detecting under this operation's prefix never
                # waits on a key a cache-hitting rank skipped
                coordinator.kv_set(
                    f"{exchange_prefix}/{rank}",
                    json.dumps([s_hint, h_hint]),
                )
                cache_key = (spec, s_hint, h_hint, world, rank)
                cached = _DETECT_CACHE.get(cache_key)
                if cached is not None:
                    topo = cached
                else:
                    gathered = [
                        json.loads(
                            coordinator.kv_get(f"{exchange_prefix}/{r}")
                        )
                        for r in range(world)
                    ]
                    slice_hints = [g[0] for g in gathered]
                    hosts = [str(g[1]) for g in gathered]
                    known = [s for s in slice_hints if s is not None]
                    if known and len(known) != world:
                        # mixed hints are a misconfiguration (some
                        # ranks placed, others not) — co-location
                        # claims built on them would be wrong in the
                        # dangerous direction
                        logger.warning(
                            "rank %d: %d/%d ranks reported a slice "
                            "hint; ignoring partial placement and "
                            "running flat",
                            rank, len(known), world,
                        )
                    explicit = len(known) == world
                    slices = slice_hints if explicit else [0] * world
                    topo = Topology(
                        rank, world, slices, hosts, explicit=explicit
                    )
                    _DETECT_CACHE[cache_key] = topo
        global _CURRENT
        _CURRENT = topo
        obs.gauge(obs.TOPOLOGY_SLICES).set(topo.num_slices)
        return topo
