"""Composite tiered storage: a fast local tier over a durable tier.

Counterpart of ``torchsnapshot_tpu/tier/plugin.py``.
``TieredStoragePlugin`` fans every snapshot write across two ordinary
``StoragePlugin``s, a *fast* tier (a local directory, ``memory://``) and a
*durable* one, and serves reads fast-first:

- **write_through**: the durable write is synchronous and authoritative;
  the fast copy is best-effort (a failed fast write costs later reads a
  fallback);
- **write_back**: the take is acknowledged when the FAST tier commits; the
  background promoter (``promoter.py``) copies the data objects to the
  durable tier under the staging budget and writes the durable
  ``.snapshot_metadata`` LAST, so an interrupted promotion leaves an
  aborted snapshot there, never a committed and incomplete one;
- **reads** hit the fast tier first.  Once ``prime_digests`` installed the
  committed metadata's digest table, the first read of each fast object
  checks it whole against its recorded (crc32, size) — through the map,
  when the read maps (a map is private, ``ACCESS_COPY``: nothing written
  to it reaches the file).  A miss or a mismatch falls back to a peer
  replica, then the durable tier, and REPAIRS the fast copy by a new
  write (temp file and rename, never through a map).  Fast
  ``.snapshot_metadata`` is served only after its self-checksum parses.
  A per-fast-root circuit breaker sends reads straight to the fallback
  while a local disk keeps failing;
- **peer replicas**: with ``replica_count > 0``, ``finalize_take`` mirrors
  this rank's fast payloads into ``replica_count`` other ranks' fast
  roots, chosen by ``topology.replica_candidate_order`` (the JAX
  package's rule, so both packages place a job's replicas alike);
- ``link_from`` (incremental ``base=``) links in the durable tier; the
  fast tier holds no copy of a linked object until a read repairs it.

Built by ``url_to_storage_plugin(url, {"tier": {...}})`` or a tiered
``SnapshotManager``.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

from .. import knobs, obs
from ..io_types import ReadIO, StoragePlugin, WriteIO, is_mmap_backed
from ..resilience import get_breaker
from .promoter import PromotionGroup, get_promoter

logger = logging.getLogger(__name__)

_METADATA_FNAME = ".snapshot_metadata"  # == snapshot.SNAPSHOT_METADATA_FNAME
# telemetry sidecar (obs/aggregate.py), written by rank 0 AFTER
# finalize_take already handed the data objects to the promoter — it
# must never join group.paths (a post-enqueue mutation would race the
# running data job, and recovery would treat a missing record as a
# missing payload).  The promoter's commit job copies it best-effort
# just before the durable marker instead.
_OBSRECORD_FNAME = ".snapshot_obsrecord"


class _FastTierCorrupt(Exception):
    """Internal: the fast-tier copy failed its integrity check."""


def _as_bytes_view(buf: Any) -> memoryview:
    return memoryview(buf).cast("B")


def _metadata_intact(buf: Any) -> bool:
    """Parse-validate a ``.snapshot_metadata`` payload (its built-in
    self-checksum trailer makes any bit flip fail the load)."""
    from ..manifest import SnapshotMetadata

    try:
        SnapshotMetadata.from_yaml(bytes(_as_bytes_view(buf)).decode())
        return True
    except Exception:  # noqa: BLE001 — any failure means "don't serve it"
        return False


@obs.instrument_storage("tier")
class TieredStoragePlugin(StoragePlugin):
    def __init__(
        self,
        fast: StoragePlugin,
        durable: StoragePlugin,
        fast_url: str,
        durable_url: str,
        policy: Optional[str] = None,
        replica_count: int = 0,
        peer_fast_urls: Optional[List[str]] = None,
        verify_fast_reads: Optional[bool] = None,
    ) -> None:
        self.fast = fast
        self.durable = durable
        self.fast_url = fast_url.rstrip("/")
        self.durable_url = durable_url.rstrip("/")
        self.policy = policy or knobs.get_tier_policy()
        if self.policy not in ("write_back", "write_through"):
            raise ValueError(
                f"tier policy must be write_back|write_through, "
                f"got {self.policy!r}"
            )
        self.replica_count = int(replica_count)
        # all ranks' fast roots, indexed by rank (may include our own).
        # Exchanged lazily at finalize_take on the commit thread while
        # loop-side reads consult it for peer-repair candidates — every
        # touch goes through _peer_lock
        self._peer_lock = threading.Lock()
        self._peer_urls = (
            [u.rstrip("/") for u in peer_fast_urls]
            if peer_fast_urls
            else None
        )
        self._verify_reads = (
            knobs.tier_verify_fast_reads()
            if verify_fast_reads is None
            else bool(verify_fast_reads)
        )
        # fused digests come from whichever tier takes the synchronous
        # authoritative write
        auth = self.fast if self.policy == "write_back" else self.durable
        self.supports_fused_digest = bool(
            getattr(auth, "supports_fused_digest", False)
        )
        # zero-copy serving: reads are fast-first, so the composite can
        # honor want_mmap whenever the fast tier can (the durable
        # fallback may still copy — an s3 GET has no pages to map; a
        # cache-wrapped durable tier maps fine).  Budget exemption is
        # STRICTER: only when BOTH legs are exempt — a composite that
        # can decline into a whole-object cloud GET on its degraded
        # path must keep budgeted, striped reads there (the scheduler
        # keys on mmap_budget_exempt; see io_types.StoragePlugin).
        self.supports_mmap_read = bool(
            getattr(fast, "supports_mmap_read", False)
        )
        self.mmap_budget_exempt = bool(
            getattr(fast, "mmap_budget_exempt", False)
            and getattr(durable, "mmap_budget_exempt", False)
        )
        # location → [crc32, adler32, size] primed from committed
        # metadata (Snapshot._prime_tier_digests); gates read-side
        # verification of fast/peer copies
        self._digests: Dict[str, List[int]] = {}
        self._verified: set = set()
        self._bad_fast: set = set()
        self._group = PromotionGroup(self.fast_url, self.durable_url)
        # fast-tier circuit breaker (resilience/breaker.py): consecutive
        # fast-read failures (corrupt copies, a dying local disk) trip
        # reads straight onto the replica/durable fallback path without
        # paying a doomed local attempt each; a half-open probe after
        # the cooldown re-admits a recovered disk.  Keyed by fast root —
        # every plugin instance over the same local tier shares it.
        self._fast_breaker = get_breaker(f"tier.fast:{self.fast_url}")
        self._replica_target_urls: List[str] = []
        self._peer_plugins: Dict[str, StoragePlugin] = {}
        m = obs.REGISTRY
        self._m_hits = m.counter(obs.TIER_FAST_HITS)
        self._m_misses = m.counter(obs.TIER_FAST_MISSES)
        self._m_repairs = m.counter(obs.TIER_FAST_REPAIRS)
        self._m_corrupt = m.counter(obs.TIER_FAST_CORRUPT)
        self._m_peer_hits = m.counter(obs.TIER_PEER_HITS)
        self._m_replicated = m.counter(obs.BYTES_REPLICATED)

    # ------------------------------------------------------------ helpers

    def prime_digests(self, objects: Dict[str, Any]) -> None:
        """Install the committed metadata's whole-object digest table so
        fast/peer reads can be verified before they are trusted."""
        for loc, rec in (objects or {}).items():
            if isinstance(rec, (list, tuple)) and len(rec) == 3:
                self._digests[loc] = [int(x) for x in rec]

    def _peer_plugin(self, url: str) -> StoragePlugin:
        plugin = self._peer_plugins.get(url)
        if plugin is None:
            from ..storage import url_to_storage_plugin

            # peer fast roots are other hosts' local tiers: never layer
            # the shared-host cache over them (replica probes are
            # already one-hop local-network reads, and caching a peer's
            # copy would shadow later repairs)
            plugin = self._peer_plugins[url] = url_to_storage_plugin(
                url, {"host_cache": False}
            )
        return plugin

    def _digest_ok(self, path: str, buf: Any) -> bool:
        if path == _METADATA_FNAME:
            return _metadata_intact(buf)
        digest = self._digests.get(path)
        if digest is None:
            return True  # nothing recorded: trust the read
        from ..utils.checksums import crc32_fast

        view = _as_bytes_view(buf)
        return view.nbytes == digest[2] and crc32_fast(view) == digest[0]

    def _has_check(self, path: str) -> bool:
        return path == _METADATA_FNAME or (
            self._verify_reads and path in self._digests
        )

    # -------------------------------------------------------------- write

    async def write(self, write_io: WriteIO) -> None:
        if self.policy == "write_through":
            await self.durable.write(write_io)
            try:
                await self.fast.write(
                    WriteIO(
                        path=write_io.path,
                        buf=write_io.buf,
                        durable=write_io.durable,
                    )
                )
                if write_io.path != _OBSRECORD_FNAME:
                    self._group.paths.add(write_io.path)
                self._verified.add(write_io.path)
            except Exception as e:  # noqa: BLE001 — fast tier is a cache
                logger.warning(
                    "fast-tier write of %r failed (%r); reads will fall "
                    "back to the durable tier", write_io.path, e,
                )
                self._bad_fast.add(write_io.path)
            if write_io.durable:
                await self._replicate_metadata(write_io)
            return
        # write_back: fast tier is the ack point
        await self.fast.write(write_io)
        self._verified.add(write_io.path)
        if write_io.durable:
            # commit marker (.snapshot_metadata): replicate to peers so a
            # lost host's step is restorable cloud-free, then let the
            # promoter make it durable strictly AFTER the data objects
            await self._replicate_metadata(write_io)
            group = self._group
            if group.uid is None:
                # direct plugin use without Snapshot's finalize_take
                # hook: promote the data objects anyway, strictly ahead
                # of the commit marker (single-FIFO ordering)
                get_promoter().enqueue_data(group)
            get_promoter().enqueue_commit(group)
        elif write_io.path != _OBSRECORD_FNAME:
            self._group.paths.add(write_io.path)

    async def _replicate_metadata(self, write_io: WriteIO) -> None:
        for url in self._replica_target_urls:
            try:
                await self._peer_plugin(url).write(
                    WriteIO(path=write_io.path, buf=write_io.buf)
                )
                self._m_replicated.inc(_as_bytes_view(write_io.buf).nbytes)
            except Exception as e:  # noqa: BLE001 — replicas best-effort
                logger.warning(
                    "metadata replica to %r failed: %r", url, e
                )

    # --------------------------------------------------------------- read

    async def read(self, read_io: ReadIO) -> None:
        path = read_io.path
        # breaker first: with the fast tier tripped open, reads route
        # straight to the replica/durable fallback (allow() also admits
        # the half-open probe after the cooldown)
        if path not in self._bad_fast and self._fast_breaker.allow():
            try:
                await self._read_fast_checked(read_io)
                self._m_hits.inc()
                self._fast_breaker.record_success()
                return
            except FileNotFoundError:
                # a genuine miss (promotion-only object, evicted step)
                # says nothing about the disk's health: neither success
                # nor failure, but the half-open probe slot must be
                # released or the breaker wedges half-open
                self._fast_breaker.release_probe()
            except _FastTierCorrupt:
                self._fast_breaker.record_failure()
                self._m_corrupt.inc()
                logger.warning(
                    "fast-tier copy of %r failed its integrity check; "
                    "falling back", path,
                )
            except OSError as e:
                # a degraded local disk (EIO, stale mount) is at least
                # as likely as a bit flip — treat it as a miss and fall
                # back rather than aborting a restore the durable tier
                # can still serve
                self._fast_breaker.record_failure()
                logger.warning(
                    "fast-tier read of %r failed (%r); falling back",
                    path, e,
                )
            except BaseException:
                # cancellation (or any unclassified error) propagates —
                # but never with the half-open probe slot still claimed
                self._fast_breaker.release_probe()
                raise
            self._bad_fast.add(path)
        self._m_misses.inc()
        await self._fallback_read(read_io)

    async def _read_fast_checked(self, read_io: ReadIO) -> None:
        path = read_io.path
        if self._has_check(path) and path not in self._verified:
            # verify-through-the-map (the copy-on-verify decision): a
            # want_mmap probe maps the fast copy and the digest pass
            # reads every page through it RIGHT HERE — a file truncated
            # or corrupted before this point fails the checksum inside
            # ordinary exception handling (→ _FastTierCorrupt → peer/
            # durable fallback + repair) instead of a later SIGBUS, and
            # the verified mapping is then served without any heap copy.
            # Defensively copying instead would forfeit zero-copy for
            # every verified read; our own eviction paths unlink (never
            # truncate), so a mapping that passed this check stays valid
            # for its lifetime (see storage.fs.mmap_read).
            probe = ReadIO(path=path, want_mmap=read_io.want_mmap)
            await self.fast.read(probe)
            if not self._digest_ok(path, probe.buf):
                raise _FastTierCorrupt(path)
            self._verified.add(path)
            self._serve(read_io, probe.buf)
            return
        await self.fast.read(read_io)

    @staticmethod
    def _serve(read_io: ReadIO, buf: Any) -> None:
        if read_io.byte_range is None:
            read_io.buf = buf
        else:
            start, end = read_io.byte_range
            view = _as_bytes_view(buf)[start:end]
            # a ranged serve from an mmap-backed probe stays a view —
            # pinning the mapping costs address space, not heap; any
            # other probe buffer is sliced by copy so the served range
            # doesn't pin the whole object
            read_io.buf = view if is_mmap_backed(buf) else bytes(view)

    async def _fallback_read(self, read_io: ReadIO) -> None:
        path = read_io.path
        # peers first: a replica hit keeps the restore off the cloud
        for url in self._peers_for_read(path):
            try:
                probe = ReadIO(path=path)
                await self._peer_plugin(url).read(probe)
                if not self._digest_ok(path, probe.buf):
                    logger.warning(
                        "peer copy of %r at %r failed its integrity "
                        "check; trying next source", path, url,
                    )
                    continue
                self._m_peer_hits.inc()
                await self._repair_fast(path, probe.buf)
                self._serve(read_io, probe.buf)
                return
            except FileNotFoundError:
                continue
            except Exception as e:  # noqa: BLE001 — dead/unreachable
                # peer (stale mount, EIO, network path down): exactly
                # the scenario replicas exist for — try the next source
                logger.warning(
                    "peer read of %r from %r failed (%r); trying next "
                    "source", path, url, e,
                )
                continue
        # durable tier, the source of truth.  Whole-object read when we
        # can repair (byte_range absent, or the object's true extent is
        # known from the digest table); otherwise a plain ranged read.
        digest = self._digests.get(path)
        if read_io.byte_range is None or digest is not None:
            # forward want_mmap: a cache-wrapped durable tier serves the
            # probe as a mapping (zero-copy all the way through the
            # fallback); a cloud plugin ignores the flag and copies
            probe = ReadIO(path=path, want_mmap=read_io.want_mmap)
            await self.durable.read(probe)
            if not self._digest_ok(path, probe.buf):
                raise RuntimeError(
                    f"durable-tier copy of {path!r} does not match its "
                    f"recorded digest — every tier is corrupt"
                )
            await self._repair_fast(path, probe.buf)
            self._serve(read_io, probe.buf)
            return
        await self.durable.read(
            inner := ReadIO(
                path=path,
                byte_range=read_io.byte_range,
                into=read_io.into,
                want_mmap=read_io.want_mmap,
            )
        )
        read_io.buf = inner.buf

    def _peers_for_read(self, path: str) -> List[str]:
        """Peer fast roots to probe, PROBABLE HOLDERS FIRST: locations
        are rank-prefixed (``<rank>/...``), and a rank's payloads live
        on its own fast root plus its ``replica_count`` successor ranks
        — so on a large job the writer-derived candidates usually hit
        before any of the world_size-2 dead probes.  Ordering only (the
        full list remains the tail): peer lists are not guaranteed
        rank-indexed when hand-configured, and topology-aware placement
        (_pick_replica_targets) may have put the replica on a
        different-slice rank instead of a successor — pruning could
        miss a replica that mere ordering cannot."""
        with self._peer_lock:
            peer_urls = self._peer_urls or ()
        peers = [u for u in peer_urls if u != self.fast_url]
        if len(peers) < 2:
            return peers
        rank_str, _, _rest = path.partition("/")
        if not rank_str.isdigit() or not peer_urls:
            return peers
        n = len(peer_urls)
        writer = int(rank_str) % n
        likely = [
            peer_urls[(writer + d) % n]
            for d in range(0, max(1, self.replica_count) + 1)
        ]
        ordered = [u for u in likely if u in peers]
        return ordered + [u for u in peers if u not in ordered]

    async def _repair_fast(self, path: str, buf: Any) -> None:
        if path == _METADATA_FNAME:
            # never re-materialize metadata through the read path: every
            # discovery sweep (manager steps()/_verify) reads metadata,
            # and repairing it would resurrect fast-tier step dirs that
            # fast retention just evicted.  Fast-tier metadata exists
            # exactly where a take (or explicit peer replication) put it.
            return
        try:
            await self.fast.write(
                WriteIO(path=path, buf=bytes(_as_bytes_view(buf)))
            )
            self._bad_fast.discard(path)
            self._verified.add(path)
            self._m_repairs.inc()
        except Exception as e:  # noqa: BLE001 — repair is best-effort
            logger.warning("fast-tier repair of %r failed: %r", path, e)

    # ------------------------------------------------------ other plugin ops

    async def delete(self, path: str) -> None:
        found = False
        for tier_plugin in (self.fast, self.durable):
            try:
                await tier_plugin.delete(path)
                found = True
            except FileNotFoundError:
                pass
        self._verified.discard(path)
        if not found:
            raise FileNotFoundError(path)

    async def stat(self, path: str) -> int:
        try:
            return await self.fast.stat(path)
        except FileNotFoundError:
            return await self.durable.stat(path)

    async def link_from(self, base_url: str, path: str) -> None:
        # dedup links target the durable tier (the base url is a durable
        # snapshot root); the fast tier keeps no copy — reads of a
        # deduped object fall back and repair on first access.  A failed
        # durable link propagates so the scheduler degrades to a normal
        # (tiered) write.
        await self.durable.link_from(base_url, path)
        self._group.linked.add(path)
        self._group.paths.discard(path)

    async def close(self) -> None:
        for plugin in (
            self.fast, self.durable, *self._peer_plugins.values()
        ):
            try:
                await plugin.close()
            except Exception as e:  # noqa: BLE001
                # best-effort teardown must not mask the take/restore
                # outcome, but a close failure (leaked fd, wedged
                # executor) should still be attributable
                obs.swallowed_exception("tier.plugin_close", e)
        self._peer_plugins.clear()

    # ----------------------------------------------------- take lifecycle

    def finalize_take(self, coordinator: Any, uid: str) -> None:
        """Called by Snapshot once this rank's writes all landed in the
        fast tier (before the commit barrier / metadata write):

        1. replicate this rank's fast-tier payloads to its peer ranks'
           fast roots (``replica_count`` > 0), exchanging fast-root URLs
           over the coordination KV when not statically configured;
        2. for write_back, hand the data objects to the background
           promoter and record the coordination handle its cross-rank
           done-handshake needs.

        KV-only (explicit keys) — safe from the async commit thread."""
        with self._peer_lock:
            peers = self._peer_urls
        if self.replica_count > 0:
            if peers is None and coordinator.world_size > 1:
                # the exchange is a collective — strictly outside the lock
                peers = [
                    u.rstrip("/")
                    for u in coordinator.kv_exchange(
                        f"{uid}/tierfast", self.fast_url
                    )
                ]
                with self._peer_lock:
                    self._peer_urls = peers
            if peers and len(peers) > 1:
                rank = (
                    peers.index(self.fast_url)
                    if self.fast_url in peers
                    else coordinator.rank
                )
                # deliberately detected EVERY take, not memoized here:
                # detect_topology's publish-always contract (each rank
                # kv_sets its hint under this op's prefix even on its
                # own cache hits) is what keeps the exchange symmetric
                # when one rank's earlier detection failed — a
                # per-plugin memo would leave that rank waiting on keys
                # cached peers never publish.  The O(world) gather is
                # already memoized inside detect_topology.
                self._replica_target_urls = self._pick_replica_targets(
                    peers, rank, self._detect_topology(coordinator, uid)
                )
                try:
                    self._replicate_group(self._replica_target_urls)
                except Exception as e:  # noqa: BLE001 — best-effort
                    logger.warning(
                        "peer replication for %r failed: %r",
                        self.durable_url, e,
                    )
        if self.policy == "write_back":
            group = self._group
            group.coordinator = coordinator
            group.uid = uid
            get_promoter().enqueue_data(group)

    @staticmethod
    def _detect_topology(coordinator: Any, uid: str) -> Any:
        """Best-effort rank→slice placement for replica target choice.
        Symmetric: every rank with replica_count > 0 reaches this from
        finalize_take, so the one-per-op placement exchange
        (kv_exchange under explicit keys) is background-thread-legal
        and never one-sided.  Any failure degrades to the plain ring
        placement — topology is an optimization, never a take
        blocker."""
        try:
            from ..topology import detect_topology

            return detect_topology(
                coordinator, exchange_prefix=f"{uid}/tiertopo"
            )
        except Exception as e:  # noqa: BLE001 — degrade to ring order
            obs.swallowed_exception("tier.topology_detect", e)
            return None

    def _pick_replica_targets(
        self, peers: List[str], rank: int, topology: Any = None
    ) -> List[str]:
        """The ``replica_count`` peer fast roots this rank mirrors its
        payloads to.  With an explicit topology, candidates are ordered
        by ``Topology.replica_preference`` — DIFFERENT-slice peers
        first, so a whole-slice preemption can never take out both the
        primary and its replica; flat/unknown topologies keep the
        successor-ring placement (byte-identical to the pre-topology
        behavior)."""
        from ..topology import replica_candidate_order

        order = [
            peers[c]
            for c in replica_candidate_order(topology, rank, len(peers))
        ]
        targets: List[str] = []
        for cand in order:
            if len(targets) >= self.replica_count:
                break
            if cand != self.fast_url and cand not in targets:
                targets.append(cand)
        return targets

    def _replicate_group(self, target_urls: List[str]) -> None:
        """Mirror this rank's fast-tier payloads into each target fast
        root (same relative paths — locations are globally unique within
        a snapshot, so peers' own copies can never collide).  Uses the
        scheduler's budgeted concurrent copy engine so multi-GB payloads
        don't serialize object-by-object on the take path."""
        if not target_urls or not self._group.paths:
            return
        from ..scheduler import (
            get_process_memory_budget_bytes,
            sync_execute_copy_reqs,
        )

        with obs.span(
            "tier/replicate", targets=len(target_urls),
            objects=len(self._group.paths),
        ):
            paths = sorted(self._group.paths)
            for url in target_urls:
                sync_execute_copy_reqs(
                    paths,
                    self.fast,
                    self._peer_plugin(url),
                    get_process_memory_budget_bytes(),
                    counter_name=obs.BYTES_REPLICATED,
                )
