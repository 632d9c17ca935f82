"""Fan-out restore: read each replicated object once per SLICE and hand
the bytes to the slice's other ranks.

Counterpart of ``torchsnapshot_tpu/topology/fanout.py``.  A flat restore
has every rank read every replicated object from the durable tier.
Here, for each shared object, a designated reader of each slice
(``Topology.designated_reader``, spread over the slice's hosts) makes
the one durable read and publishes the bytes over the payload transport
(``transport/``: a KV blob, a device registry entry, or a broadcast of
the restore's ``CollectiveFanoutSession``); its siblings consume the
publication instead of reading.

A dead reader degrades the slice, never wedges it, and never stampedes
the durable tier: a sibling that sees no publication within
``FANOUT_TIMEOUT_S`` does not read at once.  The next rank of
``Topology.reader_candidates`` (alike on every process, no
communication) takes the read and the publication over, and the others
wait one more window.  Only when that passes too do the siblings read
direct, host by host in waves ``_FALLBACK_STAGGER_S`` apart.
``topology.fanout_fallbacks`` counts affected objects, once per object
and rank.  A publication that fails its digest is never trusted (a
direct read instead); a publication that cannot be made costs the
siblings their savings, never the restore.

The wrapper goes OUTSIDE the shared-host cache, so the reader's one read
is itself host-deduplicated.  A slice whose ranks share one host under
the cache skips fan-out (the cache already covers it).  Only locations
under ``replicated/`` that every rank reads take part
(``shared_read_locations``): per-rank and sharded objects have their own
readers, and slab-batched objects live under a rank's namespace.  A
sibling's delivered bytes land in a buffer of its own (the read's
``into``, or a fresh array), never in the reader's mapped view.  Blob
prefixes (``_blob_prefix``) are the JAX package's.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import threading
import time
from typing import Any, Dict, Iterable, Optional, Set

import torch

from .. import knobs, obs
from ..io_types import ReadIO, StoragePlugin, WriteIO, resolve_read_destination
from ..resilience.failpoints import failpoint
from ..storage.hostcache import host_cache_active
from ..transport import TransportUnavailable, count_fallback
from .model import Topology

logger = logging.getLogger(__name__)

_SHARED_PREFIX = "replicated/"
# how often a sibling probes for its reader's publication
_FETCH_POLL_S = 0.025
# the spacing of the last-resort direct reads, per host
_FALLBACK_STAGGER_S = 0.05


def _single_host_cached(topology: Topology, members: Iterable[int]) -> bool:
    return host_cache_active() and len({topology.host_of[r] for r in members}) == 1


def fanout_enabled(topology: Topology) -> bool:
    """Whether this rank's restore fans out: "on" whenever its slice has
    siblings; "auto" also needs an explicit topology and skips a
    one-host slice the shared cache covers."""
    mode = knobs.get_fanout()
    if mode == "off":
        return False
    members = topology.ranks_in_slice(topology.slice_id)
    if len(members) < 2:
        return False
    if mode == "on":
        return True
    return topology.explicit and not _single_host_cached(topology, members)


def fanout_world_uniform(topology: Topology) -> bool:
    """Whether EVERY rank's ``fanout_enabled`` is True under this
    process's knobs: the collective session's precondition (its gates and
    broadcasts need every rank).  Computed from the global topology
    alone, so every process agrees."""
    mode = knobs.get_fanout()
    if mode == "off":
        return False
    for s in sorted(set(topology.slice_of)):
        members = topology.ranks_in_slice(s)
        if len(members) < 2:
            return False
        if mode == "auto" and (not topology.explicit or _single_host_cached(topology, members)):
            return False
    return True


def _entry_shared_locations(entry: Any) -> Iterable[str]:
    """The ``replicated/`` locations one replicated entry reads (the whole
    object, its shards or chunks)."""
    if not getattr(entry, "replicated", False):
        return
    loc = getattr(entry, "location", None)
    if isinstance(loc, str) and loc.startswith(_SHARED_PREFIX):
        yield loc
    for attr in ("shards", "chunks"):
        for piece in getattr(entry, attr, None) or ():
            ploc = getattr(piece, "location", None)
            if isinstance(ploc, str) and ploc.startswith(_SHARED_PREFIX):
                yield ploc


def shared_read_locations(manifest: Dict[str, Any]) -> Set[str]:
    """The locations every rank reads in a full restore: the
    ``replicated/`` extents of replicated entries.  Slab-batched leaves
    (under a rank's namespace) are left out: only one rank reads most of
    a slab's ranges."""
    out: Set[str] = set()
    for entry in manifest.values():
        out.update(_entry_shared_locations(entry))
    return out


def ordered_shared_locations(
    manifest: Dict[str, Any], shared: Set[str], key_order: Iterable[str]
) -> list:
    """``shared`` in the restore's read order: by the owning app key's
    place in ``key_order``, by location within a key.  The collective
    session's schedule advances with the restore's per-key barriers in
    this order."""
    pos = {k: i for i, k in enumerate(key_order)}
    best: Dict[str, int] = {}
    for p, entry in manifest.items():
        i = pos.get(p.split("/", 1)[0])
        if i is None:
            continue
        for loc in _entry_shared_locations(entry):
            if loc in shared and (loc not in best or i < best[loc]):
                best[loc] = i
    tail = sorted(p for p in shared if p not in best)
    return sorted(best, key=lambda loc: (best[loc], loc)) + tail


def _blob_prefix(uid: str, slice_id: int, path: str, byte_range: Any) -> str:
    """The KV prefix of one (object, byte range) publication, hashed so
    no object path collides with the key grammar."""
    h = hashlib.sha256()
    h.update(path.encode())
    if byte_range is not None:
        h.update(f"|{byte_range[0]}-{byte_range[1]}".encode())
    return f"{uid}/s{slice_id}/{h.hexdigest()[:32]}"


def _as_bytes(buf: Any) -> bytes:
    """A copy of a read's bytes that outlives its buffer (a mapped view
    included)."""
    if isinstance(buf, torch.Tensor):
        return buf.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
    return bytes(memoryview(buf).cast("B"))


async def publish_object(coordinator: Any, prefix: str, buf: Any, path: str) -> int:
    """Best-effort KV publication of one read's bytes for the slice;
    the number of parts written (0 on failure: the siblings fall back,
    and the failure shows as their ``fanout_fallbacks``)."""
    with obs.span("fanout/publish", path=path):
        try:
            failpoint("topology.fanout.publish", path=path)
            part = knobs.get_fanout_part_bytes()
            loop = asyncio.get_running_loop()
            data = buf if not isinstance(buf, torch.Tensor) else _as_bytes(buf)
            n = await loop.run_in_executor(None, coordinator.kv_publish_blob, prefix, data, part)
            obs.counter(obs.FANOUT_PUBLISHES).inc()
            obs.counter(obs.FANOUT_BYTES_REDISTRIBUTED).inc(n)
            return max(1, (n + part - 1) // part)
        except Exception as e:  # noqa: BLE001 — best-effort by contract
            obs.swallowed_exception("topology.fanout.publish", e)
            return 0


async def fetch_published(
    coordinator: Any, prefix: str, path: str, timeout_s: float, transport: Any = None,
) -> Optional[bytes]:
    """Poll for the publication of ``path`` from the event loop (one
    non-blocking probe per tick); the verified bytes, or None past the
    deadline or on a digest mismatch (the caller reads direct).  With a
    local ``transport`` its registry is probed first each tick (the
    publisher may have degraded to KV); ``TransportUnavailable`` turns
    the wait KV-only."""
    with obs.span("fanout/fetch", path=path):
        loop = asyncio.get_running_loop()
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                data = None
                if transport is not None:
                    try:
                        data = await loop.run_in_executor(None, transport.try_fetch, prefix)
                    except TransportUnavailable:
                        transport = None
                if data is None:
                    data = await loop.run_in_executor(None, coordinator.kv_try_fetch_blob, prefix)
                    if data is not None:
                        obs.counter(obs.TRANSPORT_KV_OPS).inc()
                        obs.counter(obs.TRANSPORT_KV_BYTES).inc(len(data))
            except ValueError as e:
                logger.warning(
                    "fan-out publication for %r failed verification (%s); "
                    "falling back to a direct read", path, e,
                )
                return None
            if data is not None:
                return data
            if time.monotonic() >= deadline:
                return None
            await asyncio.sleep(_FETCH_POLL_S)


class FanoutReadPlugin(StoragePlugin):
    """One restore's wrapper implementing read-once-per-slice over
    ``inner``: reads of shared locations go through the designated
    reader's election, everything else passes through."""

    def __init__(
        self,
        inner: StoragePlugin,
        coordinator: Any,
        topology: Topology,
        uid: str,
        shared_paths: Iterable[str],
        transport: Any = None,
    ) -> None:
        self.inner = inner
        self.coordinator = coordinator
        self.topology = topology
        self.uid = uid
        self.shared_paths = set(shared_paths)
        self.transport = transport
        # a CollectiveFanoutSession, attached once the restore has the
        # global key order; None = per-operation transport only
        self.transport_session: Any = None
        # the inner plugin's capabilities: non-shared reads keep its
        # mapped reads and budget exemption
        for cap in (
            "supports_mmap_read", "mmap_budget_exempt", "supports_striped_write",
            "supports_fused_digest", "supports_fused_part_digest",
        ):
            setattr(self, cap, bool(getattr(inner, cap, False)))
        # (engine, prefix, nparts) of this rank's publications, reclaimed
        # by cleanup_published after the restore's last barrier
        self._pub_lock = threading.Lock()
        self._published: list = []
        # the shared locations this rank reads for its slice: the read
        # scheduler puts them first (``publish_first``)
        self.local_publish_paths = {
            p for p in self.shared_paths if topology.designated_reader(p) == coordinator.rank
        }
        m = obs.REGISTRY
        self._m_durable = m.counter(obs.FANOUT_DURABLE_READS)
        self._m_saved = m.counter(obs.FANOUT_DURABLE_GETS_SAVED)
        self._m_fallbacks = m.counter(obs.FANOUT_FALLBACKS)
        # once per object: a striped object's ranged reads are one object
        self._fallback_paths: Set[str] = set()

    def _count_fallback(self, path: str) -> None:
        with self._pub_lock:
            if path in self._fallback_paths:
                return
            self._fallback_paths.add(path)
        self._m_fallbacks.inc()

    def _local_transport(self) -> Any:
        """The transport when it serves per-operation publish/fetch in
        this process (the collective engine's local mode)."""
        t = self.transport
        if t is not None and getattr(t, "mode", None) == "local":
            return t
        return None

    def _note_published(self, entry: Any) -> None:
        if entry is not None:
            with self._pub_lock:
                self._published.append(entry)

    async def _publish_payload(self, prefix: str, buf: Any, path: str):
        """Publish one read's bytes on the chosen engine; the cleanup
        ledger's entry or None.  A local collective publication that fails
        degrades this operation to KV (``transport.fallbacks``)."""
        t = self._local_transport()
        if t is not None:
            try:
                loop = asyncio.get_running_loop()
                data = buf if not isinstance(buf, torch.Tensor) else _as_bytes(buf)
                nparts = await loop.run_in_executor(None, t.publish, prefix, data)
                obs.counter(obs.FANOUT_PUBLISHES).inc()
                obs.counter(obs.FANOUT_BYTES_REDISTRIBUTED).inc(obs.buf_nbytes(buf))
                return ("collective", prefix, nparts)
            except Exception as e:  # noqa: BLE001 — the payload must still reach the siblings
                count_fallback("fanout-publish", e)
        nparts = await publish_object(self.coordinator, prefix, buf, path)
        if nparts:
            obs.counter(obs.TRANSPORT_KV_OPS).inc()
            obs.counter(obs.TRANSPORT_KV_BYTES).inc(obs.buf_nbytes(buf))
            return ("kv", prefix, nparts)
        return None

    async def _read_and_publish(self, read_io: ReadIO, prefix: str) -> None:
        """The designated reader's duty: one durable read, then publish."""
        await self.inner.read(read_io)
        self._m_durable.inc()
        self._note_published(await self._publish_payload(prefix, read_io.buf, read_io.path))

    def _deliver(self, read_io: ReadIO, data: Any) -> bool:
        """Place redistributed bytes in the read's destination; False on a
        mismatch (the caller reads direct).  A ``bytearray`` is the
        engine's copy, owned by this read: with no destination to honour it
        becomes the read's buffer as it is."""
        try:
            if read_io.into is None and isinstance(data, bytearray):
                read_io.buf = data
                self._m_saved.inc()
                return True
            out = resolve_read_destination(read_io.into, len(data))
            memoryview(out).cast("B")[:] = data
            read_io.buf = out
            self._m_saved.inc()
            return True
        except Exception as e:  # noqa: BLE001 — the direct read is always right
            obs.swallowed_exception("topology.fanout.deliver", e)
            return False

    async def _consume(self, session: Any, skey: Any) -> Optional[bytes]:
        """Wait on the event loop for the session to resolve ``skey``
        (bounded by the session's own timeouts)."""
        with obs.span("transport/collective_consume", path=skey[1]):
            while True:
                done, data = session.poll(skey)
                if done:
                    return data
                await asyncio.sleep(_FETCH_POLL_S / 5)

    async def read(self, read_io: ReadIO) -> None:
        path = read_io.path
        if path not in self.shared_paths:
            await self.inner.read(read_io)
            return
        prefix = _blob_prefix(self.uid, self.topology.slice_id, path, read_io.byte_range)
        session = self.transport_session
        skey = (self.topology.slice_id, path)
        if session is not None and not session.covers(skey):
            session = None
        loop = asyncio.get_running_loop()
        if path in self.local_publish_paths:
            if session is not None:
                if read_io.byte_range is not None:
                    # ranged reads ride KV blobs per range: siblings get
                    # "skip" at once instead of a timeout
                    session.decline(skey)
                else:
                    await self.inner.read(read_io)
                    self._m_durable.inc()
                    data = await loop.run_in_executor(None, _as_bytes, read_io.buf)
                    if session.offer(skey, data, prefix):
                        # the session owns delivery (a broadcast, or a KV
                        # blob from its drain path): no publication here
                        return
                    self._note_published(await self._publish_payload(prefix, data, path))
                    return
            await self._read_and_publish(read_io, prefix)
            return
        timeout_s = knobs.get_fanout_timeout_s()
        if session is not None and read_io.byte_range is None:
            data = await self._consume(session, skey)
            if data is not None and self._deliver(read_io, data):
                return
            # skipped, degraded or mismatched: the KV ladder below, which
            # the session's drain path or the source's own publish feeds
        data = await fetch_published(
            self.coordinator, prefix, path, timeout_s, transport=self._local_transport(),
        )
        if data is None:
            # the designated reader was silent past the deadline: the next
            # candidate (alike on every process) takes the read over while
            # the rest wait one more window
            cands = self.topology.reader_candidates(path)
            alternate = cands[1] if len(cands) > 1 else cands[0]
            if self.coordinator.rank == alternate:
                logger.warning(
                    "fan-out: designated reader rank %d published nothing for %r within "
                    "%gs; rank %d takes over the slice read", cands[0], path, timeout_s,
                    alternate,
                )
                self._count_fallback(path)
                await self._read_and_publish(read_io, prefix)
                return
            data = await fetch_published(
                self.coordinator, prefix, path, timeout_s, transport=self._local_transport(),
            )
            if data is None:
                # both elected readers silent: direct reads, host by host
                self._count_fallback(path)
                hosts_in_order: list = []
                for r in cands:
                    h = self.topology.host_of[r]
                    if h not in hosts_in_order:
                        hosts_in_order.append(h)
                my_host = self.topology.host_of[self.coordinator.rank]
                pos = hosts_in_order.index(my_host) if my_host in hosts_in_order else len(hosts_in_order)
                if pos:
                    await asyncio.sleep(_FALLBACK_STAGGER_S * pos)
                self._m_durable.inc()
                await self.inner.read(read_io)
                return
        if self._deliver(read_io, data):
            return
        self._count_fallback(path)
        self._m_durable.inc()
        await self.inner.read(read_io)

    def cleanup_published(self) -> None:
        """Delete this rank's publications (KV blobs meta first; registry
        entries with their announce keys).  Called after the restore's
        last barrier, when no rank still consumes.  Best-effort."""
        with self._pub_lock:
            published, self._published = self._published, []
        for engine, prefix, nparts in published:
            try:
                if engine == "collective" and self.transport is not None:
                    self.transport.cleanup(prefix, nparts)
                else:
                    self.coordinator.kv_try_delete(f"{prefix}/meta")
                    for i in range(nparts):
                        self.coordinator.kv_try_delete(f"{prefix}/p{i}")
            except Exception as e:  # noqa: BLE001 — best-effort cleanup
                obs.swallowed_exception("topology.fanout.cleanup", e)

    # ------------------------------------------------- pass-throughs

    async def write(self, write_io: WriteIO) -> None:
        await self.inner.write(write_io)

    async def begin_striped_write(self, path: str, total_size: int):
        return await self.inner.begin_striped_write(path, total_size)

    async def delete(self, path: str) -> None:
        await self.inner.delete(path)

    async def stat(self, path: str) -> int:
        return await self.inner.stat(path)

    async def link_from(self, base_url: str, path: str) -> None:
        await self.inner.link_from(base_url, path)

    async def close(self) -> None:
        await self.inner.close()
