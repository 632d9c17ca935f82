"""CollectiveTransport: payload bytes as device tensors, KV as control.

Counterpart of ``torchsnapshot_tpu/transport/collective.py``.  A payload
is cut into parts of at most ``TRANSPORT_PART_BYTES`` (``_plan_parts``:
the JAX package's part count, without its 128-byte lane padding, which
exists for the TPU's lanes) and moves as ``uint8`` tensors on
``device`` (the card unless the caller names another), either

- **session mode** (a process per rank, ``torch.distributed`` initialised
  with the coordinator's world and rank): one
  ``torch.distributed.broadcast`` per part on a process group the
  session creates for itself, with ``timeout=TRANSPORT_TIMEOUT_S`` and
  never the caller's default group.  The group is gloo, which
  broadcasts CUDA tensors too, so two ranks may share one card (an NCCL
  group, for a card per rank, is not built yet).  Collectives match by
  launch order, so the per-restore
  ``CollectiveFanoutSession`` fixes the transfer order up front (alike
  on every process, from the manifest) and gates each transfer with
  explicit KV keys: the source announces ``ok:<size>:<parts>:<digests>``
  or ``skip``, every other rank acks, and the source confirms ``go``
  before any rank enters the broadcast.  The sizes come from the source's
  announce of the exact payload, which the manifest fixes.  A timeout or
  an error breaks the session (a group that saw a failed collective is
  never used again): no further broadcast is entered, payloads already
  offered are re-published as KV blobs, and the siblings fall into the
  fan-out's KV ladder;
- **local mode** (one process): parts go onto the device into an
  in-process registry keyed by prefix, announced on the KV as
  ``{prefix}/xmeta`` (parts, part length, size, crc32, adler32), and a
  fetch copies them back to the host: a real host → device → host round
  trip.

Every payload is held against the crc32 + adler32 computed at
publication before a consumer may trust it, in both modes.

``device_move`` (either mode) is the continuous loop's peer-replica leg:
one staged payload goes onto the device in parts and back to the host,
verified against its digests, counted in ``transport.device_moves`` and
``transport.collective_bytes``.  It runs on the loop's replication
thread, so on the card its copies go on a side stream of the engine's
own (the parts are allocated in that stream's context and only that
stream is synchronised), never queued between the training loop's
kernels on the default stream.
"""

from __future__ import annotations

import datetime
import logging
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from .. import knobs, obs
from ..resilience.failpoints import failpoint
from ..utils.checksums import adler32_fast, crc32_fast
from . import Transport, TransportUnavailable, count_fallback

logger = logging.getLogger(__name__)

# local mode's registry: prefix → (device parts, payload bytes, crc32,
# adler32); module-global, since thread-simulated ranks share a process
_registry_lock = threading.Lock()
_REGISTRY: Dict[str, Tuple[List[torch.Tensor], int, int, int]] = {}

# the session group's backend (see the module docstring)
BACKEND = "gloo"


def _plan_parts(nbytes: int, part_bytes: int) -> Tuple[int, int]:
    """(nparts, bytes per part) of one payload: the JAX package's part
    count; every part but the last holds ``base`` bytes."""
    part = max(1, int(part_bytes))
    nparts = max(1, -(-nbytes // part))
    base = max(1, -(-nbytes // nparts))
    return nparts, base


def _spans(nbytes: int, nparts: int, base: int) -> List[Tuple[int, int]]:
    return [(i * base, min((i + 1) * base, nbytes)) for i in range(nparts)]


def _digests(view: Any) -> Tuple[int, int]:
    return crc32_fast(view), adler32_fast(view)


def _host_u8(view: memoryview) -> torch.Tensor:
    """A uint8 tensor over ``view``'s bytes (no copy).  The tensor is only
    read, so a read-only buffer is fine."""
    if view.nbytes == 0:
        return torch.empty(0, dtype=torch.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(view, dtype=torch.uint8)


def _to_host(parts: List[torch.Tensor], nbytes: int) -> bytearray:
    """The parts' bytes in one host buffer, which the consumer owns (the
    fan-out delivers it as the read's buffer without another copy)."""
    out = bytearray(nbytes)
    if nbytes:
        host = torch.frombuffer(out, dtype=torch.uint8)
        off = 0
        for p in parts:
            host[off:off + p.numel()].copy_(p)
            off += p.numel()
    return out


def _dist():
    import torch.distributed as dist

    return dist


class CollectiveTransport(Transport):
    engine = "collective"

    def __init__(
        self,
        coordinator: Any = None,
        topology: Any = None,
        require_session: bool = False,
        device: Any = "cuda",
    ) -> None:
        self.coordinator = coordinator
        self.topology = topology
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise TransportUnavailable("no CUDA device for the payload parts")
        self.session_capable = self._probe_session()
        if require_session and not self.session_capable:
            # auto: a one-process world, or processes without a process
            # group over the coordinator's world, stay on KV
            raise TransportUnavailable(
                "no torch.distributed process group over the coordinator's world"
            )
        self.mode = "session" if self.session_capable else "local"
        m = obs.REGISTRY
        self._m_ops = m.counter(obs.TRANSPORT_COLLECTIVE_OPS)
        self._m_bytes = m.counter(obs.TRANSPORT_COLLECTIVE_BYTES)
        self._m_lat = m.histogram(obs.TRANSPORT_COLLECTIVE_S)
        self._m_moves = m.counter(obs.TRANSPORT_DEVICE_MOVES)
        # local-mode publications of this instance (the close ledger)
        self._local_prefixes: Set[str] = set()
        self._lock = threading.Lock()
        # device_move's side stream, made on first use
        self._stream: Optional[torch.cuda.Stream] = None

    def _probe_session(self) -> bool:
        """Session mode needs ``torch.distributed`` over exactly the
        coordinator's ranks: the gate protocol and the broadcasts' source
        ranks name the same processes."""
        if self.coordinator is None:
            return False
        try:
            dist = _dist()
            return (
                dist.is_available()
                and dist.is_initialized()
                and dist.get_world_size() > 1
                and dist.get_world_size() == self.coordinator.world_size
                and dist.get_rank() == self.coordinator.rank
            )
        except Exception:  # noqa: BLE001 — no distributed runtime
            return False

    def _to_device_parts(self, view: memoryview, prefix: str) -> List[torch.Tensor]:
        n = view.nbytes
        nparts, base = _plan_parts(n, knobs.get_transport_part_bytes())
        host = _host_u8(view)
        parts = []
        for i, (a, b) in enumerate(_spans(n, nparts, base)):
            parts.append(host[a:b].to(self.device, copy=True))
            # a transfer dying with some parts already on the device must
            # degrade, not wedge
            failpoint("transport.collective.publish", prefix=prefix, part=i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return parts

    # ----------------------------------------------------- local mode

    def publish(self, prefix: str, data: Any) -> int:
        """Local mode: the parts onto the device, then the announce key
        ``{prefix}/xmeta`` LAST (its presence implies a complete entry)."""
        if self.mode != "local":
            raise TransportUnavailable("session mode publishes through the fan-out session")
        with obs.span("transport/collective_publish", prefix=prefix):
            t0 = time.monotonic()
            view = memoryview(data).cast("B")
            n = view.nbytes
            crc, adler = _digests(view)
            parts = self._to_device_parts(view, prefix)
            with _registry_lock:
                _REGISTRY[prefix] = (parts, n, crc, adler)
            with self._lock:
                self._local_prefixes.add(prefix)
            nparts, base = _plan_parts(n, knobs.get_transport_part_bytes())
            self.coordinator.kv_set(f"{prefix}/xmeta", f"{nparts}:{base}:{n}:{crc}:{adler}")
            self._m_ops.inc()
            self._m_bytes.inc(n)
            self._m_lat.observe(time.monotonic() - t0)
            return nparts

    def try_fetch(self, prefix: str) -> Optional[bytearray]:
        """Local mode: None while unannounced; else the parts copied back
        from the device and held against both digests.  An announce with
        no registry entry was made by another process: this engine cannot
        serve it (``TransportUnavailable``)."""
        if self.mode != "local":
            raise TransportUnavailable("session mode consumes through the fan-out session")
        with obs.span("transport/collective_fetch", prefix=prefix):
            raw = self.coordinator.kv_try_get(f"{prefix}/xmeta")
            if raw is None:
                return None
            t0 = time.monotonic()
            try:
                _, _, n_s, crc_s, adler_s = raw.split(":")
                n, crc, adler = int(n_s), int(crc_s), int(adler_s)
            except ValueError as e:
                raise ValueError(f"malformed transport announce under {prefix!r}: {raw!r}") from e
            with _registry_lock:
                entry = _REGISTRY.get(prefix)
            if entry is None:
                raise TransportUnavailable(
                    f"announce for {prefix!r} has no in-process registry entry "
                    f"(a publisher in another process)"
                )
            parts, reg_n, _, _ = entry
            data = _to_host(parts, reg_n)
            if reg_n != n or _digests(data) != (crc, adler):
                raise ValueError(
                    f"transport payload under {prefix!r} failed digest verification "
                    f"({reg_n} of {n} bytes)"
                )
            self._m_ops.inc()
            self._m_bytes.inc(n)
            self._m_lat.observe(time.monotonic() - t0)
            return data

    def cleanup(self, prefix: str, nparts: int) -> None:
        """The announce key first, then the device parts."""
        self.coordinator.kv_try_delete(f"{prefix}/xmeta")
        with _registry_lock:
            _REGISTRY.pop(prefix, None)
        with self._lock:
            self._local_prefixes.discard(prefix)

    def _side_stream(self) -> torch.cuda.Stream:
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=self.device)
            return self._stream

    def _round_trip(self, host: torch.Tensor, out: torch.Tensor, spans) -> None:
        parts = [host[a:b].to(self.device, copy=True) for a, b in spans]
        for (a, b), part in zip(spans, parts):
            out[a:b].copy_(part)

    def device_move(self, buf: Any) -> Any:
        """Route one staged payload through the device (parts onto it,
        back to a fresh host buffer) and return the verified bytes.
        Raises on any failure or digest mismatch: the scheduler's buffer
        writes count the fallback and write the original bytes."""
        view = memoryview(buf).cast("B")
        n = view.nbytes
        if n == 0:
            return buf
        with obs.span("transport/device_move", bytes=n):
            crc, adler = _digests(view)
            nparts, base = _plan_parts(n, knobs.get_transport_part_bytes())
            failpoint("transport.collective.device_move", bytes=n)
            data = bytearray(n)
            out = torch.frombuffer(data, dtype=torch.uint8)
            spans = _spans(n, nparts, base)
            if self.device.type == "cuda":
                stream = self._side_stream()
                with torch.cuda.stream(stream):
                    self._round_trip(_host_u8(view), out, spans)
                stream.synchronize()
            else:
                self._round_trip(_host_u8(view), out, spans)
            if _digests(data) != (crc, adler):
                raise ValueError("device round trip failed digest verification")
            self._m_moves.inc()
            self._m_bytes.inc(n)
            return data

    def close(self) -> None:
        with self._lock:
            prefixes = list(self._local_prefixes)
        for prefix in prefixes:
            self.cleanup(prefix, 0)

    # --------------------------------------------------- session mode

    def open_fanout_session(
        self, topology: Any, uid: str, plan_paths: List[str]
    ) -> "CollectiveFanoutSession":
        """Start one restore's ordered broadcast session (session mode;
        every rank calls it, in the same order, with the same
        ``plan_paths``: its group is created collectively)."""
        if self.mode != "session":
            raise TransportUnavailable("no process group over the coordinator's world")
        return CollectiveFanoutSession(self, self.coordinator, topology, uid, plan_paths)


class CollectiveFanoutSession:
    """One restore's ordered broadcast schedule (see the module
    docstring).  The plan is every (slice, path) pair of a slice with
    siblings; the slice's designated reader is the transfer's source,
    every rank takes part in every broadcast and only the slice's
    members keep the bytes.  A thread per process walks the plan; the
    read path talks to it with ``offer``/``decline`` (source side,
    non-blocking) and ``poll`` (sibling side, non-blocking; the session
    resolves every transfer within bounded waits).  A broken session
    finishes in drain mode: offered payloads are re-published over KV."""

    def __init__(
        self,
        transport: CollectiveTransport,
        coordinator: Any,
        topology: Any,
        uid: str,
        plan_paths: List[str],
    ) -> None:
        self.transport = transport
        self.coordinator = coordinator
        self.topology = topology
        self.uid = uid
        self.timeout_s = max(0.5, knobs.get_transport_timeout_s())
        # path read order major, slice minor: alike on every process
        self.plan: List[Tuple[int, str]] = [
            (s, p)
            for p in plan_paths
            for s in sorted(set(topology.slice_of))
            if len(topology.ranks_in_slice(s)) >= 2
        ]
        self.index: Dict[Tuple[int, str], int] = {key: k for k, key in enumerate(self.plan)}
        self.sources: Dict[Tuple[int, str], int] = {
            (s, p): topology.designated_reader(p, s) for (s, p) in self.plan
        }
        dist = _dist()
        # the transport's own group, bounded by the knob: the caller's
        # default group never carries payloads
        self.group = dist.new_group(
            ranks=list(range(coordinator.world_size)), backend=BACKEND,
            timeout=datetime.timedelta(seconds=self.timeout_s),
        )
        self._cond = threading.Condition()
        # key → (payload, kv degrade prefix), or None (declined)
        self._offers: Dict[Tuple[int, str], Optional[Tuple[bytes, str]]] = {}
        # key → delivered bytes, or None (skipped, degraded, not mine)
        self._results: Dict[Tuple[int, str], Optional[bytearray]] = {}
        # keys whose offer window passed: a late offer is refused and the
        # read path publishes over KV itself
        self._abandoned: Set[Tuple[int, str]] = set()
        self.broken = False
        self._closing = False
        # KV blobs the drain path published: (prefix, nparts)
        self.kv_published: List[Tuple[str, int]] = []
        self._gate_written: List[str] = []
        self._thread = threading.Thread(
            target=self._run, name="tsnp-torch-transport-session", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------- read-path API

    def covers(self, key: Tuple[int, str]) -> bool:
        return key in self.index

    def offer(self, key: Tuple[int, str], data: bytes, kv_prefix: str) -> bool:
        """Source side: True = the session delivers (a broadcast, or a KV
        blob in drain mode); False = too late or unplanned, the caller
        publishes over KV."""
        with self._cond:
            if key not in self.index or key in self._abandoned:
                return False
            self._offers[key] = (data, kv_prefix)
            self._cond.notify_all()
            return True

    def decline(self, key: Tuple[int, str]) -> None:
        """Source side: this path's reads are ranged; the siblings get
        ``skip`` at once instead of waiting out the offer window."""
        with self._cond:
            if key in self.index and key not in self._offers:
                self._offers[key] = None
                self._cond.notify_all()

    def poll(self, key: Tuple[int, str]) -> Tuple[bool, Optional[bytearray]]:
        """Sibling side: (resolved, bytes).  Bytes = the verified
        broadcast payload; None = skipped or degraded (the fan-out's KV
        ladder takes over).  A broken or closing session resolves every
        transfer."""
        with self._cond:
            if key in self._results:
                return True, self._results[key]
            return (self.broken or self._closing), None

    def close(self) -> None:
        """Stop the walk, reclaim the gate and degrade keys and release
        the group.  Called after the restore's last barrier (no rank still
        consumes); idempotent."""
        with self._cond:
            already = self._closing
            self._closing = True
            self._cond.notify_all()
        if already:
            return
        self._thread.join(self.timeout_s * 2 + 5.0)
        for k in self._gate_written:
            try:
                self.coordinator.kv_try_delete(k)
            except Exception as e:  # noqa: BLE001 — best-effort
                obs.swallowed_exception("transport.session.cleanup", e)
        for prefix, nparts in self.kv_published:
            try:
                self.coordinator.kv_try_delete(f"{prefix}/meta")
                for i in range(nparts):
                    self.coordinator.kv_try_delete(f"{prefix}/p{i}")
            except Exception as e:  # noqa: BLE001 — best-effort
                obs.swallowed_exception("transport.session.cleanup", e)
        if not self.broken:
            try:
                _dist().destroy_process_group(self.group)
            except Exception as e:  # noqa: BLE001 — best-effort
                obs.swallowed_exception("transport.session.cleanup", e)

    # --------------------------------------------------- session loop

    def _gate(self, k: int, leaf: str) -> str:
        return f"{self.uid}/x/{k}/{leaf}"

    def _kv_set_gate(self, k: int, leaf: str, value: str) -> None:
        key = self._gate(k, leaf)
        self.coordinator.kv_set(key, value)
        self._gate_written.append(key)

    def _resolve(self, key: Tuple[int, str], data: Optional[bytearray]) -> None:
        with self._cond:
            self._results[key] = data
            self._cond.notify_all()

    def _break(self, why: Any) -> None:
        count_fallback("session", why)
        with self._cond:
            self.broken = True
            self._cond.notify_all()

    def _wait_offer(self, key: Tuple[int, str]) -> Optional[Tuple[bytes, str]]:
        """Source side: the read path's offer or decline, within the
        timeout; past it the key is abandoned."""
        deadline = time.monotonic() + self.timeout_s
        with self._cond:
            while key not in self._offers and not self._closing:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._abandoned.add(key)
                    return None
                self._cond.wait(min(left, 0.25))
            if key not in self._offers:
                self._abandoned.add(key)
                return None
            return self._offers[key]

    def _run(self) -> None:
        with obs.span("transport/session", transfers=len(self.plan)):
            try:
                for k, key in enumerate(self.plan):
                    with self._cond:
                        if self._closing:
                            return
                    if self.broken:
                        self._drain_one(k, key)
                        continue
                    try:
                        self._run_one(k, key)
                    except Exception as e:  # noqa: BLE001 — the rest rides KV
                        self._break(e)
                        self._drain_one(k, key)
            except BaseException as e:  # noqa: BLE001 — never die silently
                self._break(e)
            finally:
                with self._cond:
                    for key in self.plan:
                        self._results.setdefault(key, None)
                    self._cond.notify_all()

    def _broadcast(self, t: torch.Tensor, src: int) -> None:
        """One part, bounded by the session timeout."""
        work = _dist().broadcast(t, src=src, group=self.group, async_op=True)
        work.wait(datetime.timedelta(seconds=self.timeout_s))

    def _run_one(self, k: int, key: Tuple[int, str]) -> None:
        slice_id, path = key
        src = self.sources[key]
        me = self.coordinator.rank
        dev = self.transport.device
        if me == src:
            offered = self._wait_offer(key)
            if offered is None:
                self._kv_set_gate(k, "go", "skip")
                self._resolve(key, None)
                return
            data, kv_prefix = offered
            failpoint("transport.collective.broadcast", path=path, k=k)
            t0 = time.monotonic()
            view = memoryview(data).cast("B")
            n = view.nbytes
            crc, adler = _digests(view)
            nparts, base = _plan_parts(n, knobs.get_transport_part_bytes())
            self._kv_set_gate(k, "go", f"ok:{n}:{nparts}:{base}:{crc}:{adler}")
            # one deadline for every ack
            deadline = time.monotonic() + self.timeout_s
            for r in range(self.coordinator.world_size):
                if r == me:
                    continue
                try:
                    self.coordinator.kv_get(
                        self._gate(k, f"ack/{r}"), max(0.05, deadline - time.monotonic())
                    )
                except Exception as e:  # noqa: BLE001 — a silent rank: no collective
                    self._kv_set_gate(k, "go2", "cancel")
                    self._break(e)
                    n_kv = self._kv_degrade_publish(kv_prefix, data)
                    if n_kv:
                        self.kv_published.append((kv_prefix, n_kv))
                    self._resolve(key, None)
                    return
            self._kv_set_gate(k, "go2", "go")
            host = _host_u8(view)
            for a, b in _spans(n, nparts, base):
                self._broadcast(host[a:b].to(dev, copy=True), src)
            self.transport._m_ops.inc()
            self.transport._m_bytes.inc(n)
            self.transport._m_lat.observe(time.monotonic() - t0)
            self._resolve(key, None)  # the source has its own bytes
            return
        raw = self.coordinator.kv_get(self._gate(k, "go"), self.timeout_s)
        if raw == "skip":
            self._resolve(key, None)
            return
        t0 = time.monotonic()
        _, n_s, nparts_s, base_s, crc_s, adler_s = raw.split(":")
        n, nparts, base = int(n_s), int(nparts_s), int(base_s)
        self._kv_set_gate(k, f"ack/{me}", "1")
        # twice the knob: the source collects every ack within one window
        if self.coordinator.kv_get(self._gate(k, "go2"), self.timeout_s * 2) != "go":
            self._resolve(key, None)
            self._break(f"transfer {k} cancelled by its source")
            return
        parts = []
        for a, b in _spans(n, nparts, base):
            t = torch.empty(b - a, dtype=torch.uint8, device=dev)
            self._broadcast(t, src)
            parts.append(t)
        if me not in self.topology.ranks_in_slice(slice_id):
            self._resolve(key, None)
            return
        data = _to_host(parts, n)
        if _digests(data) != (int(crc_s), int(adler_s)):
            # the collectives stayed in step: this consumer alone degrades
            count_fallback("broadcast-verify", f"digest mismatch for {path!r}")
            self._resolve(key, None)
            return
        self.transport._m_ops.inc()
        self.transport._m_bytes.inc(n)
        self.transport._m_lat.observe(time.monotonic() - t0)
        self._resolve(key, data)

    def _drain_one(self, k: int, key: Tuple[int, str]) -> None:
        """A broken session's duty: no collectives, but an offered payload
        was promised delivery, so it goes out as a KV blob."""
        if self.sources[key] == self.coordinator.rank:
            offered = self._wait_offer(key)
            if offered is not None:
                data, kv_prefix = offered
                n = self._kv_degrade_publish(kv_prefix, data)
                if n:
                    self.kv_published.append((kv_prefix, n))
        self._resolve(key, None)

    def _kv_degrade_publish(self, prefix: str, data: bytes) -> int:
        """One offered payload as a KV blob; its part count (0 on failure:
        the siblings' re-election still covers them)."""
        try:
            part = knobs.get_fanout_part_bytes()
            n = self.coordinator.kv_publish_blob(prefix, data, part)
            obs.counter(obs.TRANSPORT_KV_OPS).inc()
            obs.counter(obs.TRANSPORT_KV_BYTES).inc(n)
            return max(1, (n + part - 1) // part)
        except Exception as e:  # noqa: BLE001 — best-effort degrade
            obs.swallowed_exception("transport.session.degrade", e)
            return 0
