"""Control plane between ranks: object gathers, barriers and a KV store.

Counterpart of ``torchsnapshot_tpu/coordination.py``.  Every gather and
barrier is built on three KV primitives (set, blocking get, try-get),
so the backends share one set of semantics:

- ``LocalCoordinator``: one process, no-ops.
- ``TorchStoreCoordinator``: many processes over a
  ``torch.distributed.Store`` (the ``TCPStore`` that
  ``init_process_group`` made, or one the caller made).  It takes the
  place of the JAX package's ``JaxCoordinator`` (jax.distributed's KV
  service).  Only the store is used, never a collective, so it is safe
  from an ``async_take``'s background commit thread and needs no NCCL.
- ``FileCoordinator``: a shared directory, for processes of one host
  (tests).

Every backend gets its barrier from the base class (two phases over the
KV store).  The cross-rank abort protocol (``resilience/abort.py``) rides
on the base class too: ``poison(scope, cause)`` sets one key, and inside an
``abort_scope(scope)`` every ``kv_get``/``barrier`` wait polls it.  Inside
a ``liveness_scope(monitor)`` (``resilience/liveness.py``) the same waits
check the monitor between probes and raise ``RankDeadError`` when a
peer's heartbeat stamp goes stale: the take's commit waits run in one, so
a rank killed mid-commit surfaces within ``LIVENESS_TIMEOUT_S`` and the
survivors finish the commit by write takeover (``snapshot.py``), and the
restore's waits run in one, so its peers raise naming the dead rank.
The payload blobs of the fan-out restore and the KV transport
(``kv_publish_blob``, ``kv_try_fetch_blob``, ``kv_sweep_blob``: chunked
base64, crc32 verified, the meta key last) and ``kv_watch`` are built on
the same primitives, under the JAX package's key names.
"""

from __future__ import annotations

import abc
import contextlib
import logging
import os
import threading
import time
import uuid
import zlib
from base64 import b64decode, b64encode
from typing import Any, Iterator, List, Optional

from . import obs
from .resilience import abort as _abort
from .serialization import deserialize_object, serialize_object

logger = logging.getLogger(__name__)

_DEFAULT_TIMEOUT_S = 600.0
# abort-aware waits poll the poison key at this cadence: a peer's abort
# surfaces within about this interval instead of the whole wait timeout
_ABORT_POLL_S = 0.5


class Coordinator(abc.ABC):
    """The uniform control-plane interface.  Coordination calls happen in
    the same program order on every rank, so a per-instance counter
    (``_next_uid``) gives matching keys across ranks: reuse one
    coordinator for a job's successive snapshots."""

    @property
    @abc.abstractmethod
    def rank(self) -> int: ...

    @property
    @abc.abstractmethod
    def world_size(self) -> int: ...

    @abc.abstractmethod
    def _kv_set_impl(self, key: str, value: str) -> None: ...

    @abc.abstractmethod
    def _kv_get_impl(self, key: str, timeout_s: float) -> str:
        """Blocking get; raises ``TimeoutError`` when the key does not
        appear within ``timeout_s``."""

    @abc.abstractmethod
    def kv_try_get(self, key: str) -> Optional[str]: ...

    def kv_set(self, key: str, value: str) -> None:
        self._kv_set_impl(key, value)

    def kv_get(self, key: str, timeout_s: float = _DEFAULT_TIMEOUT_S) -> str:
        """Blocking get: waits until the key exists.  Abort-aware inside
        an ``abort_scope``; death-aware inside a ``liveness_scope`` (raises
        ``RankDeadError`` when a peer's stamp goes stale instead of
        waiting out the deadline)."""
        scope = self._current_abort_scope()
        monitor = self._current_liveness()
        if scope is None and monitor is None:
            return self._kv_get_impl(key, timeout_s)
        deadline = time.monotonic() + timeout_s
        while True:
            if scope is not None:
                self.raise_if_poisoned(scope)
            if monitor is not None:
                monitor.check()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"kv_get timed out waiting for {key!r} (abort scope {scope!r})"
                )
            try:
                return self._kv_get_impl(key, min(_ABORT_POLL_S, remaining))
            except TimeoutError:
                pass

    def barrier(
        self, name: Optional[str] = None, timeout_s: float = _DEFAULT_TIMEOUT_S
    ) -> None:
        """Two-phase barrier over the KV store (every rank arrives, rank 0
        releases), named from the op counter when no name is given
        (explicit names must be unique per use).  Inside an
        ``abort_scope`` its waits are abort-aware."""
        name = name or self._next_uid("bar")
        # always-on barrier phase clock: the flight record's straggler
        # attribution reads this rank's barrier-wait seconds (a fast
        # rank's time hides here while it waits for the straggler)
        t0 = time.monotonic()
        try:
            self._barrier_inner(name, timeout_s)
        finally:
            obs.histogram(obs.PHASE_BARRIER_S).observe(time.monotonic() - t0)

    def _barrier_inner(self, name: str, timeout_s: float) -> None:
        scope = self._current_abort_scope()
        if scope is not None:
            self.raise_if_poisoned(scope)
        monitor = self._current_liveness()
        if monitor is not None:
            monitor.check()
        if self.world_size == 1:
            return
        # one deadline for the whole barrier
        deadline = time.monotonic() + timeout_s
        self.kv_set(f"{name}/arrive/{self.rank}", "1")
        if self.rank == 0:
            for r in range(self.world_size):
                self.kv_get(f"{name}/arrive/{r}", max(0.0, deadline - time.monotonic()))
            self.kv_set(f"{name}/depart", "1")
        else:
            self.kv_get(f"{name}/depart", max(0.0, deadline - time.monotonic()))

    # ---- cross-rank abort (resilience/abort.py) ------------------------

    def poison(self, scope: str, cause: str, site: str = "") -> _abort.AbortInfo:
        """Broadcast an abort of ``scope``: peers blocked in abort-aware
        waits raise ``SnapshotAbortedError`` naming this rank and
        ``cause``.  Never raises: it runs on failure paths and must not
        mask the original error."""
        info = _abort.AbortInfo(origin_rank=self.rank, cause=cause, site=site)
        obs.counter(obs.RESILIENCE_ABORTS).inc()
        logger.warning(
            "rank %d poisoning scope %r at %s: %s", self.rank, scope, site or "?", cause
        )
        try:
            self._kv_set_impl(_abort.poison_key(scope), _abort.encode_poison(info))
        except Exception:  # noqa: BLE001 — best-effort broadcast
            logger.warning("poisoning scope %r failed", scope, exc_info=True)
        return info

    def check_poison(self, scope: str) -> Optional[_abort.AbortInfo]:
        raw = self.kv_try_get(_abort.poison_key(scope))
        return _abort.decode_poison(raw) if raw else None

    def raise_if_poisoned(self, scope: str) -> None:
        info = self.check_poison(scope)
        if info is not None:
            raise _abort.SnapshotAbortedError(info, scope=scope)

    def _current_abort_scope(self) -> Optional[str]:
        tls = self.__dict__.get("_abort_tls")
        return getattr(tls, "scope", None) if tls is not None else None

    @contextlib.contextmanager
    def abort_scope(self, scope: str) -> Iterator[None]:
        """While active, this THREAD's ``kv_get``/``barrier`` waits poll
        ``scope``'s poison key (per thread: an async commit thread scopes
        its own waits without touching the foreground's)."""
        tls = self.__dict__.setdefault("_abort_tls", threading.local())
        prev = getattr(tls, "scope", None)
        tls.scope = scope
        try:
            yield
        finally:
            tls.scope = prev

    # ---- rank liveness (resilience/liveness.py) ------------------------

    def _current_liveness(self) -> Any:
        tls = self.__dict__.get("_liveness_tls")
        return getattr(tls, "monitor", None) if tls is not None else None

    @contextlib.contextmanager
    def liveness_scope(self, monitor: Any) -> Iterator[None]:
        """While active, this THREAD's ``kv_get``/``barrier`` waits check
        ``monitor`` (a ``LivenessMonitor``) between probes and raise
        ``RankDeadError`` when a peer's stamp goes stale; per thread, as
        ``abort_scope`` is."""
        tls = self.__dict__.setdefault("_liveness_tls", threading.local())
        prev = getattr(tls, "monitor", None)
        tls.monitor = monitor
        try:
            yield
        finally:
            tls.monitor = prev

    def dead_ranks(self) -> List[int]:
        """The peers the current thread's monitor declares dead (none
        outside a ``liveness_scope``: without heartbeats there is no
        evidence of death)."""
        monitor = self._current_liveness()
        return monitor.dead_ranks() if monitor is not None else []

    # ---- derived object-level ops --------------------------------------

    def _encode(self, obj: Any) -> str:
        payload, tag = serialize_object(obj)
        return tag + ":" + b64encode(payload).decode("ascii")

    def _decode(self, s: str) -> Any:
        tag, payload = s.split(":", 1)
        return deserialize_object(b64decode(payload.encode("ascii")), tag)

    def _next_uid(self, op: str) -> str:
        n = getattr(self, "_op_counter", 0)
        self._op_counter = n + 1
        return f"{op}/{n}"

    def kv_exchange(
        self, prefix: str, value: str, timeout_s: float = _DEFAULT_TIMEOUT_S
    ) -> List[str]:
        """KV-only allgather of one string per rank under explicit keys
        (``{prefix}/{rank}``): no barrier and no uid counter, so it is
        safe from a background thread.  ``prefix`` must be unique per use
        (callers derive it from a commit uid)."""
        if self.world_size == 1:
            return [value]
        self.kv_set(f"{prefix}/{self.rank}", value)
        return [self.kv_get(f"{prefix}/{r}", timeout_s) for r in range(self.world_size)]

    def kv_try_delete(self, key: str) -> None:
        """Best-effort deletion of a key (a heartbeat stamp a session
        leaves on a clean exit).  The base keeps the key: a backend
        without deletion never fails its caller."""

    def kv_publish_blob(
        self, prefix: str, data: Any, part_bytes: int = 4 * 1024 * 1024
    ) -> int:
        """Publish one binary blob under explicit keys: ``{prefix}/p{i}``
        parts of ``part_bytes`` (base64), then ``{prefix}/meta`` =
        ``nparts:total:crc32`` LAST, so the meta key's presence implies
        every part is there.  No barrier and no uid: safe from any thread
        and from one rank alone.  Leftover parts of an earlier blob under
        the same prefix (a publisher killed between the meta delete and
        the part deletes) are reclaimed: indices below ``nparts`` are
        overwritten, and the tail past it is swept after the meta write.
        Returns the blob's byte length."""
        view = memoryview(data).cast("B")
        part = max(1, int(part_bytes))
        n = view.nbytes
        nparts = (n + part - 1) // part
        for i in range(nparts):
            chunk = view[i * part : min((i + 1) * part, n)]
            self.kv_set(f"{prefix}/p{i}", b64encode(chunk).decode("ascii"))
        self.kv_set(f"{prefix}/meta", f"{nparts}:{n}:{zlib.crc32(view)}")
        # the tail only, the meta key kept (an empty blob has no parts)
        self._sweep_parts(prefix, nparts)
        return n

    def kv_sweep_blob(self, prefix: str, beyond: int = 0) -> int:
        """Best-effort delete of ``{prefix}/p{i}`` for ``i = beyond, ...``
        up to the first missing index (parts are written contiguously from
        0).  ``beyond=0`` is a full sweep and deletes ``{prefix}/meta``
        FIRST, keeping the meta-last invariant for a concurrent fetcher.
        Returns the number of part keys deleted."""
        start = max(0, int(beyond))
        if start == 0:
            self.kv_try_delete(f"{prefix}/meta")
        return self._sweep_parts(prefix, start)

    def _sweep_parts(self, prefix: str, start: int) -> int:
        swept = 0
        i = start
        while self.kv_try_get(f"{prefix}/p{i}") is not None:
            self.kv_try_delete(f"{prefix}/p{i}")
            swept += 1
            i += 1
        if swept:
            obs.counter(obs.TRANSPORT_SWEPT_PARTS).inc(swept)
        return swept

    def kv_try_fetch_blob(
        self, prefix: str, timeout_s: float = _DEFAULT_TIMEOUT_S
    ) -> Optional[bytes]:
        """None while ``{prefix}/meta`` is absent; else the reassembled
        bytes, checked against the meta's length and crc32 (``ValueError``
        on a mismatch: the caller decides between a retry and a direct
        read)."""
        raw = self.kv_try_get(f"{prefix}/meta")
        if raw is None:
            return None
        try:
            nparts_s, total_s, crc_s = raw.split(":")
            nparts, total, crc = int(nparts_s), int(total_s), int(crc_s)
        except ValueError as e:
            raise ValueError(f"malformed blob meta under {prefix!r}: {raw!r}") from e
        buf = bytearray()
        for i in range(nparts):
            buf += b64decode(self.kv_get(f"{prefix}/p{i}", timeout_s).encode("ascii"))
        if len(buf) != total or zlib.crc32(buf) != crc:
            raise ValueError(
                f"blob under {prefix!r} failed digest verification "
                f"({len(buf)} of {total} bytes)"
            )
        return bytes(buf)

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Gather an object from every rank (foreground program order)."""
        if self.world_size == 1:
            return [obj]
        uid = self._next_uid("ag")
        self.kv_set(f"{uid}/{self.rank}", self._encode(obj))
        out = [self._decode(self.kv_get(f"{uid}/{r}")) for r in range(self.world_size)]
        self.barrier(f"{uid}/done")
        return out

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Broadcast an object from ``src`` (foreground program order)."""
        if self.world_size == 1:
            return obj
        uid = self._next_uid("bc")
        if self.rank == src:
            self.kv_set(uid, self._encode(obj))
            result = obj
        else:
            result = self._decode(self.kv_get(uid))
        self.barrier(f"{uid}/done")
        return result


class LocalCoordinator(Coordinator):
    """The single-process coordinator: rank 0 of a world of one."""

    def __init__(self) -> None:
        self._kv: dict = {}

    @property
    def rank(self) -> int:
        return 0

    @property
    def world_size(self) -> int:
        return 1

    def _kv_set_impl(self, key: str, value: str) -> None:
        self._kv[key] = value

    def _kv_get_impl(self, key: str, timeout_s: float) -> str:
        try:
            return self._kv[key]
        except KeyError:
            raise TimeoutError(f"kv_get: {key!r} is not set") from None

    def kv_try_get(self, key: str) -> Optional[str]:
        return self._kv.get(key)

    def kv_try_delete(self, key: str) -> None:
        self._kv.pop(key, None)


class _PollingCoordinator(Coordinator):
    """A blocking get made of ``kv_try_get`` probes ``poll_s`` apart."""

    _poll_s = 0.01

    def _kv_get_impl(self, key: str, timeout_s: float) -> str:
        deadline = time.monotonic() + timeout_s
        while True:
            value = self.kv_try_get(key)
            if value is not None:
                return value
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"kv_get timed out waiting for {key!r}")
            time.sleep(min(self._poll_s, remaining))


class TorchStoreCoordinator(_PollingCoordinator):
    """Coordination over a ``torch.distributed.Store``: on one host a
    ``TCPStore`` on localhost, which ``init_process_group`` makes (then
    ``get_default_coordinator`` returns this over it) or the caller makes
    (``TCPStore(host, port, world_size, is_master=rank == 0)``).  Keys
    live under ``namespace/``."""

    def __init__(
        self, store: Any, rank: int, world_size: int, namespace: str = "tsnp",
        poll_s: float = 0.01,
    ) -> None:
        self._store = store
        self._rank = rank
        self._world = world_size
        self._ns = namespace
        self._poll_s = poll_s

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world

    def _k(self, key: str) -> str:
        return f"{self._ns}/{key}"

    def _kv_set_impl(self, key: str, value: str) -> None:
        self._store.set(self._k(key), value)

    def kv_try_get(self, key: str) -> Optional[str]:
        k = self._k(key)
        if not self._store.check([k]):
            return None
        return self._store.get(k).decode()

    def kv_try_delete(self, key: str) -> None:
        try:
            self._store.delete_key(self._k(key))
        except Exception as e:  # noqa: BLE001 — cleanup is best-effort
            obs.swallowed_exception("coordination.kv_try_delete", e)


class FileCoordinator(_PollingCoordinator):
    """Shared-directory KV and barriers for processes of one host."""

    def __init__(self, root: str, rank: int, world_size: int, poll_s: float = 0.01):
        self.root = root
        self._rank = rank
        self._world = world_size
        self._poll_s = poll_s
        os.makedirs(root, exist_ok=True)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "%2F"))

    def _kv_set_impl(self, key: str, value: str) -> None:
        path = self._path(key)
        tmp = path + f".tmp.{uuid.uuid4().hex}"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, path)

    def kv_try_get(self, key: str) -> Optional[str]:
        try:
            with open(self._path(key), "r") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def kv_try_delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass  # never set, or already gone


def kv_watch(
    coordinator: Coordinator,
    key: str,
    last: Optional[str] = None,
    timeout_s: float = 0.0,
    poll_s: float = 0.025,
) -> Optional[str]:
    """Poll ``kv_try_get(key)`` until its value exists and differs from
    ``last`` (returned), or ``timeout_s`` passes (None).  One
    non-blocking probe per tick; a probe error also returns None, so a
    broken announce channel degrades the watcher instead of wedging it."""
    deadline = time.monotonic() + max(0.0, timeout_s)
    while True:
        try:
            value = coordinator.kv_try_get(key)
        except Exception as e:  # noqa: BLE001 — the caller falls back
            obs.swallowed_exception("coordination.kv_watch", e)
            return None
        if value is not None and value != last:
            return value
        if time.monotonic() >= deadline:
            return None
        time.sleep(min(poll_s, max(0.0, deadline - time.monotonic())))


_DEFAULT_STORE_COORDINATOR: List[Any] = []  # [(store, coordinator)]


def get_default_coordinator() -> Coordinator:
    """A ``TorchStoreCoordinator`` over the default process group's store
    when ``torch.distributed`` is initialized (the same instance for the
    same store, so its op counter keeps matching across snapshots), else
    a ``LocalCoordinator``.  The choice is counted in ``obs``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        store = dist.distributed_c10d._get_default_store()
        if not _DEFAULT_STORE_COORDINATOR or _DEFAULT_STORE_COORDINATOR[0][0] is not store:
            _DEFAULT_STORE_COORDINATOR[:] = [(
                store,
                TorchStoreCoordinator(store, dist.get_rank(), dist.get_world_size()),
            )]
        obs.counter(obs.COORDINATOR_STORE).inc()
        return _DEFAULT_STORE_COORDINATOR[0][1]
    obs.counter(obs.COORDINATOR_LOCAL).inc()
    return LocalCoordinator()
