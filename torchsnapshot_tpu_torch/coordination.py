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
``abort_scope(scope)`` every ``kv_get``/``barrier`` wait polls it.  Rank
liveness (heartbeats, write takeover) is not ported.
"""

from __future__ import annotations

import abc
import contextlib
import logging
import os
import threading
import time
import uuid
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
        an ``abort_scope``."""
        scope = self._current_abort_scope()
        if scope is None:
            return self._kv_get_impl(key, timeout_s)
        deadline = time.monotonic() + timeout_s
        while True:
            self.raise_if_poisoned(scope)
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
        with obs.span("coordination/barrier"):
            scope = self._current_abort_scope()
            if scope is not None:
                self.raise_if_poisoned(scope)
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
