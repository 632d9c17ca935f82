"""Payload transport: how redistributed bytes move between ranks.

Counterpart of ``torchsnapshot_tpu/transport``.  The fan-out restore
(``topology/fanout.py``) hands each replicated object its designated
reader read to the reader's siblings; this package is the data plane it
rides, with the coordination KV as its control plane:

- ``CollectiveTransport`` (``collective.py``) moves payloads as ``uint8``
  tensors on a device, in parts of ``TRANSPORT_PART_BYTES``: across
  processes as ``torch.distributed.broadcast`` on a gloo process group
  of the transport's own (CUDA tensors included), in one process through an
  in-process registry of device tensors (a host → device → host round
  trip).  The KV carries the announce, digest and gate keys only;
- ``KVTransport`` (``kv.py``) is the always-available engine: the
  coordinator's chunked base64 blobs (``kv_publish_blob``), metered under
  ``transport.kv_*`` like the collective engine under
  ``transport.collective_*``.

``resolve_transport`` picks the engine per operation: the ``TRANSPORT``
knob states a preference (auto, collective, kv), a probe checks what the
runtime can do (``torch.distributed`` initialised with the coordinator's
world and rank), and a forced ``collective`` that cannot run lands on KV
with ``transport.fallbacks`` advanced.  No wait of the engine is without
a deadline (``TRANSPORT_TIMEOUT_S``); an anomaly degrades the transfer,
and for the ordered session the rest of it, to the KV path.  Both
engines verify crc32 + adler32 (KV: crc32 and length) of the exact
payload bytes before a consumer may trust them, and the read pipeline's
manifest digests still check what lands.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from .. import knobs, obs

logger = logging.getLogger(__name__)


class TransportUnavailable(Exception):
    """The engine cannot run in this process (no device, no aligned
    process group, a publication this process cannot reach).  Callers
    degrade to the KV engine; never an operation's failure."""


class Transport:
    """One payload engine, with the KV blob primitives' API:

    - ``publish(prefix, data)`` → nparts: make ``data`` fetchable under
      ``prefix``;
    - ``try_fetch(prefix)`` → bytes or None (not there yet);
      ``TransportUnavailable`` = this engine cannot serve it,
      ``ValueError`` = digest mismatch;
    - ``cleanup(prefix, nparts)``: best-effort reclaim;
    - ``device_move(buf)`` → bytes: route one staged payload through the
      engine's fabric leg, digest-verified (a host → device → host round
      trip on the collective engine, the identity here and on KV): the
      continuous loop's peer-replica hook;
    - ``close()``: release engine state."""

    engine: str = "none"

    def publish(self, prefix: str, data: Any) -> int:
        raise NotImplementedError

    def try_fetch(self, prefix: str) -> Optional[bytes]:
        raise NotImplementedError

    def cleanup(self, prefix: str, nparts: int) -> None:
        raise NotImplementedError

    def device_move(self, buf: Any) -> Any:
        return buf

    def close(self) -> None:
        pass


# the engine the last resolve_transport chose in this process (the
# flight record's stamp reads it); restores resolve concurrently
_engine_lock = threading.Lock()
_last_engine: Optional[str] = None


def _note_engine(engine: str) -> None:
    global _last_engine
    with _engine_lock:
        _last_engine = engine


def current_engine() -> Optional[str]:
    """The engine the most recent ``resolve_transport`` of this process
    chose, or None before the first."""
    with _engine_lock:
        return _last_engine


def count_fallback(site: str, reason: Any) -> None:
    """One collective → KV degrade (at the probe or mid-operation):
    advance ``transport.fallbacks`` and log the reason."""
    obs.counter(obs.TRANSPORT_FALLBACKS).inc()
    logger.warning("transport: %s degraded to kv (%s)", site, reason)


def resolve_transport(
    coordinator: Any = None, topology: Any = None, device: Any = "cuda"
) -> Transport:
    """The engine for one operation (see the module docstring).
    ``TRANSPORT=kv`` short-circuits to KV.  ``auto`` takes the collective
    engine only with a process group over the coordinator's world (a
    one-process world stays on KV, quietly); ``collective`` also takes
    its in-process mode, and when it cannot run at all it lands on KV
    with one counted fallback.  ``device`` is where payload parts live
    (the tests pass ``"cpu"``).  Never raises."""
    from .kv import KVTransport

    with obs.span("transport/resolve"):
        mode = knobs.get_transport()
        if mode != "kv":
            try:
                from .collective import CollectiveTransport

                t = CollectiveTransport(
                    coordinator, topology=topology,
                    require_session=(mode == "auto"), device=device,
                )
                _note_engine(t.engine)
                return t
            except TransportUnavailable as e:
                if mode == "collective":
                    # an explicit request that cannot be honoured is a
                    # degrade; a quiet auto miss is not
                    count_fallback("resolve", e)
                else:
                    logger.debug("transport auto-probe: kv (%s)", e)
            except Exception as e:  # noqa: BLE001 — the probe never fails the operation
                count_fallback("resolve", e)
        t = KVTransport(coordinator)
        _note_engine(t.engine)
        return t
