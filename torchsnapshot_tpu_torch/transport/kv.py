"""KVTransport: the coordination KV's chunked base64 blobs as an engine.

Counterpart of ``torchsnapshot_tpu/transport/kv.py``: the coordinator's
``kv_publish_blob``/``kv_try_fetch_blob`` (parts first, the meta key last,
crc32 checked on fetch) behind the ``Transport`` API, metered under
``transport.kv_*``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from .. import knobs, obs
from . import Transport


class KVTransport(Transport):
    engine = "kv"

    def __init__(self, coordinator: Any) -> None:
        self.coordinator = coordinator
        m = obs.REGISTRY
        self._m_ops = m.counter(obs.TRANSPORT_KV_OPS)
        self._m_bytes = m.counter(obs.TRANSPORT_KV_BYTES)
        self._m_lat = m.histogram(obs.TRANSPORT_KV_S)

    def publish(self, prefix: str, data: Any) -> int:
        """Returns the number of part keys written (the cleanup ledger)."""
        with obs.span("transport/kv_publish", prefix=prefix):
            t0 = time.monotonic()
            part = knobs.get_fanout_part_bytes()
            n = self.coordinator.kv_publish_blob(prefix, data, part)
            self._m_ops.inc()
            self._m_bytes.inc(n)
            self._m_lat.observe(time.monotonic() - t0)
            return max(1, (n + part - 1) // part)

    def try_fetch(self, prefix: str) -> Optional[bytes]:
        """None while nothing is published; ``ValueError`` on a digest
        mismatch propagates (the caller chooses a retry or a direct read)."""
        with obs.span("transport/kv_fetch", prefix=prefix):
            t0 = time.monotonic()
            data = self.coordinator.kv_try_fetch_blob(prefix)
            if data is not None:
                self._m_ops.inc()
                self._m_bytes.inc(len(data))
                self._m_lat.observe(time.monotonic() - t0)
            return data

    def cleanup(self, prefix: str, nparts: int) -> None:
        """The meta key first (a straggler's probe then sees a clean
        absence), then the parts."""
        self.coordinator.kv_try_delete(f"{prefix}/meta")
        for i in range(int(nparts)):
            self.coordinator.kv_try_delete(f"{prefix}/p{i}")
