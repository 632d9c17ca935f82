"""Tiered checkpoint storage: a fast local tier over a durable one.

Counterpart of ``torchsnapshot_tpu/tier/``:

- ``TierConfig``: a tiered ``SnapshotManager``'s settings (fast root,
  policy, replica placement, fast-tier retention);
- ``TieredStoragePlugin``: the composite plugin (``plugin.py``);
- ``build_tiered``: a ``TieredStoragePlugin`` from a durable plugin and
  the ``storage_options["tier"]`` dict (``url_to_storage_plugin``);
- ``drain_promotions`` / ``get_promoter``: the write-back promotion
  queue (``promoter.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..io_types import StoragePlugin
from .plugin import TieredStoragePlugin  # noqa: F401
from .promoter import drain_promotions, get_promoter  # noqa: F401

__all__ = [
    "TierConfig",
    "TieredStoragePlugin",
    "build_tiered",
    "drain_promotions",
    "get_promoter",
]


@dataclass
class TierConfig:
    """Tier settings for a ``SnapshotManager(root, tier=...)``.

    ``fast_root`` — THIS host's fast-tier root (local SSD path or any
    storage URL); per-step snapshots land under ``{fast_root}/{prefix}N``
    mirroring the durable layout.
    ``policy`` — "write_back" | "write_through"; None = the
    ``TORCHSNAPSHOT_TPU_TORCH_TIER_POLICY`` knob.
    ``fast_keep_last_n`` — committed steps that keep a fast-tier copy
    (older fast copies are evicted once durably committed); None = the
    ``TORCHSNAPSHOT_TPU_TORCH_TIER_FAST_KEEP_LAST_N`` knob.
    ``replica_count`` — mirror each rank's fast payloads to this many
    other ranks' fast roots (0 = off).
    ``peer_fast_roots`` — all ranks' fast roots indexed by rank, for
    replica placement and peer-fallback reads; None = exchange over the
    coordination KV at take time (requires peer-addressable URLs).
    ``verify_fast_reads`` — None = the
    ``TORCHSNAPSHOT_TPU_TORCH_TIER_VERIFY_FAST_READS`` knob.
    """

    fast_root: str
    policy: Optional[str] = None
    fast_keep_last_n: Optional[int] = None
    replica_count: int = 0
    peer_fast_roots: Optional[List[str]] = None
    verify_fast_reads: Optional[bool] = None


def build_tiered(
    durable: StoragePlugin,
    durable_url: str,
    fast_url: str,
    policy: Optional[str] = None,
    replica_count: int = 0,
    peer_fast_urls: Optional[List[str]] = None,
    verify_fast_reads: Optional[bool] = None,
    fast_storage_options: Optional[Dict[str, Any]] = None,
) -> TieredStoragePlugin:
    """Wrap ``durable`` (already constructed for ``durable_url``) with a
    fast tier built from ``fast_url`` — the ``storage_options["tier"]``
    entry point (storage/__init__.py)."""
    from ..storage import url_to_storage_plugin

    # the fast tier IS this host's local copy — routing it through the
    # shared-host object cache would store every byte twice
    fast = url_to_storage_plugin(
        fast_url, dict(fast_storage_options or {}, host_cache=False)
    )
    return TieredStoragePlugin(
        fast=fast,
        durable=durable,
        fast_url=fast_url,
        durable_url=durable_url,
        policy=policy,
        replica_count=replica_count,
        peer_fast_urls=peer_fast_urls,
        verify_fast_reads=verify_fast_reads,
    )
