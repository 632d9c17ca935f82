"""Storage plugin registry: URL scheme → plugin.

Counterpart of ``torchsnapshot_tpu/storage/__init__.py``: ``fs://`` (the
default for a bare path), ``memory://`` (tests), ``gs://`` and ``s3://``
are built in, the last two imported lazily so that their client
libraries stay optional; a third-party plugin registers under the entry-point group
``torchsnapshot_tpu_torch.storage_plugins`` (the port never loads a
plugin registered for the JAX package's group).  Only the discovery
swallows errors: a matched plugin's load and construction errors
propagate.  The shared-host object cache (``hostcache.py``) wraps the
built plugin when the ``CACHE_DIR`` knob is set, and a fast tier over
it (``tier/``) is one reserved option away.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .. import obs
from ..io_types import StoragePlugin

_ENTRY_POINT_GROUP = "torchsnapshot_tpu_torch.storage_plugins"


def url_to_storage_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    """``storage_options``: keyword arguments forwarded to the plugin's
    constructor, as in the JAX package, with two reserved keys:

    - ``"tier"`` (a dict, see ``tier.build_tiered``: ``fast_url`` and
      optionally ``policy``, ``replica_count``, ``peer_fast_urls``,
      ``verify_fast_reads``) layers a fast tier over the plugin built
      from ``url_path``, which names the DURABLE tier; the result is a
      ``TieredStoragePlugin``;
    - ``"host_cache"`` (default True) gates the shared-host object
      cache: with the ``CACHE_DIR`` knob set the built plugin is wrapped
      so co-located readers fetch each object from it once.  Plugins
      that are local copies themselves (a tier's fast root, peer fast
      roots) are built with False, so no byte is cached twice."""
    opts = dict(storage_options or {})
    tier_opts = opts.pop("tier", None)
    host_cache = opts.pop("host_cache", True)
    if tier_opts is not None:
        from ..tier import build_tiered

        durable = url_to_storage_plugin(url_path, dict(opts, host_cache=host_cache))
        return build_tiered(durable, url_path, **tier_opts)

    def _maybe_cached(plugin: StoragePlugin) -> StoragePlugin:
        from .. import knobs

        if not host_cache or knobs.get_cache_dir() is None:
            return plugin
        from .hostcache import HostCachedStoragePlugin

        return HostCachedStoragePlugin(plugin, url_path)

    if "://" in url_path:
        scheme, path = url_path.split("://", 1)
        scheme = scheme or "fs"
    else:
        scheme, path = "fs", url_path
    if scheme == "fs":
        from .fs import FSStoragePlugin

        return _maybe_cached(FSStoragePlugin(root=path, **opts))
    if scheme == "memory":
        from .memory import MemoryStoragePlugin

        return _maybe_cached(MemoryStoragePlugin(namespace=path, **opts))
    if scheme == "gs":
        from .gcs import GCSStoragePlugin

        return _maybe_cached(GCSStoragePlugin(path=path, **opts))
    if scheme == "s3":
        from .s3 import S3StoragePlugin

        return _maybe_cached(S3StoragePlugin(path=path, **opts))
    group = ()
    try:
        from importlib.metadata import entry_points

        eps = entry_points()
        group = (
            eps.select(group=_ENTRY_POINT_GROUP)
            if hasattr(eps, "select")
            else eps.get(_ENTRY_POINT_GROUP, [])
        )
    except Exception as e:  # noqa: BLE001 — discovery only
        obs.swallowed_exception("storage.entry_point_discovery", e)
    for ep in group:
        if ep.name == scheme:
            return _maybe_cached(ep.load()(path, **opts))
    raise RuntimeError(f"no storage plugin registered for scheme {scheme!r}")
