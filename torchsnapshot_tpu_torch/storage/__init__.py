"""Storage plugin registry: URL scheme → plugin.

Counterpart of ``torchsnapshot_tpu/storage/__init__.py``: ``fs://`` (the
default for a bare path) and ``memory://`` (tests) are built in; a
third-party plugin registers under the entry-point group
``torchsnapshot_tpu_torch.storage_plugins`` (the port never loads a
plugin registered for the JAX package's group).  Only the discovery
swallows errors: a matched plugin's load and construction errors
propagate.  Not ported: ``gs://`` and ``s3://`` (ROADMAP queue A item
3.6), the shared-host cache and tiers (item 3.5).
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

    - ``"host_cache"`` is accepted and has no effect: the shared-host
      object cache (``storage/hostcache.py``) is not ported yet (ROADMAP
      queue A item 3.5);
    - ``"tier"`` raises ``NotImplementedError``: tiered storage is
      ROADMAP queue A item 3.5."""
    opts = dict(storage_options or {})
    opts.pop("host_cache", None)
    if opts.pop("tier", None) is not None:
        raise NotImplementedError(
            "storage_options['tier'] (tiered storage) is not ported yet "
            "(ROADMAP queue A item 3.5)"
        )
    if "://" in url_path:
        scheme, path = url_path.split("://", 1)
        scheme = scheme or "fs"
    else:
        scheme, path = "fs", url_path
    if scheme == "fs":
        from .fs import FSStoragePlugin

        return FSStoragePlugin(root=path, **opts)
    if scheme == "memory":
        from .memory import MemoryStoragePlugin

        return MemoryStoragePlugin(namespace=path, **opts)
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
            return ep.load()(path, **opts)
    raise RuntimeError(f"no storage plugin registered for scheme {scheme!r}")
