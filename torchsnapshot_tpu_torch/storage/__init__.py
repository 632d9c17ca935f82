"""Storage plugin registry: URL scheme → plugin.

Counterpart of ``torchsnapshot_tpu/storage/__init__.py``.  The port
carries the local filesystem only (``fs://`` or a bare path); the cloud
and in-memory backends come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..io_types import StoragePlugin


def url_to_storage_plugin(
    url_path: str, storage_options: Optional[Dict[str, Any]] = None
) -> StoragePlugin:
    """``storage_options``: keyword arguments forwarded to the plugin's
    constructor, as in the JAX package, with two reserved keys:

    - ``"host_cache"`` is accepted and has no effect: the shared-host
      object cache (``storage/hostcache.py``) is not ported yet;
    - ``"tier"`` raises ``NotImplementedError``: tiered storage is
      ROADMAP queue A item 5."""
    opts = dict(storage_options or {})
    opts.pop("host_cache", None)
    if opts.pop("tier", None) is not None:
        raise NotImplementedError(
            "storage_options['tier'] (tiered storage) is not ported yet "
            "(ROADMAP queue A item 5)"
        )
    if "://" in url_path:
        scheme, path = url_path.split("://", 1)
        scheme = scheme or "fs"
    else:
        scheme, path = "fs", url_path
    if scheme == "fs":
        from .fs import FSStoragePlugin

        return FSStoragePlugin(root=path, **opts)
    raise RuntimeError(
        f"no storage plugin for scheme {scheme!r} in the PyTorch port "
        "(only fs:// is ported)"
    )
