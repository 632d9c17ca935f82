"""Storage plugin registry: URL scheme → plugin.

Counterpart of ``torchsnapshot_tpu/storage/__init__.py``.  This slice
carries the local filesystem only (``fs://`` or a bare path); the cloud
and in-memory backends come with later slices.
"""

from __future__ import annotations

from ..io_types import StoragePlugin


def url_to_storage_plugin(url_path: str) -> StoragePlugin:
    if "://" in url_path:
        scheme, path = url_path.split("://", 1)
        scheme = scheme or "fs"
    else:
        scheme, path = "fs", url_path
    if scheme == "fs":
        from .fs import FSStoragePlugin

        return FSStoragePlugin(root=path)
    raise RuntimeError(
        f"no storage plugin for scheme {scheme!r} in the PyTorch port "
        "(only fs:// is ported)"
    )
