"""Reversible flattening of nested containers into logical paths.

The port's own copy of ``torchsnapshot_tpu/flatten.py`` (logical paths
are part of the shared snapshot format).  Nested dict/OrderedDict/list/tuple structures are
flattened into a ``{logical_path: leaf}`` mapping plus a manifest of
container entries that makes the flattening exactly reversible.

Logical paths join keys with ``/``; ``/`` and ``%`` inside string keys are
percent-escaped (reference flatten.py:215-226).  Dicts are only flattened
when all keys are str/int and no two keys collide after encoding; otherwise
the whole dict is treated as a leaf object (reference
flatten.py:144-176).

Compared to the reference we additionally flatten tuples (JAX pytrees are
tuple-heavy) and treat any pytree-registered leaf the same way.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Tuple, Union

from .manifest import (
    DictEntry,
    Entry,
    ListEntry,
    Manifest,
    OrderedDictEntry,
    TupleEntry,
    is_container_entry,
)


def _encode(key: str) -> str:
    return key.replace("%", "%25").replace("/", "%2F")


def _decode(key: str) -> str:
    return key.replace("%2F", "/").replace("%25", "%")


def _should_flatten_dict(d: dict) -> bool:
    # Only flatten dicts whose keys are unambiguously encodable
    # (reference flatten.py:144-176).
    encoded = set()
    for k in d.keys():
        if isinstance(k, bool) or not isinstance(k, (str, int)):
            return False
        e = _encode(str(k))
        if e in encoded:
            return False
        encoded.add(e)
    return True


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def flatten(obj: Any, prefix: str = "") -> Tuple[Manifest, Dict[str, Any]]:
    """Flatten ``obj`` into (container manifest, {logical_path: leaf}).

    Reference: torchsnapshot/flatten.py:20-76.
    """
    manifest: Manifest = {}
    flattened: Dict[str, Any] = {}
    _flatten_inplace(obj, prefix, manifest, flattened)
    return manifest, flattened


def _flatten_inplace(
    obj: Any, prefix: str, manifest: Manifest, flattened: Dict[str, Any]
) -> None:
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        manifest[prefix] = (
            TupleEntry(length=len(obj))
            if isinstance(obj, tuple)
            else ListEntry(length=len(obj))
        )
        for idx, v in enumerate(obj):
            _flatten_inplace(v, _join(prefix, str(idx)), manifest, flattened)
    elif isinstance(obj, dict) and _should_flatten_dict(obj):
        keys: List[Union[str, int]] = list(obj.keys())
        if isinstance(obj, OrderedDict):
            manifest[prefix] = OrderedDictEntry(keys=keys)
        else:
            manifest[prefix] = DictEntry(keys=keys)
        for k, v in obj.items():
            _flatten_inplace(v, _join(prefix, _encode(str(k))), manifest, flattened)
    else:
        flattened[prefix] = obj


def inflate(
    manifest: Manifest,
    flattened: Dict[str, Any],
    prefix: str = "",
    allow_missing: bool = False,
) -> Any:
    """Rebuild the nested object from a container manifest + flat leaves.

    ``allow_missing=True`` skips dict keys whose subtree has no entries —
    used by non-strict elastic restores where a grown world's new ranks see
    rank 0's containers but not its per-rank leaves (reference
    handle_sharded_tensor_elasticity, manifest_ops.py:180-249).

    Reference: torchsnapshot/flatten.py:79-143.
    """
    if prefix:
        manifest = {
            (k[len(prefix) + 1 :] if k != prefix else ""): v
            for k, v in manifest.items()
            if k == prefix or k.startswith(prefix + "/")
        }
        flattened = {
            (k[len(prefix) + 1 :] if k != prefix else ""): v
            for k, v in flattened.items()
            if k == prefix or k.startswith(prefix + "/")
        }
    return _inflate_path("", manifest, flattened, allow_missing)


def _inflate_path(
    path: str,
    manifest: Manifest,
    flattened: Dict[str, Any],
    allow_missing: bool = False,
) -> Any:
    if path in manifest and is_container_entry(manifest[path]):
        entry: Entry = manifest[path]
        if isinstance(entry, DictEntry):
            out: Any = OrderedDict() if isinstance(entry, OrderedDictEntry) else {}
            for k in entry.keys:
                child = _join(path, _encode(str(k)))
                if allow_missing and not _subtree_present(
                    child, manifest, flattened
                ):
                    continue
                out[k] = _inflate_path(child, manifest, flattened, allow_missing)
            return out
        else:  # ListEntry / TupleEntry
            items = []
            for idx in range(entry.length):
                child = _join(path, str(idx))
                if child in manifest or child in flattened:
                    items.append(
                        _inflate_path(child, manifest, flattened, allow_missing)
                    )
                elif allow_missing:
                    continue
                else:
                    raise KeyError(
                        f"list element {child!r} missing from manifest/leaves"
                    )
            return tuple(items) if isinstance(entry, TupleEntry) else items
    if path in flattened:
        return flattened[path]
    raise KeyError(f"logical path {path!r} missing from both manifest and leaves")


def _subtree_present(
    path: str, manifest: Manifest, flattened: Dict[str, Any]
) -> bool:
    """True iff inflating ``path`` would produce real data: a leaf exists at
    or under it, or it is a genuinely empty container. A container whose
    leaves are all absent (e.g. per-rank state invisible to a grown world's
    new rank) is NOT present — its key is skipped entirely rather than
    restored as an empty shell."""
    if path in flattened:
        return True
    entry = manifest.get(path)
    if entry is None:
        prefix = path + "/"
        return any(k.startswith(prefix) for k in flattened)
    if isinstance(entry, DictEntry):
        if not entry.keys:
            return True
        return any(
            _subtree_present(_join(path, _encode(str(k))), manifest, flattened)
            for k in entry.keys
        )
    if isinstance(entry, ListEntry):
        if entry.length == 0:
            return True
        return any(
            _subtree_present(_join(path, str(i)), manifest, flattened)
            for i in range(entry.length)
        )
    return False
