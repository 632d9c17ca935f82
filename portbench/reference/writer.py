"""A plain writer of the snapshot format: one object per array, no
slabs or chunks, with the digests the format asks for (each object's
crc32, adler32 and size in the ``objects`` table, each entry's crc32).
The control run puts it in the program's place to show that the
comparisons fail on a lower precision."""

from __future__ import annotations

import json
import zlib
from typing import Any, Dict, Mapping

import torch

from .reader import CRC_MARKER, DTYPES, METADATA

_NAMES = {v: k for k, v in DTYPES.items()}


def write(arrays: Mapping[str, torch.Tensor], primitives: Mapping[str, Any] = {}) -> Dict[str, bytes]:
    """Objects (name → bytes) of a one-rank snapshot of ``arrays`` and
    ``primitives``, keyed by logical path (``"0/model/embed.weight"``)."""
    objects: Dict[str, bytes] = {}
    manifest: Dict[str, Dict[str, Any]] = {}
    digests: Dict[str, list] = {}
    for i, (path, t) in enumerate(arrays.items()):
        location = f"0/plain.{i}"
        t = t.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        objects[location] = raw
        digests[location] = [zlib.crc32(raw), zlib.adler32(raw), len(raw)]
        manifest[path] = {
            "type": "Array", "location": location, "serializer": "buffer_protocol",
            "dtype": _NAMES[t.dtype], "shape": list(t.shape), "replicated": False,
            "crc32": digests[location][0],
        }
    for path, v in primitives.items():
        manifest[path] = {"type": type(v).__name__, "readable": str(v), "replicated": False}
    body = json.dumps(
        {"manifest": manifest, "objects": digests, "version": "0.1.0", "world_size": 1}, sort_keys=True
    )
    objects[METADATA] = f"{body}{CRC_MARKER}{zlib.crc32(body.encode()):08x}".encode()
    return objects
