"""A plain reader of the snapshot format: the ``.snapshot_metadata``
document with its crc32 trailer, its table of stored digests, and the
raw bytes of array, chunked and sharded entries.

It reads a mapping of object name to bytes (the stored objects as the
storage holds them), so it shares no code path with the program's own
restore.  Compressed objects (a ``codecs`` table) are refused: the
benchmark runs with the codec off.
"""

from __future__ import annotations

import json
import warnings
import zlib
from typing import Any, Dict, List, Mapping, Optional

import torch

METADATA = ".snapshot_metadata"
CRC_MARKER = "\n#tsnp-meta-crc32:"

DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}

PRIMITIVES = {"int": int, "float": float, "str": str, "bool": lambda s: s == "True"}


def metadata_document(raw: bytes) -> Dict[str, Any]:
    """The metadata's JSON, after its trailer's crc32 was checked."""
    text = bytes(raw).decode()
    body, marker, trailer = text.rpartition(CRC_MARKER)
    if not marker:
        raise ValueError("metadata has no crc32 trailer")
    if trailer.strip() != f"{zlib.crc32(body.encode()):08x}":
        raise ValueError("metadata crc32 does not match its trailer")
    return json.loads(body)


class PlainSnapshot:
    def __init__(self, objects: Mapping[str, Any]) -> None:
        self.objects = objects
        doc = metadata_document(objects[METADATA])
        if doc.get("codecs"):
            raise ValueError("compressed objects are not read by the plain reader")
        self.manifest: Dict[str, Dict[str, Any]] = doc["manifest"]
        # location → [crc32, adler32, size] of the stored object; None
        # where the document has no such table
        self.digests: Optional[Dict[str, List[int]]] = doc.get("objects")

    def pieces(self) -> List[Dict[str, Any]]:
        """Every stored piece an array entry names (``location``, maybe
        ``byte_range`` and ``crc32``): the entry itself, or its chunks or
        shards."""
        out: List[Dict[str, Any]] = []
        for e in self.manifest.values():
            if e.get("type") == "Array":
                out.append(e)
            elif e.get("type") in ("ChunkedArray", "ShardedArray"):
                out.extend(e["chunks"] if e["type"] == "ChunkedArray" else e["shards"])
        return out

    def view(self, location: str, byte_range=None) -> memoryview:
        """The stored bytes of ``location``, or of ``byte_range`` in it."""
        view = memoryview(self.objects[location]).cast("B")
        return view if byte_range is None else view[byte_range[0]:byte_range[1]]

    def _piece(self, location: str, byte_range, dtype: torch.dtype, shape) -> torch.Tensor:
        view = self.view(location, byte_range)
        numel = 1
        for s in shape:
            numel *= int(s)
        if view.nbytes != numel * dtype.itemsize:
            raise ValueError(f"{location}: {view.nbytes} bytes for {list(shape)} of {dtype}")
        if numel == 0:
            return torch.empty(tuple(shape), dtype=dtype)
        with warnings.catch_warnings():
            # the stored objects are read-only; the tensor is only read
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(view, dtype=torch.uint8)
        return flat.view(dtype).reshape(tuple(shape))

    def tensor(self, path: str) -> torch.Tensor:
        """The array at logical ``path`` (``"0/model/embed.weight"``), on
        the CPU; a view of the stored bytes where it is one piece."""
        e = self.manifest[path]
        kind = e["type"]
        dtype = DTYPES[e["dtype"]]
        if kind == "Array":
            if e["serializer"] != "buffer_protocol":
                raise ValueError(f"{path}: serializer {e['serializer']!r}")
            return self._piece(e["location"], e.get("byte_range"), dtype, e["shape"])
        if kind in ("ChunkedArray", "ShardedArray"):
            pieces = e["chunks"] if kind == "ChunkedArray" else e["shards"]
            out = torch.empty(tuple(e["shape"]), dtype=dtype)
            covered = 0
            for p in pieces:
                index = tuple(slice(o, o + s) for o, s in zip(p["offsets"], p["sizes"]))
                out[index] = self._piece(p["location"], p.get("byte_range"), dtype, p["sizes"])
                covered += out[index].numel()
            if covered != out.numel():
                raise ValueError(f"{path}: pieces cover {covered} of {out.numel()} elements")
            return out
        raise ValueError(f"{path}: not an array entry ({kind})")

    def primitive(self, path: str) -> Any:
        e = self.manifest[path]
        return PRIMITIVES[e["type"]](e["readable"])
