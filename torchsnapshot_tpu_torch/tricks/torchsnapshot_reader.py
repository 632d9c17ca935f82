"""Read checkpoints written by the original torchsnapshot library.

Counterpart of ``torchsnapshot_tpu/tricks/torchsnapshot_reader.py``: a
migrating user's trained checkpoints, in the reference's on-disk format,
come back as a nested state dict of torch tensors (on the card unless
``device="cpu"``) and python values, equal to what the JAX reader
returns as numpy arrays.  ``torch_save`` payloads are unpickled only
when the ``ALLOW_PICKLE_OBJECTS`` knob allows it.

The format (reference files by line, as the JAX reader cites them):

- ``.snapshot_metadata`` is JSON, a YAML subset (manifest.py:442-448);
  entries are tagged unions on ``type`` (manifest.py:450-475).  Metadata
  that is not JSON is parsed as YAML, with ``yaml`` imported only then.
- Keys are ``<rank>/<logical path>`` per-rank views (io_preparer.py:
  52-61); ``/`` inside a dict key is %-escaped (flatten.py:215-226).
- Containers: ``dict``/``OrderedDict`` carry ``keys``; ``list`` children
  sit at integer path components (flatten.py:20-77).
- Primitives are inline: int/str/bool as strings, bytes as base64, float
  as base64 of a little-endian f64 (manifest.py:335-400).
- ``Tensor``: ``location`` (and ``byte_range``), ``serializer``
  (``buffer_protocol``: raw C-order bytes; ``torch_save``; the legacy
  ``per_tensor_qtensor``/``per_channel_qtensor``), ``dtype`` such as
  ``torch.bfloat16``, ``shape`` (manifest.py:49-95).
- ``ChunkedTensor`` (``chunks``), ``ShardedTensor`` and ``DTensor``
  (``shards``, each rank's manifest listing its own; the tensor is the
  union over the ranks, replicated boxes repeated) of {offsets, sizes,
  tensor} (manifest.py:118-261).
- ``object`` entries are ``torch.save`` pickles.

Quantized payloads are dequantized to float32 with the JAX reader's
arithmetic (a warning once per import), as the JAX reader does.  A
``torch_save`` tensor of a dtype numpy cannot hold, and an unknown dtype,
raise the JAX reader's errors.
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
import logging
import struct
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import unquote

import numpy as np
import torch

from .. import knobs
from ..io_types import ReadIO, run_in_fresh_loop

logger = logging.getLogger(__name__)

# one summary warning per read_torchsnapshot call
_quant_warned = False


def _warn_dequantized(kind: str, dtype: Any) -> None:
    global _quant_warned
    if _quant_warned:
        return
    _quant_warned = True
    logger.warning(
        "importing quantized payload(s) (first: %s, dtype %s): dequantized to float32 as the "
        "JAX package's reader does, so scales/zero-points are consumed by the import; "
        "re-quantize after migration if needed (warning shown once per import)",
        kind, dtype,
    )


_TORCH_DTYPES = {
    f"torch.{name}": getattr(torch, name)
    for name in ("float32", "float64", "float16", "bfloat16", "int8", "int16", "int32", "int64", "uint8",
                 "bool", "complex64", "complex128", "float8_e4m3fn", "float8_e5m2")
}


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported reference dtype {name!r} — no numpy/ml_dtypes equivalent (quantized "
            f"payloads import via their own serializers and dequantize to float32)"
        ) from None


# quantized storage dtypes: the integer layout of each element
# (reference serialization.py:85-87,105-108)
_QTENSOR_STORAGE = {"torch.qint8": np.dtype(np.int8), "torch.quint8": np.dtype(np.uint8),
                    "torch.qint32": np.dtype(np.int32)}
_QTENSOR_SERIALIZERS = ("per_tensor_qtensor", "per_channel_qtensor")


def _decode_qtensor(data, serializer: str, dtype: str, shape: List[int]) -> torch.Tensor:
    """The reference's quantized payloads (serialization.py:278-477),
    dequantized to float32 as ``(int - zero_point) * scale`` in f64.

    per_tensor: int storage | f64 q_scale | i64 q_zero_point;
    per_channel: i64 axis | int storage | f64 scales[shape[axis]] |
    i64 zero_points[shape[axis]]."""
    storage_dtype = _QTENSOR_STORAGE.get(dtype)
    if storage_dtype is None:
        raise ValueError(f"{serializer} entry with non-quantized dtype {dtype!r}")
    data = memoryview(data).cast("B")
    n = int(np.prod(shape))
    data_sz = n * storage_dtype.itemsize
    if serializer == "per_tensor_qtensor":
        if data.nbytes != data_sz + 16:
            raise ValueError(
                f"per_tensor_qtensor payload is {data.nbytes} bytes; dtype {dtype} shape {tuple(shape)} "
                f"implies {data_sz + 16}"
            )
        ints = np.frombuffer(data, storage_dtype, count=n).reshape(shape)
        scale, zero_point = struct.unpack("dq", data[data_sz : data_sz + 16])
        out = ((ints.astype(np.float64) - zero_point) * scale).astype(np.float32)
    else:
        (axis,) = struct.unpack("q", data[:8])
        if not 0 <= axis < len(shape):
            raise ValueError(f"per_channel_qtensor axis {axis} invalid for shape {tuple(shape)}")
        ch = shape[axis]
        if data.nbytes != 8 + data_sz + 16 * ch:
            raise ValueError(
                f"per_channel_qtensor payload is {data.nbytes} bytes; dtype {dtype} shape {tuple(shape)} "
                f"axis {axis} implies {8 + data_sz + 16 * ch}"
            )
        ints = np.frombuffer(data, storage_dtype, count=n, offset=8).reshape(shape)
        scales = np.frombuffer(data, np.float64, count=ch, offset=8 + data_sz)
        zero_points = np.frombuffer(data, np.int64, count=ch, offset=8 + data_sz + 8 * ch)
        bshape = [1] * len(shape)
        bshape[axis] = ch
        out = ((ints.astype(np.float64) - zero_points.reshape(bshape)) * scales.reshape(bshape)).astype(np.float32)
    _warn_dequantized(serializer, dtype)
    return torch.from_numpy(out)


def _raw_tensor(data, dtype: torch.dtype, shape: List[int]) -> torch.Tensor:
    """A host tensor holding a copy of the raw C-order ``data``.  numpy
    reads the buffer (read-only and zero-length ones included); the copy
    is reinterpreted as ``dtype`` by torch, so bf16 and fp8 need no
    numpy dtype."""
    raw = np.frombuffer(data, np.uint8)
    n = int(np.prod(shape))
    if raw.nbytes != n * dtype.itemsize:
        raise ValueError(f"cannot reshape {raw.nbytes} bytes into a {dtype} tensor of shape {tuple(shape)}")
    if n == 0:  # torch cannot view an empty byte tensor as a wider dtype
        return torch.empty(shape, dtype=dtype)
    return torch.from_numpy(raw.copy()).view(dtype).reshape(shape)


def _read_bytes(storage, location: str, byte_range: Optional[List[int]]) -> memoryview:
    read_io = ReadIO(path=location, byte_range=list(byte_range) if byte_range else None)
    run_in_fresh_loop(storage.read(read_io))
    return memoryview(read_io.buf).cast("B")


class _BlobCache:
    """Prefetches every blob the manifest references on one event loop,
    16 reads at a time, and drops each once its last consumer took it
    (consumers counted per (location, byte range): replicated shards can
    share one), so raw blobs shrink as the assembled tensors grow."""

    def __init__(self, storage, concurrency: int = 16) -> None:
        self._storage = storage
        self._concurrency = concurrency
        self._blobs: Dict[Tuple[str, Optional[Tuple[int, int]]], Any] = {}
        self._refs: Dict[Tuple[str, Optional[Tuple[int, int]]], int] = {}

    @staticmethod
    def _key(entry: dict) -> Tuple[str, Optional[Tuple[int, int]]]:
        br = entry.get("byte_range")
        return entry["location"], (tuple(br) if br else None)

    def prefetch(self, tensorish_entries: List[dict]) -> None:
        keys = []
        for entry in tensorish_entries:
            for sub in entry.get("chunks") or entry.get("shards") or [entry]:
                tensor = sub.get("tensor", sub)
                if "location" in tensor:
                    keys.append(self._key(tensor))
        for k in keys:
            self._refs[k] = self._refs.get(k, 0) + 1
        keys = [k for k in dict.fromkeys(keys) if k not in self._blobs]

        async def fetch_all() -> None:
            sem = asyncio.Semaphore(self._concurrency)

            async def one(key):
                loc, br = key
                async with sem:
                    read_io = ReadIO(path=loc, byte_range=list(br) if br else None)
                    await self._storage.read(read_io)
                self._blobs[key] = memoryview(read_io.buf).cast("B")

            await asyncio.gather(*(one(k) for k in keys))

        if keys:
            run_in_fresh_loop(fetch_all())

    def get(self, entry: dict):
        key = self._key(entry)
        if key in self._blobs:
            data = self._blobs[key]
        else:
            data = _read_bytes(self._storage, key[0], key[1])
            if self._refs.get(key, 0) > 1:  # more consumers coming
                self._blobs[key] = data
        n = self._refs.get(key, 0)
        if n <= 1:
            self._refs.pop(key, None)
            self._blobs.pop(key, None)  # the last consumer: evict
        else:
            self._refs[key] = n - 1
        return data


def _decode_primitive(entry: dict) -> Any:
    t, sv = entry["type"], entry["serialized_value"]
    if t == "int":
        return int(sv)
    if t == "str":
        return sv
    if t == "bool":
        if sv not in ("True", "False"):
            raise ValueError(f"bad bool serialized_value {sv!r}")
        return sv == "True"
    if t == "bytes":
        return base64.b64decode(sv.encode())
    if t == "float":
        return struct.unpack("d", base64.b64decode(sv.encode()))[0]
    raise ValueError(f"unknown primitive type {t!r}")


def _torch_load(data) -> Any:
    if not knobs.is_pickle_allowed():
        raise RuntimeError(
            "entry uses the reference's torch_save (pickle) serializer; decoding requires "
            "TORCHSNAPSHOT_TPU_TORCH_ALLOW_PICKLE_OBJECTS=1 and must only be used on trusted snapshots"
        )
    return torch.load(io.BytesIO(data), weights_only=False)


def _decode_tensor(blobs: _BlobCache, entry: dict) -> torch.Tensor:
    """One ``Tensor`` entry as a host tensor."""
    data = blobs.get(entry)
    serializer = entry.get("serializer")
    if serializer in _QTENSOR_SERIALIZERS:
        return _decode_qtensor(data, serializer, entry["dtype"], entry["shape"])
    if serializer == "torch_save":
        tensor = _torch_load(data)
        if getattr(tensor, "is_quantized", False):
            # the current reference writes quantized tensors through
            # torch_save (io_preparers/tensor.py:70-73)
            _warn_dequantized("torch_save", tensor.dtype)
            return tensor.dequantize().to(torch.float32)
        try:
            tensor.numpy()  # the JAX reader's own test: a dtype numpy holds
        except TypeError:
            raise ValueError(
                f"torch_save tensor of dtype {tensor.dtype} has no numpy equivalent — cast the leaf "
                f"before saving, or load this snapshot once with the reference library"
            ) from None
        return tensor
    return _raw_tensor(data, _torch_dtype(entry["dtype"]), entry["shape"])


def _dedup_pieces(pieces: List[dict]) -> List[dict]:
    """Replicated shards repeat a box across rank views: one per
    (offsets, sizes)."""
    seen = {}
    for piece in pieces:
        seen.setdefault((tuple(piece["offsets"]), tuple(piece["sizes"])), piece)
    return list(seen.values())


def _dtensor_expected_boxes(entry: dict) -> Optional[int]:
    """How many distinct boxes a DTensor's mesh and dim_map imply (the
    product of the sizes of the mesh dims dim_map names; manifest.py:
    222-261): a lost trailing shard shrinks the union's bounding box
    where coverage alone cannot see it."""
    mesh, dim_map = entry.get("mesh"), entry.get("dim_map")
    if mesh is None or dim_map is None:
        return None
    try:
        mesh_shape = np.asarray(mesh).shape
        sharded = {
            md for dm in dim_map for md in (dm if isinstance(dm, (list, tuple)) else [dm])
            if md is not None and md >= 0
        }
        n = 1
        for md in sharded:
            if md < len(mesh_shape):
                n *= mesh_shape[md]
        return n
    except Exception:  # noqa: BLE001 — malformed mesh metadata: no extra check
        return None


def _assemble_pieces(blobs: _BlobCache, shape: List[int], dtype: str, pieces: List[dict],
                     expected_boxes: Optional[int] = None) -> torch.Tensor:
    """Paste {offsets, sizes, tensor} pieces into one host tensor; a union
    with holes raises instead of returning uninitialised memory."""
    pieces = _dedup_pieces(pieces)
    if expected_boxes is not None and len(pieces) != expected_boxes:
        raise ValueError(
            f"DTensor shard union has {len(pieces)} distinct boxes but mesh/dim_map imply {expected_boxes} "
            f"— a rank's shards are missing from the manifest"
        )
    covered = sum(int(np.prod(p["sizes"])) for p in pieces)
    total = int(np.prod(shape))
    if covered != total:
        raise ValueError(
            f"shard/chunk union covers {covered} of {total} elements of shape {tuple(shape)} — incomplete "
            f"or overlapping pieces (elasticity-trimmed or corrupted manifest?)"
        )
    # quantized pieces decode to float32 (legacy serializers, or torch_save
    # pieces under a quantized entry dtype)
    quantized = dtype in _QTENSOR_STORAGE or any(
        p["tensor"].get("serializer") in _QTENSOR_SERIALIZERS for p in pieces
    )
    out = torch.empty(tuple(shape), dtype=torch.float32 if quantized else _torch_dtype(dtype))
    for piece in pieces:
        sub = _decode_tensor(blobs, piece["tensor"])
        slices = tuple(slice(o, o + s) for o, s in zip(piece["offsets"], piece["sizes"]))
        out[slices] = sub.reshape(piece["sizes"])
    return out


def _decode_leaf(blobs: _BlobCache, entry: dict) -> Any:
    t = entry["type"]
    if t in ("int", "str", "bool", "bytes", "float"):
        return _decode_primitive(entry)
    if t == "Tensor":
        return _decode_tensor(blobs, entry)
    if t in ("ChunkedTensor", "ShardedTensor", "DTensor"):
        pieces = entry.get("chunks") or entry.get("shards") or []
        if not pieces:
            raise ValueError(f"{t} entry records no shards/chunks — trimmed or corrupted manifest")
        # Sharded/DTensor entries record no shape or dtype: the shape is
        # the bounding box of the union, the dtype any shard's
        shape = entry.get("shape")
        dtype = entry.get("dtype")
        if shape is None:
            ndim = len(pieces[0]["offsets"])
            shape = [max(p["offsets"][d] + p["sizes"][d] for p in pieces) for d in range(ndim)]
        if dtype is None:
            dtype = pieces[0]["tensor"]["dtype"]
        return _assemble_pieces(blobs, shape, dtype, pieces, expected_boxes=_dtensor_expected_boxes(entry))
    if t == "object":
        return _torch_load(blobs.get(entry))
    raise ValueError(f"unknown entry type {t!r}")


_CONTAINER_TYPES = ("dict", "OrderedDict", "list")


def _merge_sharded_across_ranks(manifest: dict) -> dict:
    """The union of each sharded tensor's shards over every rank's view
    (reference manifest_ops.py:111-177), deduplicated by box."""
    merged: Dict[str, dict] = {}
    for key, entry in manifest.items():
        if entry.get("type") not in ("ShardedTensor", "DTensor"):
            continue
        suffix = key.partition("/")[2]
        if suffix not in merged:
            merged[suffix] = {**entry, "shards": []}
        merged[suffix]["shards"].extend(entry.get("shards") or [])
    for slot in merged.values():
        slot["shards"] = _dedup_pieces(slot["shards"])
    return merged


def _parse_metadata(raw) -> Dict[str, Any]:
    raw = bytes(raw)
    try:
        return json.loads(raw)
    except ValueError:  # hand-edited YAML outside the JSON subset
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(
                ".snapshot_metadata is not JSON, and reading it as YAML needs the module 'yaml' "
                "(PyYAML), which is not installed"
            ) from e
        return yaml.safe_load(raw)


def peek_torchsnapshot(path: str) -> Dict[str, Any]:
    """A reference snapshot's parsed metadata, ``{"version",
    "world_size", "manifest"}``, with no payload read; pass it to
    ``read_torchsnapshot(metadata=...)`` to skip a second fetch."""
    from ..storage import url_to_storage_plugin

    storage = url_to_storage_plugin(path)
    try:
        return _parse_metadata(_read_bytes(storage, ".snapshot_metadata", None))
    finally:
        storage.sync_close()


def _rank_view(manifest: Dict[str, dict], rank: int) -> Dict[str, dict]:
    """Rank ``rank``'s entries by logical path, plus rank 0's replicated
    leaves and their ancestors: the reference records replicated entries
    in rank 0's manifest only (partitioner.py:311-355) and overlays them
    on every other rank's view (manifest_ops.py:35-109)."""
    view = {key.partition("/")[2]: entry for key, entry in sorted(manifest.items()) if key.startswith(f"{rank}/")}
    if rank == 0:
        return view
    rank0 = {key.partition("/")[2]: entry for key, entry in manifest.items() if key.startswith("0/")}
    for suffix, e in rank0.items():
        if suffix in view or e["type"] in _CONTAINER_TYPES or not e.get("replicated"):
            continue
        view[suffix] = e
        parent = suffix.rpartition("/")[0]
        while parent and parent not in view:
            if parent in rank0:
                view[parent] = rank0[parent]
            parent = parent.rpartition("/")[0]
    return view


def read_torchsnapshot(path: str, rank: int = 0, metadata: Optional[Dict[str, Any]] = None,
                       device: Any = "cuda") -> Dict[str, Any]:
    """A reference-format snapshot as a nested state dict of tensors on
    ``device`` (``"cpu"`` for host tensors) and python values.

    ``rank``: whose view to read; rank 0's holds every replicated and
    sharded entry whole, which is what consolidating a distributed
    reference checkpoint into one process wants.  Each leaf is decoded
    on the host and moved to ``device`` before the next."""
    from ..storage import url_to_storage_plugin

    global _quant_warned
    _quant_warned = False  # one summary warning per import
    storage = url_to_storage_plugin(path)
    try:
        if metadata is None:
            metadata = _parse_metadata(_read_bytes(storage, ".snapshot_metadata", None))
        manifest: Dict[str, dict] = metadata["manifest"]
        sharded_full = _merge_sharded_across_ranks(manifest)
        view = _rank_view(manifest, rank)
        containers = {s: e for s, e in view.items() if e["type"] in _CONTAINER_TYPES}
        leaves = {s: sharded_full.get(s, e) for s, e in view.items() if e["type"] not in _CONTAINER_TYPES}
        blobs = _BlobCache(storage)
        blobs.prefetch(list(leaves.values()))
        flat: Dict[str, Any] = {}
        for suffix, entry in leaves.items():
            value = _decode_leaf(blobs, entry)
            flat[suffix] = value.to(device) if isinstance(value, torch.Tensor) else value
        return _inflate(containers, flat)
    finally:
        storage.sync_close()


def _inflate(containers: Dict[str, dict], flat: Dict[str, Any]) -> Dict[str, Any]:
    """The nested structure from container entries and leaves (reference
    inflate, flatten.py:79-141): dicts seeded from their recorded
    ``keys`` in order (int keys stay ints), lists by integer index."""
    root: Dict[str, Any] = {}

    def dict_key(parent_path: str, comp: str) -> Any:
        decoded = unquote(comp)
        for k in (containers.get(parent_path) or {}).get("keys", ()):
            if str(k) == decoded:
                return k
        return decoded

    def new_container(entry: dict) -> Any:
        return [] if entry["type"] == "list" else dict.fromkeys(entry.get("keys", ()))

    def slot(parent: Any, parent_path: str, comp: str) -> Any:
        """The index or key of ``comp`` in ``parent``, a list grown to hold it."""
        if isinstance(parent, list):
            idx = int(comp)
            while len(parent) <= idx:
                parent.append(None)
            return idx
        return dict_key(parent_path, comp)

    def ensure(path: str) -> Any:
        if path == "":
            return root
        parent_path, _, comp = path.rpartition("/")
        parent = ensure(parent_path)
        k = slot(parent, parent_path, comp)
        if (parent[k] if isinstance(parent, list) else parent.get(k)) is None:
            parent[k] = new_container(containers.get(path, {"type": "dict"}))
        return parent[k]

    for path in sorted(containers):
        ensure(path)
    for path, value in sorted(flat.items()):
        parent_path, _, comp = path.rpartition("/")
        parent = ensure(parent_path)
        parent[slot(parent, parent_path, comp)] = value
    return root
