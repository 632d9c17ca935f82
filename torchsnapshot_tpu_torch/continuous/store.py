"""The continuous-checkpoint store: a small content-addressed,
marker-last mirror of one rank's state.

Counterpart of ``torchsnapshot_tpu/continuous/store.py``, in its format:
one store root (``<host-root>/r<rank>``) holds

- ``objects/<kk>/<crc32>-<adler32>-<size>``: the chunk pool, the chunk
  store's layout and content key (``cas/store.py``);
- ``steps/<step>.json``: the step manifest, each logical leaf with its
  dtype and shape (or serialization tag) and its ordered chunk keys,
  self-CRC'd;
- ``.snapshot_metadata``: the HEAD naming the newest complete step,
  written strictly last (chunks, manifest, HEAD), so a store whose
  writer died mid-step reads as the previous step.

Leaves are torch tensors here: ``encode_leaf`` records a tensor's (or a
numpy array's) dtype under the JAX package's string (``bfloat16``,
``float8_e4m3fn``: torch has those dtypes, so no ``ml_dtypes`` is needed
and their bytes pass through a ``uint8`` view), and ``decode_leaf``
rebuilds one on the device the caller names.  Anything else rides the
safe object codec, byte for byte the JAX package's.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import knobs, obs
from ..cas.store import chunk_key, chunk_location, key_size
from ..io_types import ReadIO, StoragePlugin, WriteIO
from ..serialization import (
    deserialize_object,
    dtype_to_string,
    serialize_object,
    string_to_dtype,
)
from ..utils.checksums import adler32_fast, crc32_fast
from ..utils.selfcrc import append_crc_trailer, strip_crc_trailer

logger = logging.getLogger(__name__)

# HEAD shares the snapshot marker's name ("marker present == complete");
# its JSON has a ``format`` no SnapshotMetadata parser accepts, so a
# continuous root is never taken for a committed snapshot
HEAD_FNAME = ".snapshot_metadata"
STEP_FORMAT = "tsnp-continuous-step"
HEAD_FORMAT = "tsnp-continuous-head"
_CRC_MARKER = "\n# tsnp-continuous-crc32: "


def step_manifest_path(step: int) -> str:
    return f"steps/{int(step):010d}.json"


def _encode_doc(doc: Dict[str, Any]) -> bytes:
    body = json.dumps(doc, sort_keys=True)
    return append_crc_trailer(body, _CRC_MARKER).encode()


def _decode_doc(data: Any, label: str, fname: str) -> Dict[str, Any]:
    text = bytes(memoryview(data).cast("B")).decode()
    body, had = strip_crc_trailer(text, _CRC_MARKER, label, fname)
    if not had:
        raise RuntimeError(
            f"{label} {fname!r} has no integrity trailer — not a continuous-store document"
        )
    return json.loads(body)


def encode_head(step: int) -> bytes:
    return _encode_doc(
        {"format": HEAD_FORMAT, "version": 1, "step": int(step), "manifest": step_manifest_path(step)}
    )


def encode_step_manifest(step: int, chunk_size: int, leaves: Dict[str, Dict[str, Any]]) -> bytes:
    return _encode_doc(
        {
            "format": STEP_FORMAT,
            "version": 1,
            "step": int(step),
            "chunk_size": int(chunk_size),
            "leaves": leaves,
        }
    )


def encode_leaf(leaf: Any) -> Tuple[Dict[str, Any], memoryview]:
    """One flattened leaf → (manifest record without its keys, byte view).
    Tensors (copied to the host when on a device) and numpy arrays keep
    dtype and shape; anything else rides the safe object codec."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        view = memoryview(t.reshape(-1).view(torch.uint8).numpy()).cast("B")
        return (
            {"kind": "array", "dtype": dtype_to_string(t.dtype), "shape": list(t.shape),
             "size": view.nbytes},
            view,
        )
    if isinstance(leaf, (np.ndarray, np.generic)):
        arr = np.ascontiguousarray(leaf)
        view = memoryview(arr.reshape(-1).view(np.uint8)).cast("B")
        return (
            {"kind": "array", "dtype": str(arr.dtype), "shape": list(arr.shape), "size": arr.nbytes},
            view,
        )
    payload, tag = serialize_object(leaf)
    view = memoryview(payload).cast("B")
    return {"kind": "object", "tag": tag, "size": view.nbytes}, view


def decode_leaf(rec: Dict[str, Any], data: bytes, device: Any = "cuda") -> Any:
    """A record and its bytes → a tensor on ``device`` (a writable copy:
    recovered state goes back into a loop that mutates it), or the
    decoded object."""
    if rec.get("kind") == "array":
        dtype = string_to_dtype(str(rec["dtype"]))
        shape = [int(s) for s in rec["shape"]]
        u8 = torch.frombuffer(bytearray(data), dtype=torch.uint8) if len(data) else torch.empty(
            0, dtype=torch.uint8
        )
        return u8.view(dtype).reshape(shape).to(device)
    return deserialize_object(bytes(data), str(rec["tag"]))


class ContinuousStore:
    """Verified I/O against one continuous store root (any storage URL);
    paths and integrity only."""

    def __init__(self, root: str, storage: Optional[StoragePlugin] = None) -> None:
        self.root = root.rstrip("/")
        self._storage = storage

    @property
    def storage(self) -> StoragePlugin:
        if self._storage is None:
            from ..storage import url_to_storage_plugin

            # a peer's mirror is a local copy already: never cached twice
            self._storage = url_to_storage_plugin(self.root, {"host_cache": False})
        return self._storage

    # ------------------------------------------------------------- read

    def read_head(self) -> Optional[Dict[str, Any]]:
        """The verified HEAD, or None without a marker; corruption
        raises (the caller tries its next source)."""
        try:
            io = ReadIO(path=HEAD_FNAME)
            self.storage.sync_read(io)
        except FileNotFoundError:
            return None
        doc = _decode_doc(io.buf, "continuous HEAD", HEAD_FNAME)
        if doc.get("format") != HEAD_FORMAT:
            raise RuntimeError(
                f"{self.root}/{HEAD_FNAME} is not a continuous-store HEAD "
                f"(format={doc.get('format')!r})"
            )
        return doc

    def read_step_manifest(self, path: str) -> Dict[str, Any]:
        io = ReadIO(path=path)
        self.storage.sync_read(io)
        doc = _decode_doc(io.buf, "continuous step manifest", path)
        if doc.get("format") != STEP_FORMAT:
            raise RuntimeError(f"{self.root}/{path} is not a continuous step manifest")
        return doc

    def read_chunks(self, keys: List[str]) -> Dict[str, bytes]:
        """Fetch the named chunks concurrently, each held against the
        crc32, adler32 and size its own key names (a torn or stale copy
        fails closed)."""
        unique = sorted(set(keys))
        out: Dict[str, bytes] = {}

        async def _one(sem: asyncio.Semaphore, key: str) -> None:
            async with sem:
                io = ReadIO(path=chunk_location(key))
                await self.storage.read(io)
            view = memoryview(io.buf).cast("B")
            if view.nbytes != key_size(key) or chunk_key(
                (crc32_fast(view), adler32_fast(view), view.nbytes)
            ) != key:
                raise IOError(
                    f"chunk {key} under {self.root!r} failed its content check "
                    f"({view.nbytes} bytes)"
                )
            out[key] = bytes(view)

        async def _all() -> None:
            sem = asyncio.Semaphore(knobs.get_max_per_rank_io_concurrency())
            # every failure is retrieved, the first one raised
            results = await asyncio.gather(*(_one(sem, k) for k in unique), return_exceptions=True)
            errs = [r for r in results if isinstance(r, BaseException)]
            if errs:
                raise errs[0]

        with obs.span("continuous/read_chunks", root=self.root, chunks=len(unique)):
            loop = asyncio.new_event_loop()
            try:
                loop.run_until_complete(_all())
            finally:
                loop.close()
        return out

    def read_leaves(
        self, manifest: Dict[str, Any], wanted: Optional[List[str]] = None, device: Any = "cuda",
    ) -> Dict[str, Any]:
        """The leaves of a step manifest (all, or those in ``wanted``),
        decoded onto ``device``."""
        recs = {
            lp: rec for lp, rec in manifest["leaves"].items() if wanted is None or lp in wanted
        }
        chunks = self.read_chunks([k for rec in recs.values() for k in rec["keys"]])
        leaves: Dict[str, Any] = {}
        for path, rec in recs.items():
            data = b"".join(chunks[k] for k in rec["keys"])
            if len(data) != int(rec["size"]):
                raise IOError(
                    f"leaf {path!r}: assembled {len(data)} bytes, manifest says {rec['size']}"
                )
            leaves[path] = decode_leaf(rec, data, device)
        return leaves

    def read_state(
        self, head: Optional[Dict[str, Any]] = None, device: Any = "cuda"
    ) -> Tuple[int, Dict[str, Any]]:
        """The HEAD step as ``(step, {logical_path: leaf})``; raises when
        the store is empty or any piece fails verification."""
        with obs.span("continuous/read_state", root=self.root):
            head = head if head is not None else self.read_head()
            if head is None:
                raise FileNotFoundError(f"continuous store {self.root!r} has no HEAD")
            manifest = self.read_step_manifest(str(head["manifest"]))
            return int(manifest["step"]), self.read_leaves(manifest, device=device)

    # ------------------------------------------------------------ write

    def write_manifest(self, step: int, payload: bytes) -> None:
        self.storage.sync_write(WriteIO(path=step_manifest_path(step), buf=payload))

    def write_head(self, payload: bytes) -> None:
        # durable: the one file whose loss drops the store a step back
        self.storage.sync_write(WriteIO(path=HEAD_FNAME, buf=payload, durable=True))

    def write_state(
        self, step: int, leaves: Dict[str, Any], chunk_size: int = 4 << 20
    ) -> None:
        """Mirror ``leaves`` (logical path → leaf) as ``step``: chunks,
        then the step manifest, then HEAD."""
        recs: Dict[str, Dict[str, Any]] = {}
        for lp, leaf in leaves.items():
            rec, view = encode_leaf(leaf)
            keys = []
            for off in range(0, max(1, view.nbytes), chunk_size):
                piece = view[off:off + chunk_size]
                key = chunk_key((crc32_fast(piece), adler32_fast(piece), piece.nbytes))
                self.storage.sync_write(WriteIO(path=chunk_location(key), buf=bytes(piece)))
                keys.append(key)
            rec["keys"] = keys
            recs[lp] = rec
        self.write_manifest(step, encode_step_manifest(step, chunk_size, recs))
        self.write_head(encode_head(step))

    def delete_quiet(self, path: str) -> bool:
        try:
            self.storage.sync_delete(path)
            return True
        except FileNotFoundError:
            return False
        except Exception as e:  # noqa: BLE001 — pruning is best-effort
            obs.swallowed_exception("continuous.store_prune", e)
            return False

    def sync_close(self) -> None:
        if self._storage is not None:
            self._storage.sync_close()
            self._storage = None
