"""Write checkpoints the original torchsnapshot library can restore.

Counterpart of ``torchsnapshot_tpu/tricks/torchsnapshot_writer.py``, the
mirror of ``read_torchsnapshot``: a state of torch tensors, on the card
or the host, exports into the reference's on-disk format, byte for byte
what the JAX writer lays down for the same values.

- ``.snapshot_metadata``: JSON (the reference's YAML loader reads it,
  manifest.py:442-475), version 0.1.0, world_size 1, written last.
- One ``Tensor`` entry per tensor leaf, serializer ``buffer_protocol``
  (raw C-order bytes, serialization.py:177-265), torch dtype names.
  A dtype the JAX writer cannot export (fp8, the unsigned wider ints)
  raises its error.
- Containers (``dict``, and ``list`` for lists and tuples) and inline
  primitives with the reference's codecs (manifest.py:335-400); ``/`` in
  keys %-escaped (flatten.py:215-226).

A ``DTensor`` leaf is consolidated into one host tensor only when every
shard is addressable from this process (a mesh of one rank), as the
JAX writer refuses a partly addressable ``jax.Array``; the export is for
a single-process reference restore.
"""

from __future__ import annotations

import asyncio
import base64
import json
import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..io_types import WriteIO, run_in_fresh_loop

# the dtypes the reference format takes, as the JAX writer's table has them
_EXPORTABLE = ("float32", "float64", "float16", "bfloat16", "int8", "int16", "int32", "int64", "uint8", "bool",
               "complex64", "complex128")


def _torch_dtype_name(dtype: torch.dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    if name not in _EXPORTABLE:
        raise ValueError(f"dtype {name!r} has no reference (torch) equivalent — cast the leaf before exporting")
    return f"torch.{name}"


def _encode_key(key: str) -> str:
    # reference flatten._encode (flatten.py:215-222): an RFC-3986 subset
    return key.replace("%", "%25").replace("/", "%2F")


def _primitive_entry(obj: Any) -> Dict[str, Any]:
    if isinstance(obj, bool):  # before int: bool is an int subclass
        t, sv = "bool", str(obj)
    elif isinstance(obj, int):
        t, sv = "int", str(obj)
    elif isinstance(obj, str):
        t, sv = "str", obj
    elif isinstance(obj, bytes):
        t, sv = "bytes", base64.b64encode(obj).decode()
    else:
        t, sv = "float", base64.b64encode(struct.pack("d", obj)).decode()
    return {"type": t, "serialized_value": sv, "replicated": False, "readable": None}


def _dtensor_type():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor

    return DTensor


def _host_bytes(leaf: torch.Tensor) -> np.ndarray:
    """The leaf's C-order bytes on the host."""
    dtensor = _dtensor_type()
    if dtensor is not None and isinstance(leaf, dtensor):
        leaf = leaf.full_tensor()  # one rank: no peer takes part
    return leaf.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy()


def write_torchsnapshot(path: str, app_state: Dict[str, Any]) -> None:
    """Export ``{key: state or Stateful}`` as a reference-format snapshot
    that ``torchsnapshot.Snapshot(path).restore(...)`` (or
    ``read_object``) consumes directly.

    Tensor leaves (and numpy arrays) become ``Tensor`` entries; int, str,
    bool, float and bytes are inline; dicts, lists and tuples become
    containers.  A value with ``state_dict()`` is exported through it.
    Any other leaf (``None``, an object) raises, naming its path."""
    from ..storage import url_to_storage_plugin

    manifest: Dict[str, Any] = {}
    # (location, leaf): each leaf reaches the host inside a bounded write
    # task, so at most 16 leaves are on the host at once
    writes: List[Tuple[str, torch.Tensor]] = []
    dtensor = _dtensor_type()

    def visit(logical: str, obj: Any) -> None:
        if hasattr(obj, "state_dict") and not isinstance(obj, (dict, list, tuple, torch.Tensor, np.ndarray)):
            obj = obj.state_dict()
        if isinstance(obj, dict):
            str_keys = [str(k) for k in obj.keys()]
            if len(set(str_keys)) < len(str_keys):
                # the reference raises on this too (flatten.py:144-162)
                raise ValueError(
                    f"dict at {logical!r} has keys that collide under str(): {sorted(obj.keys(), key=str)!r}"
                )
            # int keys stay ints (DictEntry.keys, reference manifest.py:320)
            manifest[logical] = {"type": "dict", "keys": [k if isinstance(k, int) else str(k) for k in obj.keys()]}
            for k, v in obj.items():
                visit(f"{logical}/{_encode_key(str(k))}", v)
            return
        if isinstance(obj, (list, tuple)):
            manifest[logical] = {"type": "list"}
            for i, v in enumerate(obj):
                visit(f"{logical}/{i}", v)
            return
        if isinstance(obj, (bool, int, str, bytes, float)):
            manifest[logical] = _primitive_entry(obj)
            return
        if isinstance(obj, (np.ndarray, np.generic)) and obj.dtype != np.dtype(object):
            obj = torch.from_numpy(np.array(obj))  # a C-order copy; 0-d stays 0-d
        if not isinstance(obj, torch.Tensor):
            # the reference stores such leaves as pickled objects; this
            # export is pickle-free
            raise ValueError(
                f"leaf {logical!r} is not exportable: {type(obj).__name__} value {obj!r:.80} has no "
                f"torchsnapshot Tensor/primitive equivalent (the reference stores such leaves as pickled "
                f"objects). Drop it or convert it to an array/primitive before exporting."
            )
        if dtensor is not None and isinstance(obj, dtensor) and obj.device_mesh.size() > 1:
            # checked while planning: failing in a write task would leave
            # the leaves written before it in the destination
            raise ValueError(
                f"{logical!r} is a DTensor with shards on other ranks; gather it (DTensor.full_tensor() "
                f"on every rank) before exporting"
            )
        manifest[logical] = {
            "type": "Tensor",
            "location": logical,  # one object per leaf: no byte_range
            "serializer": "buffer_protocol",
            "dtype": _torch_dtype_name(obj.dtype),
            "shape": [int(s) for s in obj.shape],
            "replicated": False,
        }
        writes.append((logical, obj))

    for key in sorted(app_state):
        visit(f"0/{key}", app_state[key])

    metadata = {"version": "0.1.0", "world_size": 1, "manifest": manifest}
    storage = url_to_storage_plugin(path)
    try:

        async def flush() -> None:
            sem = asyncio.Semaphore(16)

            async def one(loc: str, leaf: torch.Tensor) -> None:
                async with sem:
                    await storage.write(WriteIO(path=loc, buf=_host_bytes(leaf)))

            await asyncio.gather(*(one(loc, leaf) for loc, leaf in writes))
            # the metadata last: its presence is the reference's commit
            # marker (snapshot.py:202-209)
            await storage.write(
                WriteIO(path=".snapshot_metadata", buf=json.dumps(metadata, indent=2).encode(), durable=True)
            )

        run_in_fresh_loop(flush())
    finally:
        storage.sync_close()
