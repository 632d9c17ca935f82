"""Raw-byte tensor (de)serialization + the safe object codec.

Counterpart of ``torchsnapshot_tpu/serialization.py``; both packages
write and read the same bytes:

- Arrays are stored as raw little-endian C-contiguous bytes; dtype and
  shape live in the manifest under the SAME dtype strings the JAX
  package records (``bfloat16``, ``float8_e4m3fn``, ``bool``,
  ``complex64``, ...).  The bytes of a tensor are
  ``t.contiguous().view(torch.uint8)`` of its host copy: torch's bool is
  one byte and its complex is interleaved (re, im), exactly the JAX
  layout.
- ``int4``/``uint4`` have no torch dtype: naming them raises.
- The object codec is the JAX package's msgpack format with its
  extension codes, produced by a pure-Python encoder
  (``utils/msgpack_codec.py``) so the port does not need the ``msgpack``
  package.  Pickle is a fallback behind the ``ALLOW_PICKLE_OBJECTS``
  knob, tagged so readers can refuse it.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Tuple

import numpy as np
import torch

from . import knobs
from .utils.msgpack_codec import ExtType, packb, unpackb

# Serializer tags recorded in the manifest.
BUFFER_PROTOCOL = "buffer_protocol"
SAFE_OBJECT = "safe_object"
PICKLE_OBJECT = "pickle"

_TORCH_DTYPES = {
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "float8_e4m3fnuz": torch.float8_e4m3fnuz,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}

# numpy's own dtypes, the ones a numpy leaf or object payload may carry
# without the ml_dtypes extension types
_NUMPY_DTYPES = (
    "float16", "float32", "float64",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "bool", "complex64", "complex128",
)

# dtypes the JAX package stores that torch cannot represent
_NO_TORCH_DTYPE = ("int4", "uint4")


def _refuse_sub_byte(name: str) -> None:
    if name in _NO_TORCH_DTYPE:
        raise ValueError(
            f"dtype {name!r} has no torch counterpart (int4/uint4 are "
            "JAX-only); this snapshot leaf cannot be read by the PyTorch port"
        )


def dtype_to_string(dtype: Any) -> str:
    """torch or numpy dtype → the manifest's dtype string."""
    if isinstance(dtype, torch.dtype):
        name = _DTYPE_NAMES.get(dtype)
        if name is None:
            raise ValueError(f"unsupported dtype for serialization: {dtype!r}")
        return name
    name = np.dtype(dtype).name
    if name not in _NUMPY_DTYPES:
        _refuse_sub_byte(name)
        raise ValueError(f"unsupported dtype for serialization: {dtype!r}")
    return name


def string_to_dtype(s: str) -> torch.dtype:
    _refuse_sub_byte(s)
    dt = _TORCH_DTYPES.get(s)
    if dt is None:
        raise ValueError(f"unknown serialized dtype: {s!r}")
    return dt


def dtype_itemsize(s: str) -> int:
    return string_to_dtype(s).itemsize


def serialized_size_bytes(shape, dtype_str: str) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype_itemsize(dtype_str)


def tensor_bytes(t: torch.Tensor) -> torch.Tensor:
    """The serialized bytes of a HOST tensor as a flat uint8 tensor (a
    view when ``t`` is contiguous)."""
    if t.device.type != "cpu":
        raise ValueError(f"tensor_bytes needs a host tensor, got {t.device}")
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def array_as_memoryview(obj: Any) -> memoryview:
    """Zero-copy byte view of a host tensor or numpy array."""
    if isinstance(obj, torch.Tensor):
        return memoryview(tensor_bytes(obj).numpy())
    arr = np.ascontiguousarray(obj)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return memoryview(arr.reshape(-1).view(np.uint8))


def tensor_from_buffer(buf: Any, dtype_str: str, shape: Tuple[int, ...]) -> torch.Tensor:
    """A host tensor of ``dtype_str``/``shape`` over the raw bytes of
    ``buf``.  It shares memory with ``buf`` when ``buf`` is writable and
    suitably aligned (a mapped read is: its private map is writable); a
    copy otherwise (torch has no read-only tensors, and slab members sit
    at unaligned offsets)."""
    dtype = string_to_dtype(dtype_str)
    shape = tuple(int(s) for s in shape)
    nbytes = serialized_size_bytes(shape, dtype_str)
    view = memoryview(buf).cast("B")
    if view.nbytes != nbytes:
        raise ValueError(
            f"buffer holds {view.nbytes} bytes, {dtype_str}{list(shape)} "
            f"needs {nbytes}"
        )
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    if view.readonly:
        view = memoryview(bytearray(view))
    u8 = torch.frombuffer(view, dtype=torch.uint8)
    if u8.data_ptr() % dtype.itemsize:
        u8 = u8.clone()
    return u8.view(dtype).reshape(shape)


# ---------------------------------------------------------------------------
# Safe object codec: msgpack with the JAX package's extension codes.
# ---------------------------------------------------------------------------

_EXT_TUPLE = 1
_EXT_SET = 2
_EXT_FROZENSET = 3
_EXT_COMPLEX = 4
_EXT_NDARRAY = 5
_EXT_NPSCALAR = 6
_EXT_BIGINT = 7
_EXT_DICT_NONSTR = 8  # dict subclass: list of [k, v] pairs


def _default(obj: Any) -> Any:
    if isinstance(obj, tuple):
        return ExtType(_EXT_TUPLE, _pack(list(obj)))
    if isinstance(obj, set):
        return ExtType(_EXT_SET, _pack(sorted(obj, key=repr)))
    if isinstance(obj, frozenset):
        return ExtType(_EXT_FROZENSET, _pack(sorted(obj, key=repr)))
    if isinstance(obj, complex):
        return ExtType(_EXT_COMPLEX, _pack([obj.real, obj.imag]))
    if isinstance(obj, np.ndarray):
        payload = _pack(
            [dtype_to_string(obj.dtype), list(obj.shape),
             array_as_memoryview(obj).tobytes()]
        )
        return ExtType(_EXT_NDARRAY, payload)
    if isinstance(obj, np.generic):
        arr = np.asarray(obj)
        return ExtType(
            _EXT_NPSCALAR, _pack([dtype_to_string(arr.dtype), arr.tobytes()])
        )
    if isinstance(obj, int):
        # ints outside msgpack's 64-bit range reach here
        return ExtType(_EXT_BIGINT, str(obj).encode())
    if isinstance(obj, dict):
        return ExtType(_EXT_DICT_NONSTR, _pack([[k, v] for k, v in obj.items()]))
    raise TypeError(f"unencodable object of type {type(obj)}")


def _decode_array(dtype_str: str, shape, raw: bytes) -> Any:
    """numpy for numpy's own dtypes; a host tensor for the extension
    dtypes numpy cannot hold without ml_dtypes (bfloat16, fp8)."""
    if dtype_str in _NUMPY_DTYPES:
        return np.frombuffer(raw, dtype=np.dtype(dtype_str)).reshape(shape).copy()
    return tensor_from_buffer(raw, dtype_str, tuple(shape))


def _ext_hook(code: int, data: bytes) -> Any:
    if code == _EXT_TUPLE:
        return tuple(_unpack(data))
    if code == _EXT_SET:
        return set(_unpack(data))
    if code == _EXT_FROZENSET:
        return frozenset(_unpack(data))
    if code == _EXT_COMPLEX:
        re, im = _unpack(data)
        return complex(re, im)
    if code == _EXT_NDARRAY:
        dtype_str, shape, raw = _unpack(data)
        return _decode_array(dtype_str, shape, raw)
    if code == _EXT_NPSCALAR:
        dtype_str, raw = _unpack(data)
        if dtype_str in _NUMPY_DTYPES:
            return np.frombuffer(raw, dtype=np.dtype(dtype_str))[0]
        return tensor_from_buffer(raw, dtype_str, ())
    if code == _EXT_BIGINT:
        return int(data.decode())
    if code == _EXT_DICT_NONSTR:
        return {k: v for k, v in _unpack(data)}
    return ExtType(code, data)


def _pack(obj: Any) -> bytes:
    return packb(obj, default=_default)


def _unpack(data: Any) -> Any:
    return unpackb(data, ext_hook=_ext_hook)


def serialize_object(obj: Any) -> Tuple[bytes, str]:
    """Serialize an arbitrary object; returns (payload, serializer_tag)."""
    try:
        return _pack(obj), SAFE_OBJECT
    except (TypeError, ValueError, OverflowError):
        pass
    if not knobs.is_pickle_allowed():
        raise TypeError(
            f"object of type {type(obj)} is not encodable by the safe codec "
            "and ALLOW_PICKLE_OBJECTS is disabled"
        )
    buf = io.BytesIO()
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue(), PICKLE_OBJECT


def deserialize_object(payload: Any, serializer: str) -> Any:
    if serializer == SAFE_OBJECT:
        return _unpack(bytes(payload))
    if serializer == PICKLE_OBJECT:
        if not knobs.is_pickle_allowed():
            raise RuntimeError(
                "snapshot contains a pickle payload but ALLOW_PICKLE_OBJECTS "
                "is disabled"
            )
        return pickle.loads(bytes(payload))
    raise ValueError(f"unknown object serializer: {serializer!r}")
