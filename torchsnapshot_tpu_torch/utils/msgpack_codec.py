"""A small pure-Python msgpack encoder/decoder.

The safe object codec (``serialization.py``) must write the same bytes
the JAX package writes with ``msgpack.packb(obj, default=...,
strict_types=True, use_bin_type=True)`` and read them back as
``msgpack.unpackb(data, ext_hook=..., raw=False, strict_map_key=False)``
does, without the ``msgpack`` package.  This module covers exactly that
configuration:

- exact types only (``strict_types``): ``None``, ``bool``, ``int``,
  ``float``, ``str``, ``bytes``/``bytearray``, ``list``, ``dict`` and
  ``ExtType`` are native; every other object — tuples, ``dict``
  subclasses, ints outside [-2**63, 2**64), numpy scalars — goes through
  ``default`` once, which must return a native value or an ``ExtType``;
- str8 and the bin family are used (``use_bin_type``);
- floats are always float64 (msgpack's ``use_single_float=False``);
- each integer takes its smallest encoding, as msgpack-c's packer does.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional


class ExtType(NamedTuple):
    code: int
    data: bytes


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    out = bytearray()
    _pack_into(out, obj, default)
    return bytes(out)


def _pack_int(out: bytearray, v: int) -> bool:
    """Append ``v`` in its smallest encoding; False when out of range."""
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 0x100:
            out += b"\xcc" + struct.pack(">B", v)
        elif v < 0x10000:
            out += b"\xcd" + struct.pack(">H", v)
        elif v < 0x100000000:
            out += b"\xce" + struct.pack(">I", v)
        elif v < 0x10000000000000000:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            return False
        return True
    if v >= -32:
        out += struct.pack(">b", v)
    elif v >= -0x80:
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -0x8000:
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        return False
    return True


def _pack_header(out: bytearray, n: int, fix: Optional[int], fix_max: int,
                 codes: tuple) -> None:
    """Length header: a fix form (``fix | n`` below ``fix_max``) when the
    family has one, else the 8/16/32-bit form from ``codes`` (None where
    the family lacks that width)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 0x100:
        out += bytes((codes[0], n))
    elif n < 0x10000:
        out += bytes((codes[1],)) + struct.pack(">H", n)
    elif n < 0x100000000:
        out += bytes((codes[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object too large: {n}")


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_into(out: bytearray, obj: Any, default) -> None:
    default_used = False
    while True:
        t = type(obj)
        if obj is None:
            out.append(0xC0)
        elif obj is True:
            out.append(0xC3)
        elif obj is False:
            out.append(0xC2)
        elif t is int:
            if not _pack_int(out, obj):
                if default is None or default_used:
                    raise OverflowError("Integer value out of range")
                obj, default_used = default(obj), True
                continue
        elif t is float:
            out += b"\xcb" + struct.pack(">d", obj)
        elif t is str:
            data = obj.encode("utf-8")
            _pack_header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
            out += data
        elif t is bytes or t is bytearray:
            _pack_header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
            out += obj
        elif t is list:
            _pack_header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
            for item in obj:
                _pack_into(out, item, default)
        elif t is dict:
            _pack_header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
            for k, v in obj.items():
                _pack_into(out, k, default)
                _pack_into(out, v, default)
        elif t is ExtType:
            code, data = obj
            n = len(data)
            if n in _FIXEXT:
                out.append(_FIXEXT[n])
            else:
                _pack_header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
            out += struct.pack(">b", code)
            out += data
        elif default is not None and not default_used:
            obj, default_used = default(obj), True
            continue
        else:
            raise TypeError(f"can not serialize {t.__name__!r} object")
        return


class _Reader:
    __slots__ = ("data", "pos", "ext_hook")

    def __init__(self, data: bytes, ext_hook) -> None:
        self.data = data
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data truncated")
        b = self.data[self.pos:end]
        self.pos = end
        return b

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def ext(self, n: int) -> Any:
        code = self.unpack(">b", 1)
        return self.ext_hook(code, self.take(n))

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack((">B", ">H", ">I")[b - 0xC4], 1 << (b - 0xC4))
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7], 1 << (b - 0xC7))
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f", 4)
        if b == 0xCB:
            return self.unpack(">d", 8)
        if 0xCC <= b <= 0xCF:
            i = b - 0xCC
            return self.unpack((">B", ">H", ">I", ">Q")[i], 1 << i)
        if 0xD0 <= b <= 0xD3:
            i = b - 0xD0
            return self.unpack((">b", ">h", ">i", ">q")[i], 1 << i)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack((">B", ">H", ">I")[b - 0xD9], 1 << (b - 0xD9))
            return self.take(n).decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I", 2 if b == 0xDC else 4)
            return self.array(n)
        if b in (0xDE, 0xDF):
            n = self.unpack(">H" if b == 0xDE else ">I", 2 if b == 0xDE else 4)
            return self.map(n)
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def unpackb(data: bytes, ext_hook: Callable[[int, bytes], Any]) -> Any:
    r = _Reader(bytes(data), ext_hook)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(
            f"msgpack data has {len(r.data) - r.pos} trailing byte(s)"
        )
    return obj
