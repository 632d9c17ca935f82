"""Per-part compression for the stripe engine: frames, codecs, tables.

Counterpart of ``torchsnapshot_tpu/codec.py``, in the same on-disk
format (the JAX package reads what this writes, and the other way
round; the same part, codec and level give the same frame bytes for the
deterministic codecs, zlib and huff):

- **Digests stay raw.**  Entry crc32s, the dedup objects table and deep
  verify are computed over the raw bytes before encoding; the digest of
  the stored frames goes into the object's codec table separately.
- **Every part is a frame** that decodes alone: a 24-byte header (magic
  ``TSCF``, version 1, codec id, filter id, raw and encoded lengths) and
  the payload.  A raw byte range maps through the manifest's codec table
  to the frames that cover it, so ranged and parallel reads survive.
- **Store-raw** is the per-part fallback whenever the frame is not
  smaller than the raw part by ``CODEC_MIN_RATIO``: such a part pays one
  header and no decode dependency.
- **Optional codecs**: ``zlib`` is always there, ``zstd`` and ``lz4``
  import lazily; a missing write-side codec writes raw with one warning,
  a missing read-side one raises ``CodecUnavailableError``.  ``huff`` is
  the native block-Huffman coder of ``_csrc/fastio.cpp``.
- **Byte-shuffle** groups byte plane ``i`` of every element (the filter
  id is the element's stride), which makes float payloads compressible;
  ``filter_for_dtype`` picks it.

Frames carry lengths, not checksums: corruption inside a payload
surfaces as a decode failure or as a raw-digest mismatch where raw
payloads' corruption surfaces.
"""

from __future__ import annotations

import asyncio
import logging
import os
import struct
import threading
import time
import weakref
import zlib
from concurrent.futures import Executor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import _csrc, knobs, obs
from .io_types import ReadIO, StoragePlugin, resolve_read_destination, run_on
from .resilience import classify_generic, retry_call
from .resilience.failpoints import failpoint
from .resilience.retry import SharedProgress
from .storage.stripe import Slot, part_concurrency

logger = logging.getLogger(__name__)

# ----------------------------------------------------------------- frame

FRAME_MAGIC = b"TSCF"
FRAME_VERSION = 1
# magic(4) version(1) codec_id(1) filter_id(1) reserved(1) raw_len(u64le)
# enc_len(u64le)
FRAME_HEADER_BYTES = 24
_HEADER = struct.Struct("<4sBBBBQQ")

CODEC_IDS: Dict[str, int] = {"raw": 0, "zlib": 1, "zstd": 2, "lz4": 3, "huff": 4}
_ID_TO_NAME = {v: k for k, v in CODEC_IDS.items()}


class CodecError(IOError):
    """Base of the codec layer's failures."""


class CodecFrameError(CodecError):
    """A frame failed validation: a bad magic or version, a truncated
    payload, an unknown codec id, or a decode of the wrong length."""


class CodecUnavailableError(CodecError):
    """The frame names a codec this host cannot decode."""

    def __init__(self, codec: str, detail: str = "") -> None:
        self.codec = codec
        super().__init__(
            f"codec {codec!r} is not available on this host{detail} — install "
            "it to restore this snapshot (raw-fallback parts decode regardless)"
        )


# -------------------------------------------------------------- registry


def _zlib_compress(view: memoryview, level: int) -> bytes:
    return zlib.compress(view, level if 1 <= level <= 9 else 1)


def _zlib_decompress(view: memoryview, raw_len: int) -> bytes:
    return zlib.decompress(view)


def _zstd_mod():
    try:
        import zstandard

        return zstandard
    except ImportError:
        return None


def _zstd_compress(view: memoryview, level: int) -> bytes:
    return _zstd_mod().ZstdCompressor(level=level if level else 3).compress(view)


def _zstd_decompress(view: memoryview, raw_len: int) -> bytes:
    return _zstd_mod().ZstdDecompressor().decompress(view, max_output_size=raw_len)


def _lz4_mod():
    try:
        import lz4.frame

        return lz4.frame
    except ImportError:
        return None


def _lz4_compress(view: memoryview, level: int) -> bytes:
    return _lz4_mod().compress(view, compression_level=level)


def _lz4_decompress(view: memoryview, raw_len: int) -> bytes:
    return _lz4_mod().decompress(view)


def _huff_lib():
    return _csrc.enabled_lib()


def _huff_compress(view: memoryview, level: int):
    # encode_frame builds huff frames in place; this entry keeps the
    # registry uniform (the bare stream)
    lib = _huff_lib()
    if lib is None:
        raise CodecUnavailableError("huff", " (native library off)")
    return _csrc.huff_compress(lib, view)


def _huff_decompress(view: memoryview, raw_len: int):
    lib = _huff_lib()
    if lib is None:
        raise CodecUnavailableError("huff", " (native library off)")
    try:
        return _csrc.huff_decompress(lib, view, raw_len)
    except ValueError as e:
        raise CodecFrameError(f"corrupt huff frame payload: {e}") from e


class _Codec:
    __slots__ = ("name", "codec_id", "compress", "decompress", "_avail")

    def __init__(self, name, compress, decompress, avail) -> None:
        self.name = name
        self.codec_id = CODEC_IDS[name]
        self.compress = compress
        self.decompress = decompress
        self._avail = avail

    def available(self) -> bool:
        return self._avail()


_REGISTRY: Dict[str, _Codec] = {
    "zlib": _Codec("zlib", _zlib_compress, _zlib_decompress, lambda: True),
    "zstd": _Codec("zstd", _zstd_compress, _zstd_decompress, lambda: _zstd_mod() is not None),
    "lz4": _Codec("lz4", _lz4_compress, _lz4_decompress, lambda: _lz4_mod() is not None),
    "huff": _Codec("huff", _huff_compress, _huff_decompress, lambda: _huff_lib() is not None),
}


def available_codecs() -> List[str]:
    """The codecs usable on this host, ``raw`` first."""
    return ["raw"] + [n for n, c in _REGISTRY.items() if c.available()]


_warned_unavailable: set = set()
_warned_lock = threading.Lock()


def resolve_codec(name: Optional[str] = None) -> str:
    """The write-side codec: ``name``, else the CODEC knob.  An unknown or
    unavailable codec writes raw, with one warning per name."""
    name = (name or knobs.get_codec()).lower()
    if name == "raw":
        return "raw"
    codec = _REGISTRY.get(name)
    if codec is None or not codec.available():
        with _warned_lock:
            first = name not in _warned_unavailable
            _warned_unavailable.add(name)
        if first:
            why = "unknown codec" if codec is None else "not installed"
            logger.warning(
                "TORCHSNAPSHOT_TPU_TORCH_CODEC=%r %s (available: %s); writing raw",
                name, why, ",".join(available_codecs()),
            )
        return "raw"
    return name


# --------------------------------------------------------------- filters

_FLOAT_ITEMSIZE = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}


def filter_for_dtype(dtype_str: Optional[str]) -> int:
    """Byte-shuffle stride for a manifest dtype string (0: no filter)."""
    if not dtype_str:
        return 0
    return _FLOAT_ITEMSIZE.get(dtype_str.lower(), 0)


def _numpy_shuffle(view: memoryview, stride: int, inverse: bool):
    n = view.nbytes
    body = n - (n % stride)
    arr = np.frombuffer(view, dtype=np.uint8, count=body)
    shape = (stride, -1) if inverse else (-1, stride)
    res = np.ascontiguousarray(arr.reshape(shape).T).tobytes()
    if body != n:
        res += bytes(view[body:])
    return res


def shuffle(view: memoryview, stride: int):
    """Byte-shuffle: byte plane ``i`` of every ``stride``-byte element
    together, a tail shorter than one element appended as it is.  Native
    (one GIL-free pass) unless ``ENABLE_NATIVE_EXT=0``; both give the
    same bytes."""
    view = memoryview(view).cast("B")
    lib = _csrc.enabled_lib()
    if lib is not None:
        return _csrc.byte_shuffle(lib, view, stride)
    return _numpy_shuffle(view, stride, inverse=False)


def unshuffle(view: memoryview, stride: int):
    """The inverse of ``shuffle``."""
    view = memoryview(view).cast("B")
    lib = _csrc.enabled_lib()
    if lib is not None:
        return _csrc.byte_shuffle(lib, view, stride, inverse=True)
    return _numpy_shuffle(view, stride, inverse=True)


# ------------------------------------------------------------- metrics


def _enc_hist(name: str):
    return obs.histogram(f"storage.codec.encode_latency_s.{name}")


def _dec_hist(name: str):
    return obs.histogram(f"storage.codec.decode_latency_s.{name}")


# --------------------------------------------------------- write spec


class WriteSpec:
    """The write-side codec parameters, resolved once per pipeline run."""

    __slots__ = ("codec", "level", "min_ratio")

    def __init__(self, codec: str, level: int, min_ratio: float) -> None:
        self.codec = codec
        self.level = level
        self.min_ratio = min_ratio


def resolve_write_spec() -> Optional[WriteSpec]:
    """The active spec, or None when the codec resolves to raw (then the
    layer costs nothing per part)."""
    name = resolve_codec()
    if name == "raw":
        return None
    return WriteSpec(name, knobs.get_codec_level(), knobs.get_codec_min_ratio())


# ------------------------------------------------------ frame encode


def _count_encode(codec_name: str, raw_len: int, frame_len: int, fallback: bool, dt: float) -> None:
    """One part's metrics, counted once on success (a retried attempt
    must not count the part twice)."""
    _enc_hist(codec_name).observe(dt)
    obs.counter(obs.CODEC_BYTES_IN).inc(raw_len)
    obs.counter(obs.CODEC_BYTES_OUT).inc(frame_len)
    obs.counter(obs.CODEC_PARTS_RAW_FALLBACK if fallback else obs.CODEC_PARTS_ENCODED).inc()


def encode_frame(view: memoryview, spec: WriteSpec, filter_stride: int = 0, min_frame_bytes: int = 0):
    """One part as a frame (a uint8 array).  The raw frame (codec 0,
    filter 0) is stored whenever the encoded one is not smaller than the
    part by ``spec.min_ratio``, or lands under the backend's non-final
    part floor ``min_frame_bytes`` while the raw frame clears it."""
    frame, raw_len, fallback, dt = _encode_frame_uncounted(view, spec, filter_stride, min_frame_bytes)
    _count_encode(spec.codec, raw_len, memoryview(frame).nbytes, fallback, dt)
    return frame


def _encode_frame_uncounted(
    view: memoryview, spec: WriteSpec, filter_stride: int = 0, min_frame_bytes: int = 0
) -> tuple:
    """``(frame, raw_len, fell_back_to_raw, encode_seconds)``."""
    view = memoryview(view).cast("B")
    raw_len = view.nbytes
    codec = _REGISTRY[spec.codec]
    t0 = time.perf_counter()
    filtered = shuffle(view, filter_stride) if filter_stride > 1 else view
    if spec.codec == "huff":
        lib = _huff_lib()
        if lib is None:
            raise CodecUnavailableError("huff", " (native library off)")
        out = _csrc.huff_compress(lib, memoryview(filtered), headroom=FRAME_HEADER_BYTES)
        enc_len = len(out) - FRAME_HEADER_BYTES
    else:
        enc = codec.compress(memoryview(filtered), spec.level)
        enc_len = len(enc)
        out = None
    dt = time.perf_counter() - t0
    frame_len = FRAME_HEADER_BYTES + enc_len
    if raw_len < spec.min_ratio * frame_len or (
        0 < frame_len < min_frame_bytes <= FRAME_HEADER_BYTES + raw_len
    ):
        raw_out = np.empty(FRAME_HEADER_BYTES + raw_len, dtype=np.uint8)
        _HEADER.pack_into(raw_out, 0, FRAME_MAGIC, FRAME_VERSION, 0, 0, 0, raw_len, raw_len)
        raw_out[FRAME_HEADER_BYTES:] = np.frombuffer(view, dtype=np.uint8)
        return raw_out, raw_len, True, dt
    header = (
        FRAME_MAGIC, FRAME_VERSION, codec.codec_id,
        filter_stride if filter_stride > 1 else 0, 0, raw_len, enc_len,
    )
    if out is None:
        out = np.empty(frame_len, dtype=np.uint8)
        out[FRAME_HEADER_BYTES:] = np.frombuffer(memoryview(enc), dtype=np.uint8)
    _HEADER.pack_into(out, 0, *header)
    return out, raw_len, False, dt


_ENCODE_SLOTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _encode_slots(loop: asyncio.AbstractEventLoop) -> asyncio.Semaphore:
    """Per loop, at most one encode per core: contended encodes each take
    longer and deliver their frames late."""
    sem = _ENCODE_SLOTS.get(loop)
    if sem is None:
        sem = _ENCODE_SLOTS[loop] = asyncio.Semaphore(max(1, os.cpu_count() or 1))
    return sem


_ENCODE_PROGRESS: Optional[SharedProgress] = None


def _encode_progress() -> SharedProgress:
    global _ENCODE_PROGRESS
    if _ENCODE_PROGRESS is None:
        _ENCODE_PROGRESS = SharedProgress(label="codec.encode")
    return _ENCODE_PROGRESS


async def encode_frame_async(
    view: memoryview,
    spec: WriteSpec,
    filter_stride: int,
    executor: Optional[Executor],
    *,
    path: str = "",
    part: int = 0,
    min_frame_bytes: int = 0,
):
    """``encode_frame`` on ``executor`` under the shared retry policy,
    with the ``scheduler.codec.encode`` failpoint inside the attempt."""

    def attempt() -> tuple:
        failpoint("scheduler.codec.encode", path=path, part=part)
        return _encode_frame_uncounted(view, spec, filter_stride, min_frame_bytes)

    with obs.span(
        "codec/encode_part", path=path, part=part, bytes=memoryview(view).nbytes,
        codec=spec.codec,
    ):
        async with Slot(_encode_slots(asyncio.get_running_loop()), f"an encode slot for {path!r}"):
            frame, raw_len, fallback, dt = await retry_call(
                attempt, op_name=f"encode {path} [part {part}]", backend="codec",
                classify=classify_generic, progress=_encode_progress(), executor=executor,
            )
    _count_encode(spec.codec, raw_len, memoryview(frame).nbytes, fallback, dt)
    return frame


# ------------------------------------------------------ frame decode


def parse_frame_header(view: memoryview, offset: int = 0) -> Tuple[int, int, int, int]:
    """``(codec_id, filter_id, raw_len, enc_len)`` of the frame at
    ``offset``; ``CodecFrameError`` when it is malformed."""
    view = memoryview(view).cast("B")
    if offset + FRAME_HEADER_BYTES > view.nbytes:
        raise CodecFrameError(
            f"truncated frame header at offset {offset}: "
            f"{view.nbytes - offset} of {FRAME_HEADER_BYTES} bytes"
        )
    magic, version, codec_id, filter_id, _r, raw_len, enc_len = _HEADER.unpack_from(view, offset)
    if magic != FRAME_MAGIC:
        raise CodecFrameError(f"bad frame magic at offset {offset}: {bytes(magic)!r}")
    if version != FRAME_VERSION:
        raise CodecFrameError(f"unsupported frame version {version}")
    if codec_id not in _ID_TO_NAME:
        raise CodecFrameError(f"unknown codec id {codec_id} in frame")
    return codec_id, filter_id, raw_len, enc_len


def decode_frame(view: memoryview, offset: int = 0) -> Tuple[Any, int]:
    """Decode the frame at ``offset``: ``(raw bytes-like, frame length)``.
    A raw frame's bytes are a view into ``view``."""
    view = memoryview(view).cast("B")
    codec_id, filter_id, raw_len, enc_len = parse_frame_header(view, offset)
    start = offset + FRAME_HEADER_BYTES
    if start + enc_len > view.nbytes:
        raise CodecFrameError(
            f"truncated frame payload at offset {offset}: "
            f"{view.nbytes - start} of {enc_len} bytes"
        )
    payload = view[start : start + enc_len]
    if codec_id == 0:
        if enc_len != raw_len:
            raise CodecFrameError(
                f"raw frame length mismatch: header says raw={raw_len} enc={enc_len}"
            )
        return payload, FRAME_HEADER_BYTES + enc_len
    name = _ID_TO_NAME[codec_id]
    codec = _REGISTRY[name]
    if not codec.available():
        raise CodecUnavailableError(name)
    t0 = time.perf_counter()
    try:
        raw = codec.decompress(payload, raw_len)
    except CodecError:
        raise
    except Exception as e:  # noqa: BLE001 — the decoders' own errors
        raise CodecFrameError(f"corrupt {name} frame payload at offset {offset}: {e!r}") from e
    if len(raw) != raw_len:
        raise CodecFrameError(f"{name} frame decoded to {len(raw)} bytes, header says {raw_len}")
    if filter_id > 1:
        raw = unshuffle(memoryview(raw), filter_id)
    _dec_hist(name).observe(time.perf_counter() - t0)
    obs.counter(obs.CODEC_PARTS_DECODED).inc()
    return raw, FRAME_HEADER_BYTES + enc_len


# ----------------------------------------------------------- codec table
#
# The metadata's ``codecs[location]`` of each encoded object:
#   {"codec": <name>, "part_size": <raw bytes a frame>, "raw_size": <raw
#    bytes>, "parts": [<stored frame lengths>], "digest": [crc32,
#    adler32, stored size]}   (digest of the STORED bytes; optional)
# Raw frame offsets are i * part_size; stored offsets are prefix sums of
# "parts".  An object without a table is stored raw.


def make_table(
    codec_name: str,
    part_size: int,
    raw_size: int,
    frame_lens: List[int],
    stored_digest: Optional[List[int]] = None,
) -> Dict[str, Any]:
    tbl: Dict[str, Any] = {
        "codec": codec_name,
        "part_size": int(part_size),
        "raw_size": int(raw_size),
        "parts": [int(x) for x in frame_lens],
    }
    if stored_digest is not None:
        tbl["digest"] = [int(x) for x in stored_digest]
    return tbl


def table_stored_size(table: Dict[str, Any]) -> int:
    return sum(table["parts"])


def validate_table(table: Dict[str, Any]) -> bool:
    """Structural sanity of a codec table (the metadata is
    self-checksummed; this guards against version skew)."""
    try:
        return (
            isinstance(table.get("codec"), str)
            and int(table["part_size"]) > 0
            and int(table["raw_size"]) >= 0
            and all(int(x) > 0 for x in table["parts"])
        )
    except (KeyError, TypeError, ValueError, AttributeError):
        return False


def _frame_spans(table: Dict[str, Any]) -> List[Tuple[int, int, int, int]]:
    """``(raw_lo, raw_hi, enc_lo, enc_hi)`` of each frame."""
    part_size = int(table["part_size"])
    raw_size = int(table["raw_size"])
    spans = []
    enc_lo = raw_lo = 0
    for frame_len in table["parts"]:
        raw_hi = min(raw_lo + part_size, raw_size)
        spans.append((raw_lo, raw_hi, enc_lo, enc_lo + int(frame_len)))
        raw_lo = raw_hi
        enc_lo += int(frame_len)
    return spans


async def framed_read(
    storage: StoragePlugin,
    path: str,
    table: Dict[str, Any],
    *,
    byte_range: Optional[List[int]] = None,
    into: Any = None,
    executor: Optional[Executor] = None,
) -> Any:
    """The raw bytes ``[byte_range)`` of an encoded object: ranged reads
    of the frames that cover it, concurrently, each decoded on
    ``executor`` while later frames are in flight, assembled into one
    buffer (``into`` when it fits, as the plugins' reads honour it).  A
    range that cuts a frame decodes the whole frame and slices it."""
    raw_size = int(table["raw_size"])
    lo, hi = (0, raw_size) if byte_range is None else (int(byte_range[0]), int(byte_range[1]))
    if not 0 <= lo <= hi <= raw_size:
        raise CodecFrameError(
            f"raw range [{lo}, {hi}) outside encoded object {path!r} of raw size {raw_size}"
        )
    length = hi - lo
    out = resolve_read_destination(into, length)
    if length == 0:
        return out
    out_view = memoryview(out).cast("B")
    frames = [s for s in _frame_spans(table) if s[0] < hi and s[1] > lo]
    # frames of one object in flight: the stripe engine's part concurrency
    sem = asyncio.Semaphore(part_concurrency())

    with obs.span(
        "codec/framed_read", path=path, bytes=length, frames=len(frames), codec=table.get("codec")
    ):

        async def one(raw_lo: int, raw_hi: int, enc_lo: int, enc_hi: int) -> None:
            async with Slot(sem, f"a frame read of {path!r}"):
                rio = ReadIO(path=path, byte_range=[enc_lo, enc_hi])
                await storage.read(rio)
                frame = memoryview(rio.buf).cast("B")
                if frame.nbytes != enc_hi - enc_lo:
                    raise CodecFrameError(
                        f"frame read of {path!r} [{enc_lo}:{enc_hi}] returned "
                        f"{frame.nbytes} bytes"
                    )

                def decode_and_place() -> None:
                    raw, _ = decode_frame(frame)
                    if len(raw) != raw_hi - raw_lo:
                        raise CodecFrameError(
                            f"frame of {path!r} decoded to {len(raw)} bytes, table says "
                            f"{raw_hi - raw_lo}"
                        )
                    s, e = max(raw_lo, lo), min(raw_hi, hi)
                    out_view[s - lo : e - lo] = memoryview(raw).cast("B")[s - raw_lo : e - raw_lo]

                await run_on(executor, decode_and_place)

        await asyncio.gather(*(one(*f) for f in frames))
    return out
