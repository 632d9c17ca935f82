"""Build and load the native fast-I/O library (``fastio.cpp``).

Counterpart of ``torchsnapshot_tpu/_csrc/__init__.py``.  The source is
compiled by ``g++`` on first use into ``build/torch_kernels/`` beside the
package (never into the package directory) and bound with ``ctypes``.
``ctypes.CDLL`` releases the GIL for the length of every call, so the
scheduler's threads overlap their digests and syscalls.

Variants are tried in order: ``-march=native`` with zlib, portable with
zlib, ``-march=native`` without zlib, portable without (zlib's SIMD crc32
beats the source's own; hosts without ``zlib.h`` take the others).  The
native variants need a CPU fingerprint (a hash of ``/proc/cpuinfo``'s
flags).  Each library's file name carries the hash of the source and its
flags and the fingerprint, so an edited source is rebuilt, and a library
built for one CPU is never loaded on another; the first variant found
built is loaded.  A build writes a process-unique temporary name and
``os.replace``s it onto the final one, under an advisory file lock taken
with a deadline, so processes starting together build once.

There is no quiet fallback: when no variant compiles, :func:`load`
raises with the compiler's output.  The pure-Python legs are taken only
when a caller was told to by the knobs (``ENABLE_NATIVE_EXT=0``, which
:func:`enabled_lib` reads, or ``FASTIO=0`` for the fs plugin's legs).
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from typing import List, Optional, Tuple

from .. import knobs
from ..ops.kernels import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastio.cpp")

COMPILER = "g++"
# each g++ run is cut at this many seconds
GXX_TIMEOUT_S = 120
# how long a process waits for another one's build before building itself
BUILD_LOCK_TIMEOUT_S = 300.0
# how long a thread waits for another thread's load (at most every
# variant's build and the file lock)
LOAD_LOCK_TIMEOUT_S = 4 * GXX_TIMEOUT_S + BUILD_LOCK_TIMEOUT_S + 60

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# (library path, g++ flags) of the loaded library
LOADED: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_U32P = ctypes.POINTER(ctypes.c_uint32)

# C signatures: symbol → (restype, argtypes).  The byte-shuffle and
# Huffman entry points serve the codec (codec.py).
_SIGNATURES = {
    "tsnp_write_file": (_I, [ctypes.c_char_p, _P, _I64, _I]),
    "tsnp_write_file_digest": (_I, [ctypes.c_char_p, _P, _I64, _I, _U32P]),
    "tsnp_read_file": (_I64, [ctypes.c_char_p, _P, _I64, _I64]),
    "tsnp_file_size": (_I64, [ctypes.c_char_p]),
    "tsnp_crc32c": (_U32, [_P, _I64, _U32]),
    "tsnp_crc32z": (_U32, [_P, _I64, _U32]),
    "tsnp_adler32": (_U32, [_P, _I64, _U32]),
    "tsnp_digest": (None, [_P, _I64, _U32P]),
    "tsnp_copy_digest": (None, [_P, _P, _I64, _U32P]),
    # fd, fd_direct, src, size, offset, align, bounce, bounce_cap,
    # want_digest, out
    "tsnp_part_pwrite": (_I, [_I, _I, _P, _I64, _I64, _I64, _P, _I64, _I, _U32P]),
    # fd, fd_direct, dst, size, offset, align, bounce, bounce_cap
    "tsnp_part_pread": (_I64, [_I, _I, _P, _I64, _I64, _I64, _P, _I64]),
    # src, n, stride, dst
    "tsnp_byte_shuffle": (None, [_P, _I64, _I64, _P]),
    "tsnp_byte_unshuffle": (None, [_P, _I64, _I64, _P]),
    # src, n, dst, capacity → compressed (raw) size, or -1
    "tsnp_huff_compress": (_I64, [_P, _I64, _P, _I64]),
    "tsnp_huff_decompress": (_I64, [_P, _I64, _P, _I64]),
}


def cpu_fingerprint() -> str:
    """Hash of this host's CPU feature flags; '' when unreadable (then
    only the portable variants are built)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha256(flags.encode()).hexdigest()[:16]
    except OSError:
        pass
    return ""


def variants() -> List[Tuple[str, List[str], List[str]]]:
    """(tag, compile flags, link flags), most preferred first."""
    zlib = (["-DTSNP_USE_ZLIB"], ["-lz"])
    order = [
        ("native-zlib", ["-march=native", *zlib[0]], zlib[1]),
        ("portable-zlib", list(zlib[0]), zlib[1]),
        ("native", ["-march=native"], []),
        ("portable", [], []),
    ]
    if not cpu_fingerprint():
        order = [v for v in order if not v[0].startswith("native")]
    return order


def lib_path(tag: str, cflags: List[str], libs: List[str]) -> str:
    h = hashlib.sha256(" ".join(["g++", "-O3", *cflags, *libs]).encode() + b"\0")
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    fp = cpu_fingerprint() or "nofp"
    return os.path.join(BUILD_DIR, f"fastio.{h.hexdigest()[:16]}.{fp}.{tag}.so")


def _build(path: str, cflags: List[str], libs: List[str]) -> Optional[str]:
    """Compile one variant to ``path``; returns None on success, else the
    compiler's message."""
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [COMPILER, "-O3", *cflags, "-shared", "-fPIC", "-o", tmp, SOURCE, *libs]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=GXX_TIMEOUT_S
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e!r}"
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return f"{' '.join(cmd)} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
    os.replace(tmp, path)
    return None


def _flock_with_deadline(fd: int, timeout_s: float) -> bool:
    """Take an exclusive advisory lock on ``fd`` within ``timeout_s``;
    False when the deadline passed (the lock dies with its process, so a
    killed build leaves nothing to wait on)."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return True
        except BlockingIOError:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)


def _find_or_build() -> Tuple[str, List[str]]:
    vs = variants()
    paths = [lib_path(*v) for v in vs]
    for path, (_, cflags, libs) in zip(paths, vs):
        if os.path.exists(path):
            return path, cflags + libs
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd = os.open(os.path.join(BUILD_DIR, "fastio.lock"), os.O_RDWR | os.O_CREAT, 0o644)
    try:
        # past the deadline build anyway: the temp name is this process's own
        _flock_with_deadline(fd, BUILD_LOCK_TIMEOUT_S)
        errors = []
        for path, (_, cflags, libs) in zip(paths, vs):
            if os.path.exists(path):  # built while this process waited
                return path, cflags + libs
            err = _build(path, cflags, libs)
            if err is None:
                return path, cflags + libs
            errors.append(err)
    finally:
        os.close(fd)  # releases the lock
    raise RuntimeError(
        "the native fast-I/O library did not build in any variant; set "
        "TORCHSNAPSHOT_TPU_TORCH_ENABLE_NATIVE_EXT=0 to run without it.\n"
        + "\n".join(errors)
    )


def load() -> ctypes.CDLL:
    """The native library, built on first use.  Raises when no variant
    builds or loads."""
    global _lib
    if _lib is not None:
        return _lib
    if not _lock.acquire(timeout=LOAD_LOCK_TIMEOUT_S):
        raise TimeoutError(
            f"waited {LOAD_LOCK_TIMEOUT_S} s for another thread's load of the "
            "native fast-I/O library"
        )
    try:
        if _lib is None:
            path, flags = _find_or_build()
            cdll = ctypes.CDLL(path)
            for sym, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(cdll, sym)
                fn.restype = restype
                fn.argtypes = argtypes
            LOADED.update(path=path, flags=" ".join(flags))
            _lib = cdll
        return _lib
    finally:
        _lock.release()


def enabled_lib() -> Optional[ctypes.CDLL]:
    """The library, or None when ``ENABLE_NATIVE_EXT=0`` asks for the
    pure-Python digests and file legs."""
    return load() if knobs.is_native_ext_enabled() else None


def buffer_address(view: memoryview) -> int:
    """Address of a C-contiguous byte view, also of a read-only one
    (``bytes``, a read-only memoryview), which ``ctypes`` refuses.  The
    caller keeps ``view`` alive across the native call."""
    import numpy as np

    return np.frombuffer(view, dtype=np.uint8).ctypes.data


def _view(data) -> memoryview:
    return memoryview(data).cast("B")


def crc32z(lib: ctypes.CDLL, data, seed: int = 0) -> int:
    """zlib's crc32 (bit-compatible with ``zlib.crc32``)."""
    view = _view(data)
    if view.nbytes == 0:
        return seed & 0xFFFFFFFF
    return int(lib.tsnp_crc32z(buffer_address(view), view.nbytes, seed))


def adler32(lib: ctypes.CDLL, data, seed: int = 1) -> int:
    """zlib's adler32 (bit-compatible with ``zlib.adler32``)."""
    view = _view(data)
    if view.nbytes == 0:
        return seed & 0xFFFFFFFF
    return int(lib.tsnp_adler32(buffer_address(view), view.nbytes, seed))


def digest(lib: ctypes.CDLL, data) -> Tuple[int, int]:
    """(crc32, adler32) of ``data`` in one pass."""
    view = _view(data)
    if view.nbytes == 0:
        return (0, 1)
    out = (ctypes.c_uint32 * 2)()
    lib.tsnp_digest(buffer_address(view), view.nbytes, out)
    return (int(out[0]), int(out[1]))


def copy_digest(lib: ctypes.CDLL, dst, src) -> Tuple[int, int]:
    """Copy ``src`` into ``dst`` (a writable buffer of the same size) and
    return the (crc32, adler32) of the bytes, in one pass."""
    sview, dview = _view(src), _view(dst)
    if dview.readonly or dview.nbytes != sview.nbytes:
        raise ValueError(
            f"copy_digest needs a writable destination of {sview.nbytes} bytes, "
            f"got {dview.nbytes} (read-only: {dview.readonly})"
        )
    if sview.nbytes == 0:
        return (0, 1)
    out = (ctypes.c_uint32 * 2)()
    lib.tsnp_copy_digest(
        buffer_address(dview), buffer_address(sview), sview.nbytes, out
    )
    return (int(out[0]), int(out[1]))


def byte_shuffle(lib: ctypes.CDLL, data, stride: int, inverse: bool = False):
    """Byte-shuffle ``data`` (byte plane ``p`` of every ``stride``-byte
    element together; a tail shorter than one element is copied through)
    or, ``inverse``, undo it: one GIL-free pass into a new uint8 array."""
    import numpy as np

    view = _view(data)
    out = np.empty(view.nbytes, dtype=np.uint8)
    if view.nbytes:
        fn = lib.tsnp_byte_unshuffle if inverse else lib.tsnp_byte_shuffle
        fn(buffer_address(view), view.nbytes, stride, out.ctypes.data)
    return out


def huff_compress(lib: ctypes.CDLL, data, headroom: int = 0):
    """The native block-Huffman stream of ``data`` as a uint8 array,
    after ``headroom`` bytes reserved for the caller (the codec writes
    its frame header there, so the frame is built in place).  On
    incompressible data the stream may exceed the input by about 5 bytes
    per 128 KiB block."""
    import numpy as np

    view = _view(data)
    if view.nbytes == 0:
        return np.empty(headroom, dtype=np.uint8)
    cap = view.nbytes + view.nbytes // 64 + 4096
    out = np.empty(headroom + cap, dtype=np.uint8)
    rc = lib.tsnp_huff_compress(buffer_address(view), view.nbytes, out.ctypes.data + headroom, cap)
    if rc < 0:
        raise RuntimeError(f"tsnp_huff_compress overflowed its {cap}-byte capacity")
    ret = out[: headroom + rc]
    # a slice pins the whole capacity while the frame lives: copy it out
    # when compression saved enough to matter
    if out.nbytes - ret.nbytes > (1 << 20):
        ret = ret.copy()
    return ret


def huff_decompress(lib: ctypes.CDLL, data, raw_len: int):
    """Decode a native block-Huffman stream to exactly ``raw_len`` bytes
    (a uint8 array); ``ValueError`` on a malformed stream."""
    import numpy as np

    view = _view(data)
    out = np.empty(raw_len, dtype=np.uint8)
    if raw_len == 0 and view.nbytes == 0:
        return out
    rc = lib.tsnp_huff_decompress(buffer_address(view), view.nbytes, out.ctypes.data, raw_len)
    if rc != raw_len:
        raise ValueError(f"corrupt huff stream: decoded {rc} of {raw_len} expected bytes")
    return out
