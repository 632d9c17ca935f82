"""Native fast-I/O engine: GIL-free file legs for the fs plugin.

Counterpart of ``torchsnapshot_tpu/storage/fastio.py``.  Each write or
read of the fs plugin becomes ONE native call (``_csrc/fastio.cpp``:
``tsnp_part_pwrite`` / ``tsnp_part_pread``) that runs outside the GIL:

- **writes** digest each 256 KB block while it is cache-hot and batch
  the syscalls with ``pwritev``, so a checksummed write reads the staged
  bytes once;
- **reads** land straight in the caller's buffer (a pinned tile, a
  template's memory);
- **O_DIRECT** (``FASTIO_DIRECT=1``) moves payload bytes around the page
  cache both ways.  The engine owns alignment: sub-sector heads and
  tails go buffered, the aligned body goes through an aligned bounce
  buffer (fused with the digest), so the caller's memory may start at
  any address.  Bytes and digests equal the buffered path's.

The ladder, decided once when the plugin is made, never per operation:

1. ``FASTIO=1`` (and the native library on) → the engine, buffered legs;
2. ``FASTIO_DIRECT=1`` and the root's filesystem takes O_DIRECT → direct
   legs for spans of at least :data:`DIRECT_MIN_BYTES`;
3. ``FASTIO_DIRECT=1`` and O_DIRECT refused (tmpfs on older kernels,
   some network filesystems) → buffered legs plus
   ``posix_fadvise(DONTNEED)`` after reads, counted in
   ``storage.fastio.dontneed_reads``: a capability, not a failure;
4. ``FASTIO=0`` or ``ENABLE_NATIVE_EXT=0`` → no engine; the plugin keeps
   its pure-Python legs.

The bounce pool exists only for the direct leg (``FASTIO_BUFFER_POOL_BYTES``
in 4 MiB buffers).  An exhausted pool makes a part wait (counted in
``storage.fastio.pool_waits``) instead of allocating, so the engine never
adds to the scheduler's memory budget; a wait past its deadline raises,
so a leaked buffer is an error and not a hang.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
import time
import uuid
from typing import Any, Optional, Tuple

from .. import knobs, obs
from .._csrc import buffer_address

logger = logging.getLogger(__name__)

# O_DIRECT alignment of offsets, lengths and memory: 4096 covers every
# logical block size in use (a 4Kn drive refuses 512).
ALIGN = 4096

# One pool buffer: 4 MiB amortises the direct syscalls without letting one
# part hold much of the pool.
BOUNCE_BYTES = 4 * 1024 * 1024

# Spans below this stay buffered even on the direct leg: they are mostly
# head and tail, and O_DIRECT's synchronous round trip would dominate.
DIRECT_MIN_BYTES = 1 * 1024 * 1024

# How long a part waits for a bounce buffer before the pool is taken to
# have leaked one.  A buffer is held for one native call of one part.
POOL_WAIT_TIMEOUT_S = 300.0
_POOL_WAIT_STEP_S = 1.0


class _AlignedPool:
    """Preallocated ALIGN-aligned bounce buffers, handed out as
    ``(address, nbytes)``.  ``acquire`` waits while every buffer is out
    (counted in ``storage.fastio.pool_waits``) and raises ``TimeoutError``
    past its deadline; ``release`` gives one back.  Thread-safe."""

    def __init__(self, total_bytes: int) -> None:
        import numpy as np

        count = max(1, int(total_bytes) // BOUNCE_BYTES)
        self._cond = threading.Condition()
        self._free: list = []
        self._bufs: list = []  # keeps the arrays alive for the pool's life
        for _ in range(count):
            raw = np.empty(BOUNCE_BYTES + ALIGN, dtype=np.uint8)
            off = (-raw.ctypes.data) % ALIGN
            self._bufs.append(raw)
            self._free.append((int(raw[off:].ctypes.data), BOUNCE_BYTES))
        self.count = count

    def acquire(self, timeout_s: float = POOL_WAIT_TIMEOUT_S) -> Tuple[int, int]:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            if not self._free:
                obs.counter(obs.FASTIO_POOL_WAITS).inc()
            while not self._free:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"fastio bounce pool: no free buffer of {self.count} within "
                        f"{timeout_s} s (a buffer was not released)"
                    )
                self._cond.wait(min(left, _POOL_WAIT_STEP_S))
            return self._free.pop()

    def release(self, buf: Tuple[int, int]) -> None:
        with self._cond:
            self._free.append(buf)
            self._cond.notify()

    def free_count(self) -> int:
        with self._cond:
            return len(self._free)


def _address(view: memoryview) -> Optional[int]:
    return buffer_address(view) if view.nbytes else None


def probe_direct(root: str) -> bool:
    """Whether ``root``'s filesystem takes O_DIRECT: create and unlink a
    probe file opened with it.  Where the create is refused (a read-only
    mount), open an existing file under ``root`` O_RDONLY|O_DIRECT, which
    is all reads need.  EINVAL (tmpfs) or no flag means no."""
    flag = getattr(os, "O_DIRECT", None)
    if flag is None:
        return False
    probe = os.path.join(
        root, f".tsnp-fastio-probe-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    )
    try:
        os.makedirs(root, exist_ok=True)
        fd = os.open(probe, os.O_WRONLY | os.O_CREAT | os.O_EXCL | flag, 0o644)
    except OSError as e:
        logger.debug("O_DIRECT create probe failed under %s: %r", root, e)
        return _probe_direct_readonly(root, flag)
    try:
        os.close(fd)
    finally:
        try:
            os.unlink(probe)
        except OSError:
            pass
    return True


def _probe_direct_readonly(root: str, flag: int) -> bool:
    """O_RDONLY|O_DIRECT on one of the first 16 regular files under
    ``root``."""
    examined = 0
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            examined += 1
            if examined > 16:
                return False
            try:
                fd = os.open(os.path.join(dirpath, fn), os.O_RDONLY | flag)
            except OSError:
                continue
            os.close(fd)
            return True
    return False


def create_engine(lib: Any, root: str) -> Optional["FastIOEngine"]:
    """The fs plugin's one probe: an engine when ``FASTIO`` is on, else
    None.  O_DIRECT support of ``root`` is probed here, once."""
    if lib is None or not knobs.fastio_enabled():
        return None
    want_direct = knobs.fastio_direct_enabled()
    direct_ok = probe_direct(root) if want_direct else False
    return FastIOEngine(
        lib,
        direct=direct_ok,
        dontneed=want_direct and not direct_ok,
        pool_bytes=knobs.get_fastio_buffer_pool_bytes(),
    )


class FastIOEngine:
    """GIL-free file reader and writer.  Every method is synchronous and
    thread-safe: the fs plugin calls them from its executor threads.
    Temp names and the rename commit stay with the caller; the engine
    owns byte movement, the fused digest and alignment."""

    def __init__(self, lib: Any, *, direct: bool, dontneed: bool, pool_bytes: int) -> None:
        self._lib = lib
        self.direct = direct
        self.dontneed = dontneed
        # only the direct leg bounces; buffered legs use the caller's memory
        self._pool = _AlignedPool(pool_bytes) if direct else None

    def _use_direct(self, nbytes: int) -> bool:
        return self.direct and nbytes >= DIRECT_MIN_BYTES

    def open_direct(self, path: str, flags: Optional[int] = None) -> int:
        """An O_DIRECT fd on ``path`` (O_RDWR unless ``flags``), or -1 when
        the direct leg is off or this file refuses it."""
        if not self.direct:
            return -1
        try:
            return os.open(path, (os.O_RDWR if flags is None else flags) | os.O_DIRECT)
        except OSError as e:
            logger.debug("O_DIRECT open of %s refused: %r", path, e)
            return -1

    def _part_pwrite(
        self, fd: int, fd_direct: int, offset: int, view: memoryview, want_digest: bool
    ) -> Optional[Tuple[int, int]]:
        """One native write of ``view`` at ``offset``; (crc32, adler32)
        when ``want_digest``.  A bounce buffer is taken for the direct
        leg only and always given back."""
        use_direct = fd_direct >= 0 and self._pool is not None and self._use_direct(view.nbytes)
        out = (ctypes.c_uint32 * 2)()
        bounce = None
        try:
            if use_direct:
                bounce = self._pool.acquire()
            rc = self._lib.tsnp_part_pwrite(
                fd,
                fd_direct if use_direct else -1,
                _address(view),
                view.nbytes,
                offset,
                ALIGN if use_direct else 0,
                bounce[0] if use_direct else None,
                bounce[1] if use_direct else 0,
                1 if want_digest else 0,
                out,
            )
        finally:
            if bounce is not None:
                self._pool.release(bounce)
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc))
        obs.counter(obs.FASTIO_DIRECT_PARTS if use_direct else obs.FASTIO_BUFFERED_PARTS).inc()
        obs.counter(obs.FASTIO_BYTES_WRITTEN).inc(view.nbytes)
        if want_digest:
            obs.counter(obs.FASTIO_FUSED_DIGESTS).inc()
            return (int(out[0]), int(out[1]))
        return None

    def write_file(
        self, path: str, buf: Any, sync_file: bool, want_digest: bool
    ) -> Optional[Tuple[int, int]]:
        """Create or truncate ``path`` (the caller's temp file) and write
        ``buf``; returns the fused (crc32, adler32) when asked."""
        view = memoryview(buf).cast("B")
        with obs.span("fastio/write_file", path=path, bytes=view.nbytes):
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC | os.O_CLOEXEC, 0o644)
            fd_direct = -1
            try:
                if self._use_direct(view.nbytes):
                    fd_direct = self.open_direct(path)
                digests = self._part_pwrite(fd, fd_direct, 0, view, want_digest)
                if sync_file:
                    os.fdatasync(fd)
                if self.dontneed:
                    # after the sync: DONTNEED drops clean pages only
                    self._fadvise_dontneed(fd, 0, view.nbytes)
            finally:
                if fd_direct >= 0:
                    os.close(fd_direct)
                os.close(fd)
            return digests

    def read_into(self, path: str, offset: int, length: int, out: Any) -> int:
        """Read ``[offset, offset + length)`` of ``path`` into ``out`` (a
        writable buffer of ``length`` bytes, at any address); returns the
        bytes read, short only at the end of the file."""
        view = memoryview(out).cast("B")
        with obs.span("fastio/read_into", path=path, bytes=length):
            fd = os.open(path, os.O_RDONLY | os.O_CLOEXEC)
            fd_direct = -1
            bounce = None
            try:
                use_direct = self._pool is not None and self._use_direct(length)
                if use_direct:
                    fd_direct = self.open_direct(path, os.O_RDONLY)
                    use_direct = fd_direct >= 0
                if use_direct:
                    bounce = self._pool.acquire()
                n = self._lib.tsnp_part_pread(
                    fd,
                    fd_direct if use_direct else -1,
                    _address(view),
                    length,
                    offset,
                    ALIGN if use_direct else 0,
                    bounce[0] if use_direct else None,
                    bounce[1] if use_direct else 0,
                )
                if n < 0:
                    raise OSError(-n, os.strerror(-n), path)
                if self.dontneed:
                    self._fadvise_dontneed(fd, offset, length)
                    obs.counter(obs.FASTIO_DONTNEED_READS).inc()
                obs.counter(
                    obs.FASTIO_DIRECT_PARTS if use_direct else obs.FASTIO_BUFFERED_PARTS
                ).inc()
                obs.counter(obs.FASTIO_BYTES_READ).inc(int(n))
                return int(n)
            finally:
                if bounce is not None:
                    self._pool.release(bounce)
                if fd_direct >= 0:
                    os.close(fd_direct)
                os.close(fd)

    def pwrite_part(
        self, fd: int, fd_direct: int, offset: int, buf: Any, want_digest: bool
    ) -> Optional[Tuple[int, int]]:
        """One part written at ``offset`` through fds its caller holds;
        the part's fused (crc32, adler32) when asked."""
        view = memoryview(buf).cast("B")
        with obs.span("fastio/pwrite_part", bytes=view.nbytes, offset=offset):
            return self._part_pwrite(fd, fd_direct, offset, view, want_digest)

    @staticmethod
    def _fadvise_dontneed(fd: int, offset: int, length: int) -> None:
        try:
            os.posix_fadvise(fd, offset, length, os.POSIX_FADV_DONTNEED)
        except (AttributeError, OSError) as e:  # advice only
            logger.debug("posix_fadvise(DONTNEED) failed: %r", e)

    def pool_free_count(self) -> int:
        """Free bounce buffers now; 0 without the direct leg."""
        return self._pool.free_count() if self._pool is not None else 0
