"""zlib crc32/adler32 digests and their combination (zlib's crc32_combine /
adler32_combine, which the stdlib does not expose).

Counterpart of ``torchsnapshot_tpu/utils/checksums.py``.  The digests
run in the native library (``_csrc``: PCLMUL crc32, AVX2 adler32, the
GIL released) unless ``ENABLE_NATIVE_EXT=0``, and then in zlib; both give
the same values.  Buffers of at most ``NATIVE_MIN_BYTES`` go to zlib in
any case: for them the native call costs more than the digest.  A slab
write needs both per-member crc32s (manifest entries) and the
whole-object (crc32, adler32, size) digest; folding the per-member
values costs O(members · log(len)) integer math instead of another pass
over the staged bytes.
"""

from __future__ import annotations

import threading
import zlib
from typing import Sequence, Tuple

from .. import _csrc

_CRC_POLY = 0xEDB88320
_ADLER_MOD = 65521

NATIVE_MIN_BYTES = 4096


def _native(data):
    """(library, byte view) when ``data`` goes native, else (None, view)."""
    view = memoryview(data).cast("B")
    if view.nbytes <= NATIVE_MIN_BYTES:
        return None, view
    return _csrc.enabled_lib(), view


def crc32_fast(data, seed: int = 0) -> int:
    lib, view = _native(data)
    if lib is None:
        return zlib.crc32(view, seed) & 0xFFFFFFFF
    return _csrc.crc32z(lib, view, seed)


def adler32_fast(data, seed: int = 1) -> int:
    lib, view = _native(data)
    if lib is None:
        return zlib.adler32(view, seed) & 0xFFFFFFFF
    return _csrc.adler32(lib, view, seed)


def digest(data) -> Tuple[int, int]:
    """(crc32, adler32) of ``data``, in one native pass."""
    lib, view = _native(data)
    if lib is None:
        return zlib.crc32(view) & 0xFFFFFFFF, zlib.adler32(view) & 0xFFFFFFFF
    return _csrc.digest(lib, view)


def copy_digest(dst, src) -> Tuple[int, int]:
    """Copy ``src`` into ``dst`` (writable, the same size) and return the
    (crc32, adler32) of the bytes, in one native pass."""
    lib, view = _native(src)
    if lib is None:
        memoryview(dst).cast("B")[:] = view
        return zlib.crc32(view) & 0xFFFFFFFF, zlib.adler32(view) & 0xFFFFFFFF
    return _csrc.copy_digest(lib, dst, view)


def _gf2_matrix_times(mat: Sequence[int], vec: int) -> int:
    total = 0
    i = 0
    while vec:
        if vec & 1:
            total ^= mat[i]
        vec >>= 1
        i += 1
    return total


def _gf2_matrix_square(square: list, mat: Sequence[int]) -> None:
    for n in range(32):
        square[n] = _gf2_matrix_times(mat, mat[n])


# "advance crc by 2^k zero bytes" operators, built once and shared.
# Extension is locked: digests run on executor threads, and two threads
# appending the same square would shift every later operator's index.
_SHIFT_BY_POW2_BYTES: list = []
_SHIFT_LOCK = threading.Lock()


def _shift_matrix(k: int) -> Sequence[int]:
    if len(_SHIFT_BY_POW2_BYTES) > k:
        return _SHIFT_BY_POW2_BYTES[k]
    with _SHIFT_LOCK:
        while len(_SHIFT_BY_POW2_BYTES) <= k:
            if not _SHIFT_BY_POW2_BYTES:
                odd = [0] * 32  # advance-1-bit operator
                odd[0] = _CRC_POLY
                row = 1
                for n in range(1, 32):
                    odd[n] = row
                    row <<= 1
                m = [0] * 32
                _gf2_matrix_square(m, odd)  # 2 bits
                m2 = [0] * 32
                _gf2_matrix_square(m2, m)  # 4 bits
                one_byte = [0] * 32
                _gf2_matrix_square(one_byte, m2)  # 8 bits = 1 byte
                _SHIFT_BY_POW2_BYTES.append(one_byte)
            else:
                nxt = [0] * 32
                _gf2_matrix_square(nxt, _SHIFT_BY_POW2_BYTES[-1])
                _SHIFT_BY_POW2_BYTES.append(nxt)
        return _SHIFT_BY_POW2_BYTES[k]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32 of A+B given crc32(A), crc32(B), len(B)."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    crc1 &= 0xFFFFFFFF
    k = 0
    while len2:
        if len2 & 1:
            crc1 = _gf2_matrix_times(_shift_matrix(k), crc1)
        len2 >>= 1
        k += 1
    return (crc1 ^ crc2) & 0xFFFFFFFF


def adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """adler32 of A+B given adler32(A), adler32(B), len(B)."""
    if len2 <= 0:
        return ad1 & 0xFFFFFFFF
    rem = len2 % _ADLER_MOD
    sum1 = ad1 & 0xFFFF
    sum2 = (rem * sum1) % _ADLER_MOD
    sum1 += (ad2 & 0xFFFF) + _ADLER_MOD - 1
    sum2 += ((ad1 >> 16) & 0xFFFF) + ((ad2 >> 16) & 0xFFFF) + _ADLER_MOD - rem
    if sum1 >= _ADLER_MOD:
        sum1 -= _ADLER_MOD
    if sum1 >= _ADLER_MOD:
        sum1 -= _ADLER_MOD
    if sum2 >= (_ADLER_MOD << 1):
        sum2 -= _ADLER_MOD << 1
    if sum2 >= _ADLER_MOD:
        sum2 -= _ADLER_MOD
    return (sum1 | (sum2 << 16)) & 0xFFFFFFFF


def combine_piece_digests(
    pieces: Sequence[Tuple[int, int, int]],
) -> Tuple[int, int, int]:
    """Fold per-piece (crc32, adler32, nbytes) — in buffer order, exactly
    tiling the object — into the whole object's digest."""
    crc, adler, total = 0, 1, 0
    for pc, pa, pn in pieces:
        crc = crc32_combine(crc, pc, pn)
        adler = adler32_combine(adler, pa, pn)
        total += pn
    return crc, adler, total
