"""The comparisons that decide ``correct``.

Checkpointing is exact: every leaf has to come back bit for bit, so each
number compared has the limit 0.  A leaf is compared on the device, one
at a time, against its value drawn again from the seed
(``fill.expected``); ``max_abs_err`` is computed only where bits differ.
A stored snapshot also has to carry the digests the format asks for:
each object's (crc32, adler32, size) in the metadata's ``objects``
table and each piece's crc32, recomputed here from the stored bytes
(``bad_digests``).
"""

from __future__ import annotations

import math
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence

import torch

from . import fill
from .reader import PlainSnapshot

# number compared → its limit
LIMITS = {"missing_leaves": 0, "mismatched_elements": 0, "max_abs_err": 0.0, "bad_digests": 0}
# zlib releases the GIL on large buffers: objects are digested in parallel
_DIGEST_THREADS = min(8, os.cpu_count() or 1)

_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclass(frozen=True)
class LeafSpec:
    """A leaf of a benchmark state: its logical path in a one-rank
    snapshot, and how the seed draws it."""

    path: str
    shape: tuple
    dtype: torch.dtype
    index: int
    kind: str

    def expected(self, device: Any, seed: int, version: int) -> torch.Tensor:
        return fill.expected(self.shape, self.dtype, device, seed, version, self.index, self.kind)


def compare(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(elements whose bits differ, largest absolute difference)."""
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        return max(got.numel(), want.numel(), 1), math.inf
    if got.numel() == 0:
        return 0, 0.0
    bits = _BITS.get(got.element_size())
    if got.is_floating_point() and bits is not None:
        diff = got.contiguous().view(bits) != want.contiguous().view(bits)
    else:
        diff = got != want
    mismatched = int(diff.sum())
    if not mismatched:
        return 0, 0.0
    err = (got.float() - want.float()).abs().nan_to_num(nan=math.inf).max()
    return mismatched, float(err)


class Tally:
    """The numbers compared, over every leaf a check looked at."""

    def __init__(self) -> None:
        self.leaves = 0
        self.missing = 0
        self.mismatched = 0
        self.max_abs_err = 0.0
        self.bad_digests: Optional[int] = None

    def add(self, got: Optional[torch.Tensor], want: torch.Tensor) -> None:
        self.leaves += 1
        if got is None:
            self.missing += 1
            return
        m, e = compare(got.to(want.device), want)
        self.mismatched += m
        self.max_abs_err = max(self.max_abs_err, e)

    def add_value(self, got: Any, want: Any) -> None:
        self.leaves += 1
        if got is None:
            self.missing += 1
        elif got != want:
            self.mismatched += 1
            self.max_abs_err = math.inf

    def checks(self) -> Dict[str, Dict[str, float]]:
        values = {
            "missing_leaves": self.missing,
            "mismatched_elements": self.mismatched,
            "max_abs_err": self.max_abs_err,
        }
        if self.bad_digests is not None:
            values["bad_digests"] = self.bad_digests
        return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def passed(checks: Mapping[str, Mapping[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def count_bad_digests(snap: PlainSnapshot) -> int:
    """Stored digests that do not hold, recomputed from the stored bytes:
    each object an array entry names against its ``objects`` entry
    (crc32, adler32, size), and each piece against its own crc32.  A
    missing table, entry or piece crc32, or a missing object, counts."""
    pieces = snap.pieces()
    table = snap.digests or {}

    def whole(location: str) -> int:
        want = table.get(location)
        if want is None or location not in snap.objects:
            return 1
        view = snap.view(location)
        return int([zlib.crc32(view), zlib.adler32(view), view.nbytes] != list(want))

    def piece(p: Mapping[str, Any]) -> int:
        if "crc32" not in p or p["location"] not in snap.objects:
            return 1
        return int(zlib.crc32(snap.view(p["location"], p.get("byte_range"))) != p["crc32"])

    locations = sorted({p["location"] for p in pieces})
    with ThreadPoolExecutor(_DIGEST_THREADS) as pool:
        return sum(pool.map(whole, locations)) + sum(pool.map(piece, pieces))


def check_snapshot(
    objects: Mapping[str, Any], specs: Sequence[LeafSpec], primitives: Mapping[str, Any],
    seed: int, version: int, device: Any,
) -> Dict[str, Dict[str, float]]:
    """Every leaf and primitive of a stored one-rank snapshot against its
    value at ``version``, and every digest it stores; a leaf the plain
    reader cannot read counts as missing."""
    tally = Tally()
    try:
        snap = PlainSnapshot(objects)
    except (KeyError, ValueError):
        snap = None
    tally.bad_digests = count_bad_digests(snap) if snap is not None else max(len(specs), 1)
    for spec in specs:
        got = None
        if snap is not None:
            try:
                got = snap.tensor(spec.path)
            except (KeyError, ValueError):
                got = None
        tally.add(got, spec.expected(device, seed, version))
    for path, want in primitives.items():
        got = None
        if snap is not None:
            try:
                got = snap.primitive(path)
            except (KeyError, ValueError):
                got = None
        tally.add_value(got, want)
    return tally.checks()


def check_tensors(
    pairs: Sequence[tuple], seed: int, version: int, device: Any,
) -> Dict[str, Dict[str, float]]:
    """``(tensor, LeafSpec)`` pairs, each tensor held in its own dtype
    against the leaf's value at ``version`` cast to that dtype."""
    tally = Tally()
    for got, spec in pairs:
        want = spec.expected(device, seed, version)
        if got is not None and got.dtype != want.dtype:
            want = want.to(got.dtype)
        tally.add(got, want)
    return tally.checks()
