"""Hyperrectangle (box) algebra for shard overlap and resharding.

The port's own copy of ``torchsnapshot_tpu/preparers/overlap.py``.  A box
is ``(offsets, sizes)``, one entry per dim.  The same algebra covers
every layout a snapshot stores: a DTensor's local shards, a
``NamedSharding``'s device boxes, one array dim split over several mesh
dims, and the full box of an unsharded template.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Box = Tuple[Tuple[int, ...], Tuple[int, ...]]


def make_box(offsets: Sequence[int], sizes: Sequence[int]) -> Box:
    return tuple(int(o) for o in offsets), tuple(int(s) for s in sizes)


def box_nelems(box: Box) -> int:
    n = 1
    for s in box[1]:
        n *= s
    return n


def box_intersect(a: Box, b: Box) -> Optional[Box]:
    offsets: List[int] = []
    sizes: List[int] = []
    for (ao, as_), (bo, bs) in zip(zip(*a), zip(*b)):
        lo = max(ao, bo)
        hi = min(ao + as_, bo + bs)
        if hi <= lo:
            return None
        offsets.append(lo)
        sizes.append(hi - lo)
    return tuple(offsets), tuple(sizes)


def relative_slices(inner: Box, outer: Box) -> Tuple[slice, ...]:
    """Slices selecting ``inner`` within an array whose region is ``outer``."""
    return tuple(
        slice(io - oo, io - oo + isz)
        for io, isz, oo in zip(inner[0], inner[1], outer[0])
    )


def is_dim0_slab(inner: Box, outer: Box) -> bool:
    """True iff ``inner`` spans ``outer`` fully in every dim but dim 0:
    a contiguous row range of the C-order payload that stores ``outer``."""
    for d, (io, isz, oo, osz) in enumerate(zip(inner[0], inner[1], outer[0], outer[1])):
        if d == 0:
            continue
        if io != oo or isz != osz:
            return False
    return True
