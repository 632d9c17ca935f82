"""Delta planner: which bytes a subscriber moves to reach a newly
published step from the one it holds.

Counterpart of ``torchsnapshot_tpu/publish/delta.py``; pure functions of
two records (no I/O), whose plans equal the reference's.  For every leaf
of the new record, refs are compared by position against the held
record's refs at the same leaf byte offset: a ref is reused when both
carry the same content key there; un-keyed refs reuse only on an
identical ``(base URL, path, extent)``, sound because committed snapshot
objects are immutable; a mixed pair fetches.  A leaf whose kind, dtype,
shape or inlined value changed, or that the held record lacks, fetches
in full.

A subscriber whose local leaf is a dim-0 slab of the published array
passes a ``shard_spec`` (per logical path, ``(offsets, local_shape)`` in
the global coordinates, ``preparers/overlap.py``'s boxes): only fetches
overlapping its byte window are kept, each fetched whole (the content
key covers the whole chunk) and sliced by the applier.  Other layouts
are refused: they need the resharding restore, not a hot swap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..preparers.overlap import is_dim0_slab, make_box
from .record import ref_nbytes


@dataclass
class FetchItem:
    """One ref to fetch: where its bytes live and where they land in the
    leaf's byte stream."""

    leaf: str
    base: str  # resolved base URL
    path: str
    byte_range: Optional[Tuple[int, int]]
    key: Optional[str]
    leaf_off: int
    nbytes: int


@dataclass
class DeltaPlan:
    fetches: List[FetchItem] = field(default_factory=list)
    # leaf → the (lo, hi) byte window the subscriber applies: the whole
    # leaf unless a shard_spec narrowed it
    windows: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    # leaves rebuilt from scratch (no basis: new, or changed meta)
    full_leaves: List[str] = field(default_factory=list)
    stats: Dict[str, int] = field(default_factory=dict)


def _leaf_meta(leaf: Dict[str, Any]) -> Tuple:
    return (
        leaf.get("kind"),
        leaf.get("dtype"),
        tuple(leaf.get("shape") or ()),
        leaf.get("tag"),
        int(leaf["size"]),
        # an inlined primitive's value is in its meta: a changed value
        # re-applies with no refs to diff
        leaf.get("ptype"),
        leaf.get("v"),
    )


def _ref_offsets(refs: List[Dict[str, Any]]) -> List[int]:
    offs, pos = [], 0
    for ref in refs:
        offs.append(pos)
        pos += ref_nbytes(ref)
    return offs


def leaf_window(leaf: Dict[str, Any], spec: Optional[Tuple]) -> Tuple[int, int]:
    """The byte extent of ``leaf`` a subscriber holds: all of it, or the
    dim-0 slab its local box maps to.  Raises ``ValueError`` for a box
    that is not a dim-0 slab or a leaf that is not an array."""
    size = int(leaf["size"])
    if spec is None:
        return (0, size)
    if leaf.get("kind") != "array":
        raise ValueError("shard_spec names a non-array leaf — only array leaves reshard")
    offsets, local_shape = spec
    global_shape = [int(d) for d in leaf["shape"]]
    inner = make_box(list(offsets), list(local_shape))
    outer = make_box([0] * len(global_shape), global_shape)
    if not is_dim0_slab(inner, outer):
        raise ValueError(
            f"subscriber box {inner} is not a dim-0 slab of the published shape "
            f"{global_shape}; hot-swap resharding requires one contiguous byte window per leaf"
        )
    if not global_shape or int(np.prod(global_shape)) == 0:
        return (0, 0)
    row_bytes = size // int(global_shape[0]) if global_shape[0] else 0
    lo = int(offsets[0]) * row_bytes
    hi = (int(offsets[0]) + int(local_shape[0])) * row_bytes
    return (lo, hi)


def plan_delta(
    new_record: Dict[str, Any],
    held_record: Optional[Dict[str, Any]],
    shard_spec: Optional[Dict[str, Tuple]] = None,
) -> DeltaPlan:
    """The fetch plan from ``held_record`` (None: a cold subscriber,
    everything fetches) to ``new_record``.  Stats count over the
    subscriber's windows, so ``bytes_total`` is what a full restore of
    the same subscriber would move."""
    plan = DeltaPlan()
    new_bases = [str(b).rstrip("/") for b in new_record["bases"]]
    held_leaves: Dict[str, Any] = dict(held_record["leaves"]) if held_record else {}
    held_bases = [str(b).rstrip("/") for b in held_record["bases"]] if held_record else []
    bytes_fetch = bytes_total = 0
    chunks_fetch = chunks_total = chunks_reused = 0
    leaves_changed = 0
    for path, leaf in new_record["leaves"].items():
        win_lo, win_hi = leaf_window(leaf, (shard_spec or {}).get(path))
        plan.windows[path] = (win_lo, win_hi)
        refs = leaf["refs"]
        held = held_leaves.get(path)
        same_meta = held is not None and _leaf_meta(held) == _leaf_meta(leaf)
        held_at: Dict[int, Dict[str, Any]] = {}
        if same_meta:
            held_at = dict(zip(_ref_offsets(held["refs"]), held["refs"]))
        else:
            plan.full_leaves.append(path)
        leaf_fetched = False
        for ref, off in zip(refs, _ref_offsets(refs)):
            n = ref_nbytes(ref)
            if not (off < win_hi and win_lo < off + n):
                continue
            chunks_total += 1
            bytes_total += n
            prev = held_at.get(off)
            if prev is not None and _same_content(ref, prev, new_bases, held_bases):
                chunks_reused += 1
                continue
            chunks_fetch += 1
            bytes_fetch += n
            leaf_fetched = True
            br = ref.get("o")
            plan.fetches.append(
                FetchItem(
                    leaf=path,
                    base=new_bases[int(ref["b"])],
                    path=str(ref["p"]),
                    byte_range=tuple(br) if br is not None else None,
                    key=ref.get("k"),
                    leaf_off=off,
                    nbytes=n,
                )
            )
        if leaf_fetched:
            leaves_changed += 1
    plan.stats = {
        "bytes_fetch": bytes_fetch,
        "bytes_total": bytes_total,
        "chunks_fetch": chunks_fetch,
        "chunks_total": chunks_total,
        "chunks_reused": chunks_reused,
        "leaves_changed": leaves_changed,
        "leaves_total": len(new_record["leaves"]),
    }
    return plan


def _same_content(
    ref: Dict[str, Any], prev: Dict[str, Any], new_bases: List[str], held_bases: List[str]
) -> bool:
    """Whether two aligned refs are the same bytes: keyed pairs by key,
    un-keyed pairs by immutable identity, a mixed pair never."""
    k, pk = ref.get("k"), prev.get("k")
    if k is not None and pk is not None:
        return k == pk
    if k is None and pk is None:
        try:
            same_base = new_bases[int(ref["b"])] == held_bases[int(prev["b"])]
        except (IndexError, ValueError):
            return False
        return (
            same_base
            and ref["p"] == prev["p"]
            and ref.get("o") == prev.get("o")
            and ref_nbytes(ref) == ref_nbytes(prev)
        )
    return False
