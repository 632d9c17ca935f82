"""Manifest operations: per-rank views, shard merging, elasticity.

The port's own copy of ``torchsnapshot_tpu/manifest_ops.py``.

The global manifest maps ``"<rank>/<logical_path>" → Entry``.  A restoring
rank sees:

- its own per-rank entries (``rank/`` prefix stripped),
- every replicated entry (saved once under the writing rank after
  consolidation — any rank may read it; reference manifest_ops.py:77-79),
- sharded entries **merged across all saved ranks** so the full set of
  shard boxes is visible for overlap-based resharding reads (reference
  _get_merged_sharded_tensor_entries / _get_merged_dtensor_entries,
  manifest_ops.py:111-177),
- if ``rank >= saved world_size`` (world grew): rank 0's replicated+sharded
  view (reference manifest_ops.py:88).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .manifest import (
    Entry,
    Manifest,
    ShardedArrayEntry,
    SnapshotMetadata,
    is_container_entry,
)


def _split_rank_path(key: str) -> Tuple[int, str]:
    rank_str, _, lpath = key.partition("/")
    return int(rank_str), lpath


def _is_replicated_entry(entry: Entry) -> bool:
    return bool(getattr(entry, "replicated", False))


def merge_sharded_entries(entries: List[ShardedArrayEntry]) -> ShardedArrayEntry:
    """Merge per-rank shard lists into one global entry, deduping identical
    boxes (replicas saved by different ranks).

    Per-rank entries for the same logical path must agree on array
    metadata — a divergence means a corrupt or hand-edited manifest, and
    silently adopting ``entries[0]``'s dtype would misinterpret every
    other rank's payload bytes (a dtype swap with equal itemsize would
    even pass extent checks in ``verify.py``).  Raise instead."""
    first = entries[0]
    for e in entries[1:]:
        if (
            e.dtype != first.dtype
            or list(e.shape) != list(first.shape)
            or e.spec != first.spec
            or e.mesh_shape != first.mesh_shape
            or e.mesh_axis_names != first.mesh_axis_names
        ):
            raise ValueError(
                "per-rank sharded entries disagree on array metadata "
                "(dtype/shape/spec/mesh): "
                f"{first.dtype}/{first.shape}/{first.spec}/"
                f"{first.mesh_shape}x{first.mesh_axis_names} vs "
                f"{e.dtype}/{e.shape}/{e.spec}/"
                f"{e.mesh_shape}x{e.mesh_axis_names} — corrupt or "
                "hand-edited manifest?"
            )
    seen = set()
    shards = []
    for e in entries:
        for s in e.shards:
            box = (tuple(s.offsets), tuple(s.sizes))
            if box not in seen:
                seen.add(box)
                shards.append(s)
    shards.sort(key=lambda s: tuple(s.offsets))
    return ShardedArrayEntry(
        dtype=first.dtype,
        shape=first.shape,
        shards=shards,
        mesh_axis_names=first.mesh_axis_names,
        mesh_shape=first.mesh_shape,
        spec=first.spec,
    )


def get_manifest_for_rank(
    metadata: SnapshotMetadata, rank: int
) -> Manifest:
    """Build the logical-path → entry view for a restoring rank
    (reference get_manifest_for_rank, manifest_ops.py:35-109)."""
    per_rank: Dict[int, Manifest] = {}
    sharded: Dict[str, List[ShardedArrayEntry]] = {}
    replicated: Manifest = {}
    for key, entry in metadata.manifest.items():
        r, lpath = _split_rank_path(key)
        per_rank.setdefault(r, {})[lpath] = entry
        if isinstance(entry, ShardedArrayEntry):
            sharded.setdefault(lpath, []).append(entry)
        elif _is_replicated_entry(entry):
            replicated.setdefault(lpath, entry)

    if rank < metadata.world_size:
        view = dict(per_rank.get(rank, {}))
    else:
        # world grew: new ranks adopt rank 0's replicated/sharded view
        view = {
            lpath: e
            for lpath, e in per_rank.get(0, {}).items()
            if is_container_entry(e)
            or _is_replicated_entry(e)
            or isinstance(e, ShardedArrayEntry)
        }

    # overlay replicated entries this rank didn't write itself
    for lpath, entry in replicated.items():
        view.setdefault(lpath, entry)
    # overlay merged sharded entries (full global box set)
    for lpath, entries in sharded.items():
        if lpath in view or rank >= metadata.world_size:
            view[lpath] = merge_sharded_entries(entries)
    return view


def consolidate_manifests(
    per_rank_manifests: List[Dict[str, Entry]],
) -> Manifest:
    """Build the global manifest from gathered per-rank manifests, keeping
    replicated entries only under the lowest rank that has them (reference
    consolidate_replicated_entries, partitioner.py:311-355)."""
    global_manifest: Manifest = {}
    seen_replicated: set = set()
    for r, manifest in enumerate(per_rank_manifests):
        for lpath, entry in manifest.items():
            if _is_replicated_entry(entry):
                if lpath in seen_replicated:
                    continue
                seen_replicated.add(lpath)
            global_manifest[f"{r}/{lpath}"] = entry
    return global_manifest
