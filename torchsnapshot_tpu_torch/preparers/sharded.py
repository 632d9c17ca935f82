"""Sharded-array preparer: ``DTensor`` save and restore, with
collective-free write assignment and overlap-based resharding reads.

Counterpart of ``torchsnapshot_tpu/preparers/sharded.py`` (which does the
same for multi-device ``jax.Array``s), in the same on-disk format: a
``ShardedArrayEntry`` whose shards are stored at
``sharded/<path>.<offsets>.<sizes>``, plus the layout as
``mesh_axis_names``/``mesh_shape``/``spec`` (``parallel/mesh.py`` maps
placements to and from that spec).  Either package restores the other's
sharded snapshots.

Write: a DTensor's layout is global knowledge, since every rank holds
the same mesh and placements, so the box of every mesh coordinate is
computed from DTensor's own local-shape/global-offset rule (the
``torch.chunk`` split: uneven, trailing shards may be empty; empty boxes
are skipped).  Boxes held by several ranks (replicas) are written once,
each by the least-loaded rank holding it, largest box first
(``assign_box_writers``): a pure function of the layout and of the
per-rank loads every rank passes alike, so no collective runs.  A box
above the MAX_SHARD_SIZE_BYTES knob is subdivided along its largest dim.
Each stored shard stages from a view of the local tensor (pinned D2H
for CUDA, as a plain tensor does) and its crc32 lands in its record.

Read: the template's local box (a DTensor's, or one full box for any
other template) is intersected with the saved boxes; each overlapping
saved shard is read once, only its covering dim-0 row range when that
suffices, in row tiles under a memory budget (their crc32s folded).
Where every overlap spans the whole local box and its saved box but
along dim 0, each read's rows are one flat range of the local tensor
and land in place as they arrive: on a contiguous CUDA tensor from the
read's own pinned buffer by one host-to-device copy, or through kernel
K6 (``tile_update``) when the dtypes differ, as a dense budgeted read's
tiles do.  Otherwise (strided overlaps) the box is assembled on the
host in the saved dtype, in a buffer allocated at the first scatter
(pinned for the card, and counted in ``PINNED_TILES``), and lands once
over its whole flat range; this buffer is the size of the local box,
whatever the budget.  A CUDA tensor that cannot take either (not
contiguous, or a cast pair K6 does not take) counts a ``TILE_MISSES``
and is copied plainly.  Resharding across world sizes and layouts is
this same path with another template.
"""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import Executor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import knobs, obs
from ..io_types import BufferConsumer, Future, ReadReq, WriteReq
from ..manifest import Shard, ShardedArrayEntry
from ..serialization import dtype_to_string, string_to_dtype, tensor_from_buffer
from .array import (
    _Countdown,
    _DeviceTileTarget,
    _HostTileTarget,
    _plan_flat_tiles,
    _stager_for,
    _tile_miss,
    _TileCrcFold,
)
from .overlap import (
    Box,
    box_intersect,
    box_nelems,
    is_dim0_slab,
    make_box,
    relative_slices,
)


def is_dtensor(obj: Any) -> bool:
    if not isinstance(obj, torch.Tensor) or type(obj) in (torch.Tensor, torch.nn.Parameter):
        return False
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a torch built without distributed
        return False
    return isinstance(obj, DTensor)


def check_layout(obj: Any, logical_path: str) -> None:
    """Refuse, by leaf and placement, a layout the format cannot hold: a
    pending reduction (``Partial``) or a strided shard (``_StridedShard``,
    several mesh dims splitting one tensor dim out of mesh-dim order)."""
    for p in obj.placements:
        if type(p).__name__ == "_StridedShard":
            raise ValueError(
                f"{logical_path!r}: DTensor placement {p!r} (_StridedShard) "
                "splits a tensor dim over mesh dims out of mesh-dim order, "
                "which a snapshot's shard boxes cannot describe; "
                "redistribute to Shard/Replicate placements first"
            )
        if p.is_partial():
            raise ValueError(
                f"{logical_path!r}: DTensor placement {p!r} (Partial) holds "
                "a pending reduction, not array data; redistribute to "
                "Shard/Replicate placements first"
            )
        if not (p.is_shard() or p.is_replicate()):
            raise ValueError(f"{logical_path!r}: unsupported DTensor placement {p!r}")


def check_coordinator_rank(rank: int, world: int, obj: Any, logical_path: str) -> None:
    """A DTensor's mesh holds global ranks of the default process group;
    box writers are chosen among them by the coordinator's rank, so the
    two must be one numbering."""
    import torch.distributed as dist

    drank = dist.get_rank() if dist.is_available() and dist.is_initialized() else None
    ranks = obj.device_mesh.mesh.flatten().tolist()
    if drank != rank or max(ranks) >= world:
        raise ValueError(
            f"{logical_path!r}: the DTensor's mesh holds global ranks {ranks} "
            f"(this process: {drank}), but the snapshot's coordinator is "
            f"rank {rank} of {world}; pass a coordinator whose ranks are "
            "torch.distributed's"
        )


def _location_for_box(logical_path: str, box: Box) -> str:
    off = "_".join(str(o) for o in box[0])
    sz = "_".join(str(s) for s in box[1])
    return f"sharded/{logical_path}.{off}.{sz}" if off else f"sharded/{logical_path}.scalar"


def box_at(shape: Sequence[int], mesh_shape: Sequence[int], coord: Sequence[int], placements: Sequence[Any]) -> Box:
    """The box the DTensor of ``placements`` over a mesh of ``mesh_shape``
    holds at mesh coordinate ``coord`` (DTensor's own rule; no process
    group needed)."""
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    sizes, offsets = _compute_local_shape_and_global_offset(
        tuple(int(s) for s in shape), tuple(int(s) for s in mesh_shape),
        [int(c) for c in coord], list(placements),
    )
    return make_box(offsets, sizes)


def layout_boxes(shape: Sequence[int], mesh_ranks: np.ndarray, placements: Sequence[Any]) -> Dict[Box, List[int]]:
    """Each non-empty box of the layout → the global ranks holding it, in
    mesh-coordinate order (``mesh_ranks``: the mesh's rank at every
    coordinate)."""
    boxes: Dict[Box, List[int]] = {}
    for coord in np.ndindex(*mesh_ranks.shape):
        box = box_at(shape, mesh_ranks.shape, coord, placements)
        if box_nelems(box) == 0:
            continue
        boxes.setdefault(box, []).append(int(mesh_ranks[coord]))
    return boxes


def _subdivide(box: Box, itemsize: int, max_bytes: int) -> List[Box]:
    """Split a box along its largest dim until every piece is at most
    ``max_bytes``."""
    nbytes = box_nelems(box) * itemsize
    if nbytes <= max_bytes or not box[1]:
        return [box]
    dim = max(range(len(box[1])), key=lambda d: box[1][d])
    if box[1][dim] <= 1:
        return [box]
    rows = box[1][dim]
    rows_per = max(1, max_bytes // max(1, nbytes // rows))
    out: List[Box] = []
    for r in range(0, rows, rows_per):
        offsets, sizes = list(box[0]), list(box[1])
        offsets[dim] += r
        sizes[dim] = min(rows_per, rows - r)
        out.extend(_subdivide(make_box(offsets, sizes), itemsize, max_bytes))
    return out


def assign_box_writers(
    boxes: Dict[Box, List[int]],
    itemsize: int,
    process_count: int,
    preloads: Optional[List[int]] = None,
) -> Dict[Box, int]:
    """Largest box first, to the least-loaded rank holding it (lowest rank
    on a tie).  ``preloads``: each rank's bytes already committed (its
    per-rank state and earlier sharded leaves), MUTATED IN PLACE so one
    vector composes across a take's sharded leaves; every rank must pass
    the same vector and visit the leaves in the same order."""
    loads = preloads if preloads is not None else [0] * max(1, process_count)
    assignment: Dict[Box, int] = {}
    for box in sorted(boxes, key=lambda b: (-box_nelems(b), b[0])):
        writer = min(sorted(set(boxes[box])), key=lambda p: (loads[p], p))
        assignment[box] = writer
        loads[writer] += box_nelems(box) * itemsize
    return assignment


def _sharding_metadata(obj: Any) -> Tuple[Optional[List[str]], Optional[List[int]], Optional[List[Any]]]:
    from ..parallel.mesh import spec_from_placements

    mesh = obj.device_mesh
    if mesh.mesh_dim_names is None:
        return None, None, None
    return (
        [str(n) for n in mesh.mesh_dim_names],
        [int(s) for s in mesh.shape],
        spec_from_placements(mesh, obj.placements, obj.dim()),
    )


def _local_tensor(obj: Any) -> torch.Tensor:
    with torch.no_grad():
        return obj.to_local().detach()


def _local_box(obj: Any, shape: Sequence[int]) -> Optional[Box]:
    """This process's box of DTensor ``obj`` (None when it is not on the
    mesh or its box is empty)."""
    mesh = obj.device_mesh
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    box = box_at(shape, mesh.shape, coord, obj.placements)
    return box if box_nelems(box) else None


class ShardedArrayIOPreparer:
    @staticmethod
    def prepare_write(
        obj: Any,
        logical_path: str,
        rank: int,
        world: int,
        writer_loads: Optional[List[int]] = None,
        is_async: bool = False,
    ) -> Tuple[ShardedArrayEntry, List[WriteReq]]:
        check_layout(obj, logical_path)
        check_coordinator_rank(rank, world, obj, logical_path)
        shape = tuple(int(s) for s in obj.shape)
        itemsize = obj.element_size()
        mesh_ranks = obj.device_mesh.mesh.cpu().numpy()
        boxes = layout_boxes(shape, mesh_ranks, obj.placements)
        assignment = assign_box_writers(boxes, itemsize, world, preloads=writer_loads)
        axis_names, mesh_shape, spec = _sharding_metadata(obj)
        shards: List[Shard] = []
        write_reqs: List[WriteReq] = []
        max_shard_bytes = knobs.get_max_shard_size_bytes()
        local = None
        for box in boxes:
            if assignment[box] != rank:
                continue
            if local is None:
                local = _local_tensor(obj)
                if box != _local_box(obj, shape):
                    raise ValueError(f"{logical_path!r}: this rank's local tensor does not hold box {box}")
            for sub in _subdivide(box, itemsize, max_shard_bytes):
                shard = Shard(offsets=list(sub[0]), sizes=list(sub[1]), location=_location_for_box(logical_path, sub))
                shards.append(shard)
                view = local[relative_slices(sub, box)] if sub != box else local
                write_reqs.append(
                    WriteReq(
                        path=shard.location,
                        buffer_stager=_stager_for(view, is_async),
                        checksum_sinks=[(lambda c, s=shard: setattr(s, "crc32", c), None)],
                    )
                )
        entry = ShardedArrayEntry(
            dtype=dtype_to_string(obj.dtype),
            shape=list(shape),
            shards=shards,
            mesh_axis_names=axis_names,
            mesh_shape=mesh_shape,
            spec=spec,
        )
        return entry, write_reqs

    @staticmethod
    def prepare_read(
        entry: ShardedArrayEntry,
        obj_out: Any = None,
        buffer_size_limit_bytes: Optional[int] = None,
    ) -> Tuple[List[ReadReq], Future]:
        fut: Future = Future()
        shape = tuple(int(s) for s in entry.shape)
        stored = string_to_dtype(entry.dtype)
        itemsize = stored.itemsize

        # dedup saved shards by box (a merged view may list replicas)
        saved: Dict[Box, Shard] = {}
        for s in entry.shards:
            box = make_box(s.offsets, s.sizes)
            if box_nelems(box):
                saved.setdefault(box, s)

        full = make_box((0,) * len(shape), shape)
        dst: Any = obj_out
        if is_dtensor(obj_out):
            if tuple(obj_out.shape) != shape:
                raise ValueError(
                    f"sharded entry of shape {list(shape)} cannot restore into a "
                    f"DTensor of shape {list(obj_out.shape)}"
                )
            lbox = _local_box(obj_out, shape)
            dst = _local_tensor(obj_out)
        else:
            lbox = full if box_nelems(full) else None

        # saved shard → its overlaps with the local box
        plans: List[Tuple[Shard, Box, List[Box]]] = []
        if lbox is not None:
            for sbox, shard in saved.items():
                inter = box_intersect(sbox, lbox)
                if inter is not None:
                    plans.append((shard, sbox, [inter]))
        direct = bool(shape) and all(
            is_dim0_slab(inter, lbox) and is_dim0_slab(inter, sbox)
            for _, sbox, inters in plans for inter in inters
        )
        target = _BoxTarget(lbox, dst, stored, direct) if lbox is not None else None

        def assemble() -> None:
            result = target.land() if target is not None else None
            if obj_out is not None:
                fut.set(obj_out)
            elif result is not None:
                fut.set(result)
            else:
                fut.set(torch.empty(shape, dtype=stored))

        if not plans:
            assemble()
            return [], fut

        countdown = _Countdown(len(plans), assemble)
        read_reqs: List[ReadReq] = []
        for shard, sbox, inters in plans:
            expected_crc: Optional[int] = None
            base = shard.byte_range[0] if shard.byte_range else 0
            if sbox[1] and all(is_dim0_slab(inter, sbox) for inter in inters):
                # minimal fetch: the row range the overlaps cover
                r0 = min(inter[0][0] for inter in inters) - sbox[0][0]
                r1 = max(inter[0][0] + inter[1][0] for inter in inters) - sbox[0][0]
                row_bytes = (box_nelems(sbox) // sbox[1][0]) * itemsize
                byte_range: Optional[List[int]] = [base + r0 * row_bytes, base + r1 * row_bytes]
                offsets, sizes = list(sbox[0]), list(sbox[1])
                offsets[0] += r0
                sizes[0] = r1 - r0
                read_box = make_box(offsets, sizes)
                if r0 == 0 and r1 == sbox[1][0]:
                    # the whole payload: its recorded crc32 applies
                    expected_crc = shard.crc32
            else:
                byte_range = list(shard.byte_range) if shard.byte_range else None
                read_box = sbox
                expected_crc = shard.crc32
            read_reqs.extend(
                _emit_shard_reads(
                    shard.location, read_box, byte_range, expected_crc, entry.dtype,
                    itemsize, inters, target, countdown, buffer_size_limit_bytes,
                )
            )
        return read_reqs, fut


class _BoxTarget:
    """The local box of a restore, and where its bytes land.

    ``direct`` (every overlap a dim-0 slab of both the box and its saved
    shard, so each read's rows are one contiguous flat range of the box):
    rows land as they arrive, tile by tile, in a tile target of
    ``array.py`` -- a contiguous CUDA template (``_DeviceTileTarget``:
    the read's own pinned buffer, one host-to-device copy, a cast through
    K6), a contiguous CPU tensor, or a fresh CPU tensor when there is no
    template -- so host memory is that of the reads in flight.

    Otherwise (strided overlaps, a numpy template, a CUDA template the
    tiles cannot take) the box is assembled in a host buffer of the saved
    dtype, allocated at the first scatter, and landed whole by ``land``:
    for the card, a pinned buffer taken from the device target (so it
    counts in ``PINNED_TILES``) and one copy over the box's flat range."""

    def __init__(self, box: Box, dst: Any, stored: torch.dtype, direct: bool) -> None:
        self.box = box
        self.dst = dst
        self.stored = stored
        self.device: Optional[_DeviceTileTarget] = None
        self.tiles: Any = None
        self._host: Optional[torch.Tensor] = None
        self._into: Any = None  # the pinned box buffer, from ``device``
        self._lock = threading.Lock()
        numel = box_nelems(box)
        if isinstance(dst, (torch.Tensor, np.ndarray)) and np.prod(dst.shape, dtype=np.int64) != numel:
            raise ValueError(f"a template of shape {list(dst.shape)} cannot take box {box}")
        if isinstance(dst, torch.Tensor) and dst.device.type == "cuda":
            from ..ops.device_pack import cast_supported

            if not dst.is_contiguous():
                _tile_miss("layout")
            elif not cast_supported(stored, dst.dtype):
                _tile_miss("cast")
            else:
                self.device = _DeviceTileTarget(dst, stored)
        if not direct:
            return
        if self.device is not None:
            self.tiles = self.device
        elif dst is None:
            self.tiles = _HostTileTarget(torch.empty(numel, dtype=stored))
        elif isinstance(dst, torch.Tensor) and dst.device.type == "cpu" and dst.is_contiguous():
            self.tiles = _HostTileTarget(dst.detach().view(-1))

    def host(self) -> torch.Tensor:
        """The box's assembly buffer, allocated by the first caller."""
        with self._lock:
            if self._host is None:
                if self.device is not None:
                    self._into = self.device.read_buffer(box_nelems(self.box) * self.stored.itemsize)
                    self._host = self._into[1].view(self.stored).view(self.box[1])
                else:
                    self._host = torch.empty(self.box[1], dtype=self.stored)
            return self._host

    def land(self) -> Any:
        dst = self.dst
        if self.tiles is not None:  # every row has landed already
            return dst if dst is not None else self.tiles.flat.view(self.box[1])
        host = self.host()
        try:
            if self.device is not None:
                self.device.write(0, dst.numel(), None, "", self._into[1])
            elif isinstance(dst, torch.Tensor):
                with torch.no_grad():
                    dst.copy_(host.reshape(dst.shape))
            elif isinstance(dst, np.ndarray):
                if host.dtype == torch.bfloat16 and dst.dtype.name == "bfloat16":
                    # numpy has no bf16 of its own: the raw bits
                    np.copyto(dst.view(np.uint16), host.view(torch.uint16).numpy().reshape(dst.shape))
                else:
                    np.copyto(dst, host.numpy().reshape(dst.shape), casting="unsafe")
            else:
                return host
            return dst
        finally:
            if self._into is not None:
                self.device.release(self._into)
            self._host = self._into = None


def _emit_shard_reads(
    location: str,
    read_box: Box,
    byte_range: Optional[List[int]],
    expected_crc: Optional[int],
    dtype: str,
    itemsize: int,
    overlaps: List[Box],
    target: _BoxTarget,
    outer: _Countdown,
    budget: Optional[int],
) -> List[ReadReq]:
    """The read(s) of one saved-shard fetch.  ``read_box`` is a dim-0 row
    range of the saved shard, stored in C order, so a row range is a
    byte range: a fetch above ``budget`` splits into row tiles, each
    landing its part of the overlaps, with the tiles' crc32s folded back
    to the whole payload's when the fetch covers it.  One row above the
    budget reads a row at a time (the floor)."""
    total_bytes = box_nelems(read_box) * itemsize
    rows = read_box[1][0] if read_box[1] else 0
    if budget is None or total_bytes <= budget or rows <= 1:
        return [
            ReadReq(
                path=location,
                byte_range=byte_range,
                buffer_consumer=_ShardConsumer(read_box, dtype, overlaps, target, outer),
                expected_crc32=expected_crc,
            )
        ]
    row_bytes = total_bytes // rows
    base = byte_range[0] if byte_range else 0
    tiles = _plan_flat_tiles(0, rows, row_bytes, budget, base_byte=base)
    fold = _TileCrcFold(expected_crc, f"sharded payload {location}", outer.step)
    inner = _Countdown(len(tiles), fold.finish)
    reqs: List[ReadReq] = []
    for t0, t1, tile_byte_range in tiles:
        offsets, sizes = list(read_box[0]), list(read_box[1])
        offsets[0] += t0
        sizes[0] = t1 - t0
        tile_box = make_box(offsets, sizes)
        # a gap tile between disjoint overlaps still reads, so the fold
        # sees every payload byte; it lands nothing
        tile_overlaps = [sub for inter in overlaps if (sub := box_intersect(inter, tile_box)) is not None]
        reqs.append(
            ReadReq(
                path=location,
                byte_range=list(tile_byte_range),
                buffer_consumer=_ShardConsumer(tile_box, dtype, tile_overlaps, target, inner, fold, t0),
            )
        )
    return reqs


class _ShardConsumer(BufferConsumer):
    """Land one saved shard's bytes (or a row tile of them) in the local
    box: row ranges straight into its tile target when it is ``direct``,
    else scattered into its host assembly buffer."""

    def __init__(
        self,
        read_box: Box,
        dtype: str,
        overlaps: List[Box],
        target: _BoxTarget,
        countdown: _Countdown,
        crc_fold: Optional[_TileCrcFold] = None,
        crc_key: int = 0,
    ) -> None:
        self.read_box = read_box
        self.dtype = dtype
        self.overlaps = overlaps
        self.target = target
        self.countdown = countdown
        self.crc_fold = crc_fold
        self.crc_key = crc_key
        self._into: Any = None  # (buffer, pinned tensor) from the tile target

    def read_buffer(self, nbytes: int) -> Any:
        if self.target.tiles is None:
            return None
        self._into = self.target.tiles.read_buffer(nbytes)
        return None if self._into is None else self._into[0]

    def _land(self, buf: Any) -> None:
        if self.crc_fold is not None:  # one row tile of a budgeted fetch
            self.crc_fold.record(self.crc_key, buf)
            obs.counter(obs.TILES_READ).inc()
        into, self._into = self._into, None
        try:
            if self.target.tiles is not None:
                self._write_rows(buf, into[1] if into is not None and buf is into[0] else None)
                return
            src = tensor_from_buffer(buf, self.dtype, self.read_box[1])
            host, lbox = self.target.host(), self.target.box
            for inter in self.overlaps:
                host[relative_slices(inter, lbox)].copy_(src[relative_slices(inter, self.read_box)])
        finally:
            if into is not None:
                self.target.tiles.release(into)

    def _write_rows(self, buf: Any, pinned: Optional[torch.Tensor]) -> None:
        """Each overlap's rows are one byte range of ``buf`` and one flat
        element range of the local box (both span every dim but dim 0)."""
        rbox, lbox = self.read_box, self.target.box
        row_elems = box_nelems(rbox) // rbox[1][0]
        row_bytes = row_elems * string_to_dtype(self.dtype).itemsize
        view = memoryview(buf).cast("B")
        for inter in self.overlaps:
            b0 = (inter[0][0] - rbox[0][0]) * row_bytes
            b1 = b0 + inter[1][0] * row_bytes
            e0 = (inter[0][0] - lbox[0][0]) * row_elems
            self.target.tiles.write(
                e0, e0 + inter[1][0] * row_elems, view[b0:b1], self.dtype,
                None if pinned is None else pinned[b0:b1],
            )

    async def consume_buffer(self, buf: Any, executor: Optional[Executor] = None) -> None:
        if executor is not None:
            await asyncio.get_running_loop().run_in_executor(executor, self._land, buf)
        else:
            self._land(buf)
        self.countdown.step()

    def get_consuming_cost_bytes(self) -> int:
        return box_nelems(self.read_box) * string_to_dtype(self.dtype).itemsize
