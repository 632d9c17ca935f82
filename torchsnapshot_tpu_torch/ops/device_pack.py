"""Device-side slab pack (K1), unpack (K2) and tile update (K6) with their
plain versions.

Counterpart of ``torchsnapshot_tpu/ops/device_pack.py``, whose XLA
programs become hand-written CUDA kernels (``csrc/slab_pack.cu``,
``csrc/slab_unpack.cu``, ``csrc/tile_update.cu``):

- ``pack_slab`` gathers the bytes of many CUDA tensors into one uint8
  slab in one launch; ``pack_tensors_to_host`` follows it with one
  device-to-host copy into pinned memory (``transfer.to_host``).
- ``unpack_slab_into`` decodes every member of a device slab into its
  restore template in place (cast to the template dtype) in one launch;
  ``unpack_slab_to_device`` precedes it with one host-to-device copy
  (``transfer.to_device``).
- ``tile_update`` writes one device tile of the stored dtype into a
  range of a contiguous template in place, cast to its dtype (a budgeted
  ``read_object`` into a CUDA template, ``preparers/array.py``).

Each wrapper takes its plain PyTorch version only when the tensors it is
given lie on the CPU; for CUDA tensors it launches its kernel or raises.
``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..serialization import serialized_size_bytes, string_to_dtype
from . import kernels, transfer
from .transfer import ELEMENT_CODES, cast_supported

LAUNCHES = {"slab_pack": 0, "slab_unpack": 0, "tile_update": 0}
# pre-launch decisions: members copied to a contiguous buffer first
COUNTS = {"made_contiguous": 0}
_COUNT_LOCK = threading.Lock()

Member = Tuple[int, str, Tuple[int, ...]]  # (byte offset, dtype, shape)


def _bump(table: dict, key: str) -> None:
    with _COUNT_LOCK:
        table[key] += 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _upload_table(rows: List[tuple], device: torch.device) -> torch.Tensor:
    """The descriptor table as an int64 device tensor, uploaded on the
    current stream without blocking the host."""
    return transfer.upload(torch.tensor(rows, dtype=torch.int64), device)


# ------------------------------------------------------------------ K1


def pack_slab_plain(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of K1: every member's bytes, concatenated."""
    parts = [
        t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors
    ]
    if not parts:
        return torch.empty(0, dtype=torch.uint8)
    return torch.cat(parts)


def pack_plan(sizes: Sequence[int], chunk: int) -> Tuple[List[Tuple[int, int, int]], int, int]:
    """K1's plan for members of ``sizes`` bytes: per member (nbytes, slab
    offset, first chunk), the total chunk count and the slab's size.
    Block c of the launch copies bytes [(c - first) * chunk, + chunk) of
    the last member whose first chunk is <= c, cut at its end."""
    rows = []
    off = chunk_begin = 0
    for n in sizes:
        rows.append((n, off, chunk_begin))
        off += n
        chunk_begin += -(-n // chunk)
    return rows, chunk_begin, off


def descriptor_table(
    rows: Sequence[tuple], inline_max: int, device: torch.device
) -> Tuple[torch.Tensor, int]:
    """The int64 descriptor table and whether it lies on the device: a
    table of up to ``inline_max`` rows stays on the host (the launch
    copies it into the kernel's parameters), a longer one is uploaded."""
    if len(rows) <= inline_max:
        return torch.tensor(rows, dtype=torch.int64), 0
    return _upload_table(list(rows), device), 1


def pack_slab(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One uint8 slab holding each member's bytes back to back (on the
    members' device)."""
    devices = {t.device for t in tensors}
    if not tensors or devices == {torch.device("cpu")}:
        return pack_slab_plain(tensors)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"slab members must all lie on one CUDA device, got {devices}"
        )
    device = next(iter(devices))
    srcs = []
    for t in tensors:
        if not t.is_contiguous():
            _bump(COUNTS, "made_contiguous")
            t = t.contiguous()
        srcs.append(t.detach())
    lib = kernels.lib("slab_pack")
    plan, total_chunks, total = pack_plan(
        [_nbytes(t) for t in srcs], lib.tsnp_slab_pack_chunk_bytes()
    )
    slab = torch.empty(total, dtype=torch.uint8, device=device)
    if total_chunks == 0:
        return slab
    desc, on_device = descriptor_table(
        [(t.data_ptr(), *row) for t, row in zip(srcs, plan)],
        lib.tsnp_slab_pack_inline_members(), device,
    )
    # srcs/desc may be freed as soon as this returns: the caching
    # allocator reuses their memory only for work queued after this
    # launch on the same stream (a host table is copied by the call)
    rc = lib.tsnp_slab_pack(
        desc.data_ptr(), on_device, len(plan), total_chunks, slab.data_ptr(),
        _stream_ptr(device),
    )
    kernels.check(rc, "slab_pack")
    _bump(LAUNCHES, "slab_pack")
    return slab


def pack_tensors_to_host(
    tensors: Sequence[torch.Tensor], producer_stream: Optional[Any] = None
) -> np.ndarray:
    """K1 + one device-to-host copy into pinned memory, on a side copy
    stream ordered after ``producer_stream`` (default: the current one);
    returns the slab as a numpy view of the pinned buffer."""
    return transfer.to_host(tensors[0].device, producer_stream, lambda: pack_slab(tensors))


# ------------------------------------------------------------------ K2


def check_members_in_bounds(slab_nbytes: int, members: Sequence[Member]) -> None:
    """Every member's [off, off + nbytes) must lie inside the slab: a
    corrupt plan raises here, before any launch."""
    for off, dtype_str, shape in members:
        nbytes = serialized_size_bytes(shape, dtype_str)
        if off < 0 or off + nbytes > slab_nbytes:
            raise ValueError(
                f"member [{off}, {off + nbytes}) outside slab of {slab_nbytes}"
            )


def _decode_member(slab: torch.Tensor, off: int, dtype_str: str, shape) -> torch.Tensor:
    dt = string_to_dtype(dtype_str)
    piece = slab[off:off + serialized_size_bytes(shape, dtype_str)]
    if off % dt.itemsize:
        piece = piece.clone()  # reinterpreting needs element alignment
    return piece.view(dt).reshape(tuple(shape))


def unpack_slab_plain(
    slab: torch.Tensor,
    members: Sequence[Member],
    out_dtypes: Sequence[Optional[torch.dtype]],
) -> List[torch.Tensor]:
    """Plain version of K2: each member's bytes reinterpreted as its
    stored dtype and shape, then cast to ``out_dtypes[i]`` (None keeps
    the stored dtype)."""
    check_members_in_bounds(slab.numel(), members)
    out = []
    for (off, dtype_str, shape), out_dt in zip(members, out_dtypes):
        t = _decode_member(slab, off, dtype_str, shape)
        if out_dt is not None and out_dt != t.dtype:
            t = t.to(out_dt)
        out.append(t)
    return out


def unpack_slab_into(
    slab: torch.Tensor, members: Sequence[Member], outs: Sequence[torch.Tensor]
) -> None:
    """Decode each member of the uint8 ``slab`` INTO ``outs[i]`` (cast to
    its dtype), in place."""
    if len(members) != len(outs):
        raise ValueError(f"{len(members)} members but {len(outs)} outputs")
    check_members_in_bounds(slab.numel(), members)
    if slab.device.type == "cpu" and all(o.device.type == "cpu" for o in outs):
        decoded = unpack_slab_plain(slab, members, [None] * len(members))
        with torch.no_grad():
            for o, t in zip(outs, decoded):
                o.copy_(t.reshape(o.shape))
        return
    device = slab.device
    if device.type != "cuda":
        raise ValueError(f"slab on {device} but outputs on CUDA")
    rows = []
    chunk_begin = 0
    lib = kernels.lib("slab_unpack")
    chunk_bytes = lib.tsnp_slab_unpack_chunk_bytes()
    chunk_elems = lib.tsnp_slab_unpack_chunk_elems()
    for (off, dtype_str, shape), o in zip(members, outs):
        src_dt = string_to_dtype(dtype_str)
        numel = 1
        for s in shape:
            numel *= int(s)
        if o.device != device or not o.is_contiguous() or o.numel() != numel:
            raise ValueError(
                f"unpack output must be a contiguous tensor of {numel} "
                f"elements on {device}, got {tuple(o.shape)} on {o.device} "
                f"(contiguous={o.is_contiguous()})"
            )
        if not cast_supported(src_dt, o.dtype):
            raise ValueError(f"slab unpack does not cast {src_dt} → {o.dtype}")
        if src_dt == o.dtype:
            n = numel * src_dt.itemsize
            rows.append((off, o.data_ptr(), n, 0, 0, chunk_begin))
            chunk_begin += -(-n // chunk_bytes)
        else:
            rows.append(
                (off, o.data_ptr(), numel, ELEMENT_CODES[src_dt], ELEMENT_CODES[o.dtype],
                 chunk_begin)
            )
            chunk_begin += -(-numel // chunk_elems)
    if chunk_begin == 0:
        return
    desc = _upload_table(rows, device)
    rc = lib.tsnp_slab_unpack(
        desc.data_ptr(), len(rows), chunk_begin, slab.data_ptr(),
        _stream_ptr(device),
    )
    kernels.check(rc, "slab_unpack")
    _bump(LAUNCHES, "slab_unpack")


def unpack_slab_to_device(
    buf: Any, members: Sequence[Member], outs: Sequence[torch.Tensor],
    stream: Optional[Any] = None,
) -> None:
    """ONE host-to-device copy of the slab in ``buf`` and ONE K2 launch
    decoding every member into its CUDA template in place, on ``stream``
    (default: the current one).  Waits for the launch, so a fault
    surfaces in the restore that caused it.  A pinned uint8 tensor (a
    claimed read buffer of the consumer's) is copied by one asynchronous
    DMA.  A mapped slab (private, writable) is copied to the card straight
    from its pages; only a read-only buffer is copied on the host first."""
    pinned = isinstance(buf, torch.Tensor)
    if pinned:
        check_members_in_bounds(buf.numel(), members)
        host = buf
    else:
        view = memoryview(buf).cast("B")
        check_members_in_bounds(view.nbytes, members)
        if view.readonly:
            view = memoryview(bytearray(view))
        host = torch.frombuffer(view, dtype=torch.uint8) if view.nbytes else (
            torch.empty(0, dtype=torch.uint8)
        )
    device = outs[0].device
    if stream is None:
        stream = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        slab = torch.empty(host.numel(), dtype=torch.uint8, device=device)
    transfer.to_device(
        slab, host, stream, then=lambda: unpack_slab_into(slab, members, outs), pinned=pinned
    )


# ------------------------------------------------------------------ K6


def tile_update_plain(dst: torch.Tensor, off: int, tile: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: ``dst.view(-1)[off:off + n] = tile`` cast to
    ``dst``'s dtype (the cast made first, then the slice assigned)."""
    with torch.no_grad():
        dst.view(-1)[off:off + tile.numel()] = tile.reshape(-1).to(dst.dtype)
    return dst


def tile_update(dst: torch.Tensor, off: int, tile: torch.Tensor) -> torch.Tensor:
    """Write the contiguous ``tile`` (its elements in order) INTO elements
    [off, off + n) of the contiguous ``dst``, cast to ``dst``'s dtype, in
    place; returns ``dst``.  A CUDA ``dst`` takes one K6 launch on the
    current stream, with a 64-bit offset."""
    n = tile.numel()
    if not dst.is_contiguous() or not tile.is_contiguous():
        raise ValueError("tile update needs a contiguous template and tile")
    if off < 0 or off + n > dst.numel():
        raise ValueError(
            f"tile [{off}, {off + n}) outside a template of {dst.numel()} elements"
        )
    if dst.device.type == "cpu" and tile.device.type == "cpu":
        return tile_update_plain(dst, off, tile)
    if dst.device.type != "cuda" or tile.device != dst.device:
        raise ValueError(
            f"tile on {tile.device}, template on {dst.device}: both must lie "
            "on one CUDA device"
        )
    if not cast_supported(tile.dtype, dst.dtype):
        raise ValueError(f"tile update does not cast {tile.dtype} → {dst.dtype}")
    if n == 0:
        return dst
    lib = kernels.lib("tile_update")
    if tile.dtype == dst.dtype:
        size = tile.element_size()
        args = (off * size, n * size, 0, 0)
    else:
        args = (off, n, ELEMENT_CODES[tile.dtype], ELEMENT_CODES[dst.dtype])
    rc = lib.tsnp_tile_update(
        tile.data_ptr(), dst.data_ptr(), *args, _stream_ptr(dst.device)
    )
    kernels.check(rc, "tile_update")
    _bump(LAUNCHES, "tile_update")
    return dst
