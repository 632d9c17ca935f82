"""The plain versions of the slab pack (K1) and unpack (K2) kernels
against the JAX package's device pack/unpack, bitwise, over every dtype
of the shared table.  On CPU tensors the port's wrappers take the plain
versions; the kernels themselves are held against them on the card
(chip_smoke.py, tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchsnapshot_tpu.ops.device_pack import (
    pack_arrays_to_host,
    unpack_slab_to_device,
)
from torchsnapshot_tpu_torch.ops import device_pack as tdp
from torchsnapshot_tpu_torch.serialization import string_to_dtype, tensor_from_buffer

NP_DTYPES = {
    "float16": np.float16, "float32": np.float32, "float64": np.float64,
    "int8": np.int8, "int16": np.int16, "int32": np.int32, "int64": np.int64,
    "uint8": np.uint8, "uint16": np.uint16, "uint32": np.uint32,
    "uint64": np.uint64, "bool": np.bool_, "complex64": np.complex64,
    "complex128": np.complex128, "bfloat16": ml_dtypes.bfloat16,
    "float8_e4m3fn": ml_dtypes.float8_e4m3fn,
    "float8_e5m2": ml_dtypes.float8_e5m2,
    "float8_e4m3fnuz": ml_dtypes.float8_e4m3fnuz,
}


def _array(name, shape, rng):
    dt = np.dtype(NP_DTYPES[name])
    if name == "bool":
        return rng.random(shape) > 0.5
    if name.startswith(("float", "bfloat", "complex")):
        # finite values: NaN payloads are not what the pack is about
        vals = rng.standard_normal(shape) * 4
        if name.startswith("complex"):
            vals = vals + 1j * rng.standard_normal(shape)
        return vals.astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


def _tensor(a):
    """A torch tensor over the same bytes as numpy/ml_dtypes array ``a``."""
    name = str(a.dtype) if a.dtype != np.bool_ else "bool"
    return tensor_from_buffer(bytearray(a.tobytes()), name, a.shape)


def _host_bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _layout(kind, name, rng):
    """Slab members of dtype ``name``: after a 3-byte bool, so every later
    member sits at an odd offset ("odd_offset"), or interleaved with
    4-byte f32 scalars (the ``step`` a fused AdamW keeps on the card) and
    a 4099-byte bool, so the members' offsets move mod 16 ("interleaved")."""
    if kind == "odd_offset":
        return [_array("bool", (3,), rng), _array(name, (5, 3), rng),
                _array(name, (), rng), _array(name, (0, 2), rng),
                _array("float32", (4,), rng)]
    return [_array(name, (5, 3), rng), _array("float32", (), rng),
            _array(name, (33,), rng), _array("float32", (), rng),
            _array("bool", (4099,), rng), _array(name, (7, 2), rng),
            _array("float32", (), rng), _array(name, (), rng)]


# the odd-offset cases keep the bare dtype as their id
LAYOUT_CASES = [pytest.param(n, "odd_offset", id=n) for n in sorted(NP_DTYPES)] + [
    pytest.param(n, "interleaved", id=f"interleaved-{n}") for n in sorted(NP_DTYPES)
]


@pytest.mark.parametrize("name,layout", LAYOUT_CASES)
def test_pack_matches_jax_bitwise(name, layout):
    rng = np.random.default_rng(len(name))
    arrays = _layout(layout, name, rng)
    with jax.enable_x64(True):
        want = pack_arrays_to_host([jnp.asarray(a) for a in arrays])
    got = tdp.pack_slab([_tensor(a) for a in arrays])
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_pack_non_contiguous_member():
    rng = np.random.default_rng(0)
    a = _array("float32", (4, 6), rng)
    t = _tensor(a).t()  # a transposed view
    assert not t.is_contiguous()
    with jax.enable_x64(True):
        want = pack_arrays_to_host([jnp.asarray(np.ascontiguousarray(a.T))])
    assert tdp.pack_slab([t]).numpy().tobytes() == np.asarray(want).tobytes()


def _members(arrays):
    members, off = [], 0
    for a in arrays:
        name = str(a.dtype) if a.dtype != np.bool_ else "bool"
        members.append((off, name, tuple(a.shape)))
        off += a.nbytes
    return tuple(members)


@pytest.mark.parametrize("name,layout", LAYOUT_CASES)
def test_unpack_matches_jax_bitwise(name, layout):
    rng = np.random.default_rng(100 + len(name))
    arrays = _layout(layout, name, rng) + [_array("int16", (7,), rng)]
    slab = b"".join(a.tobytes() for a in arrays)
    members = _members(arrays)
    with jax.enable_x64(True):
        want = unpack_slab_to_device(
            np.frombuffer(slab, np.uint8), members, (None,) * len(members),
            jax.devices("cpu")[0],
        )
        want = [np.asarray(w) for w in want]
    slab_t = torch.frombuffer(bytearray(slab), dtype=torch.uint8)
    got = tdp.unpack_slab_plain(slab_t, members, [None] * len(members))
    outs = [torch.empty(g.shape, dtype=g.dtype) for g in got]
    tdp.unpack_slab_into(slab_t, members, outs)
    for g, o, w, a in zip(got, outs, want, arrays):
        assert _host_bytes(g) == w.tobytes() == a.tobytes()
        assert _host_bytes(o) == w.tobytes()


@pytest.mark.parametrize(
    "src,dst",
    [("bfloat16", "float32"), ("float32", "bfloat16"), ("float32", "float16"),
     ("float16", "float64"), ("int32", "int64"), ("int64", "int8"),
     ("uint8", "int32")],
)
def test_unpack_cast_member_matches_jax(src, dst):
    rng = np.random.default_rng(7)
    arrays = [_array("bool", (1,), rng), _array(src, (6, 2), rng)]
    slab = b"".join(a.tobytes() for a in arrays)
    members = _members(arrays)
    out_np = (None, np.dtype(NP_DTYPES[dst]))
    with jax.enable_x64(True):
        want = unpack_slab_to_device(
            np.frombuffer(slab, np.uint8), members, out_np, jax.devices("cpu")[0]
        )
        want = np.asarray(want[1])
    slab_t = torch.frombuffer(bytearray(slab), dtype=torch.uint8)
    out_dt = string_to_dtype(dst)
    got = tdp.unpack_slab_plain(slab_t, members, [None, out_dt])[1]
    into = torch.empty((6, 2), dtype=out_dt)
    tdp.unpack_slab_into(slab_t, members, [torch.empty(1, dtype=torch.bool), into])
    assert got.dtype == out_dt
    assert _host_bytes(got) == want.tobytes()
    assert _host_bytes(into) == want.tobytes()
    assert tdp.cast_supported(string_to_dtype(src), out_dt)


def test_cast_pairs_outside_the_kernel_are_refused():
    assert not tdp.cast_supported(torch.float32, torch.int32)
    assert not tdp.cast_supported(torch.bool, torch.uint8)
    assert not tdp.cast_supported(torch.complex64, torch.complex128)
    assert tdp.cast_supported(torch.complex64, torch.complex64)


@pytest.mark.parametrize("off", [-1, 13, 40])
def test_unpack_out_of_bounds_member_raises(off):
    slab = np.zeros(48, np.uint8)
    members = ((off, "float32", (3, 3)),)  # 36 bytes
    with pytest.raises(ValueError, match="outside slab"):
        tdp.unpack_slab_plain(torch.from_numpy(slab), members, [None])
    with pytest.raises(ValueError, match="outside slab"):
        tdp.unpack_slab_to_device(slab, members, [torch.empty((3, 3))])
    with pytest.raises(ValueError, match="outside slab"):
        unpack_slab_to_device(slab, members, (None,), jax.devices("cpu")[0])


def test_sub_byte_members_are_refused():
    slab = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="int4"):
        tdp.unpack_slab_plain(slab, ((0, "int4", (4,)),), [None])


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    before = dict(tdp.LAUNCHES)
    tdp.pack_slab([torch.ones(3), torch.zeros(2, dtype=torch.int8)])
    slab = torch.zeros(16, dtype=torch.uint8)
    tdp.unpack_slab_into(slab, ((0, "float32", (4,)),), [torch.empty(4)])
    assert tdp.LAUNCHES == before  # no kernel launched for CPU tensors
    with pytest.raises(ValueError):
        tdp.unpack_slab_into(
            slab, ((0, "float32", (4,)),), [torch.empty(4, device="meta")]
        )


@pytest.mark.parametrize("chunk", [16, 4096, 32768])
def test_pack_plan_covers_every_slab_byte_once(chunk):
    """K1's plan, walked as its blocks walk it (block c copies a chunk of
    the last member whose first chunk is <= c), writes every slab byte
    exactly once, at the offsets ``pack_slab_plain`` gives, and takes
    more than one chunk for the members larger than a chunk."""
    rng = np.random.default_rng(chunk)
    sizes = [0, 1, 3, 4, chunk - 1, chunk, chunk + 1, 0, 65537, 15, 2 * chunk + 5, 0]
    members = [torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)) for n in sizes]
    rows, total_chunks, total = tdp.pack_plan(sizes, chunk)
    assert total == sum(sizes)
    assert total_chunks == sum(-(-n // chunk) for n in sizes)
    starts = [r[2] for r in rows]
    slab = torch.zeros(total, dtype=torch.uint8)
    hits = np.zeros(total, np.int64)
    for c in range(total_chunks):
        i = max(j for j, b in enumerate(starts) if b <= c)
        n, off, first = rows[i]
        lo = (c - first) * chunk
        hi = min(n, lo + chunk)
        assert 0 <= lo < hi
        slab[off + lo:off + hi] = members[i][lo:hi]
        hits[off + lo:off + hi] += 1
    assert (hits == 1).all()
    assert torch.equal(slab, tdp.pack_slab_plain(members))
    for n, (nbytes, off, first), nxt in zip(sizes, rows, starts[1:] + [total_chunks]):
        assert nbytes == n and nxt - first == -(-n // chunk)


def test_short_descriptor_tables_stay_on_the_host():
    """A table the launch can carry in its parameters is not uploaded."""
    rows = [(i, 2 * i, 3 * i, 4 * i) for i in range(5)]
    table, on_device = tdp.descriptor_table(rows, 5, torch.device("cpu"))
    assert on_device == 0 and table.device.type == "cpu"
    assert table.dtype == torch.int64 and table.tolist() == [list(r) for r in rows]
