"""The PyTorch port writes the JAX package's on-disk format byte for byte:
dtype strings, safe-object (msgpack) payloads, the metadata self-crc
trailer, crc32/adler32 digests and the manifest JSON.  Inputs come from a
seeded numpy generator; every comparison here is exact (bytes or ints)."""

import collections
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu import serialization as jser
from torchsnapshot_tpu.manifest import _META_CRC_MARKER as JAX_MARKER
from torchsnapshot_tpu.utils import checksums as jck
from torchsnapshot_tpu.utils import selfcrc as jselfcrc
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import serialization as tser
from torchsnapshot_tpu_torch.manifest import _META_CRC_MARKER as TORCH_MARKER
from torchsnapshot_tpu_torch.utils import checksums as tck
from torchsnapshot_tpu_torch.utils import selfcrc as tselfcrc

# manifest dtype string → (torch dtype, numpy/ml_dtypes dtype)
DTYPES = {
    "float16": (torch.float16, np.float16),
    "float32": (torch.float32, np.float32),
    "float64": (torch.float64, np.float64),
    "int8": (torch.int8, np.int8),
    "int16": (torch.int16, np.int16),
    "int32": (torch.int32, np.int32),
    "int64": (torch.int64, np.int64),
    "uint8": (torch.uint8, np.uint8),
    "uint16": (torch.uint16, np.uint16),
    "uint32": (torch.uint32, np.uint32),
    "uint64": (torch.uint64, np.uint64),
    "bool": (torch.bool, np.bool_),
    "complex64": (torch.complex64, np.complex64),
    "complex128": (torch.complex128, np.complex128),
    "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
    "float8_e4m3fn": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
    "float8_e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2),
    "float8_e4m3fnuz": (torch.float8_e4m3fnuz, ml_dtypes.float8_e4m3fnuz),
}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_dtype_strings_match(name):
    tdt, ndt = DTYPES[name]
    assert tser.dtype_to_string(tdt) == name
    assert jser.dtype_to_string(np.dtype(ndt)) == name
    assert tser.string_to_dtype(name) == tdt
    assert tser.dtype_itemsize(name) == np.dtype(ndt).itemsize


@pytest.mark.parametrize("name", ["int4", "uint4"])
def test_sub_byte_dtypes_refused_by_name(name):
    with pytest.raises(ValueError, match=name):
        tser.string_to_dtype(name)
    with pytest.raises(ValueError, match="int4/uint4"):
        tser.dtype_to_string(np.dtype(getattr(ml_dtypes, name)))


def _corpus():
    rng = np.random.default_rng(0)
    od = collections.OrderedDict([("b", 1), ("a", 2)])
    return {
        "none": None,
        "bools": [True, False],
        "small_ints": [0, 1, 127, 128, 255, 256, -1, -32, -33, -128, -129],
        "wide_ints": [2**16, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1,
                      -(2**31), -(2**31) - 1, -(2**63)],
        "bigints": [2**64, -(2**63) - 1, 10**40, -(10**40)],
        "floats": [0.0, -0.0, 1.5, float("inf"), -1e300, float(rng.standard_normal())],
        "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "ünï©ødé"],
        "bytes": [b"", b"x" * 255, b"y" * 256, bytes(rng.integers(0, 256, 70000, dtype=np.uint8))],
        "long_list": list(range(20)),
        "big_map": {f"k{i}": i for i in range(20)},
        "tuples": (1, (2, 3), ()),
        "sets": [{3, 1, 2}, frozenset({"b", "a"}), set()],
        "complex": [1 + 2j, complex(-0.5, 3.25)],
        "nonstr_keys": {1: "a", (2, 3): "b", None: 4, 2.5: [1]},
        "ordered_dict": od,
        "np_scalars": [np.float32(1.25), np.int64(-7), np.uint8(200), np.bool_(True),
                       np.complex64(1 - 1j), np.float64(rng.standard_normal())],
        "np_arrays": [
            rng.standard_normal((3, 4)).astype(np.float32),
            rng.integers(-5, 5, (2, 3, 2)).astype(np.int16),
            np.array([True, False, True]),
            np.zeros((0, 3), np.float64),
            np.array(3.5),
            (rng.standard_normal(4) + 1j * rng.standard_normal(4)).astype(np.complex128),
        ],
        "ext_lengths": [b"z" * n for n in (1, 2, 3, 4, 8, 16, 17)],
        "nested": {"layer": [{"w": np.arange(4, dtype=np.int32), "t": (1.5, "x")}],
                   "opt": {"step": 3, "betas": (0.9, 0.999)}},
    }


CORPUS = _corpus()


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_safe_object_bytes_equal(name):
    obj = CORPUS[name]
    jbytes, jtag = jser.serialize_object(obj)
    tbytes, ttag = tser.serialize_object(obj)
    assert jtag == ttag == "safe_object"
    assert tbytes == jbytes


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, np.generic):
        return type(a) is type(b) and a.tobytes() == b.tobytes()
    if isinstance(a, dict):
        return type(a) is type(b) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_safe_object_decodes_jax_payload(name):
    obj = CORPUS[name]
    payload, tag = jser.serialize_object(obj)
    decoded = tser.deserialize_object(payload, tag)
    assert _same(decoded, jser.deserialize_object(payload, tag))


def test_safe_object_extension_dtype_array_decodes_as_tensor():
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16)
    payload, tag = jser.serialize_object(arr)
    t = tser.deserialize_object(payload, tag)
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (2, 3)
    assert t.view(torch.uint16).numpy().tobytes() == arr.tobytes()


class Opaque:
    """Not encodable by the safe codec."""


def test_pickle_fallback_tags_and_knob():
    with tknobs.override_allow_pickle_objects(True), jknobs.override_allow_pickle_objects(True):
        payload, tag = tser.serialize_object(Opaque)
        assert tag == jser.serialize_object(Opaque)[1] == "pickle"
    with tknobs.override_allow_pickle_objects(False):
        with pytest.raises(TypeError):
            tser.serialize_object(Opaque)
        with pytest.raises(RuntimeError):
            tser.deserialize_object(payload, tag)


@pytest.mark.parametrize("body", ['{"a": 1}', "", '{"x": "\\n#"}'])
def test_selfcrc_trailer_matches(body):
    assert TORCH_MARKER == JAX_MARKER
    t = tselfcrc.append_crc_trailer(body, TORCH_MARKER)
    assert t == jselfcrc.append_crc_trailer(body, JAX_MARKER)
    assert tselfcrc.strip_crc_trailer(t, TORCH_MARKER, "m", "f") == (body, True)
    flipped = t[:-1] + ("0" if t[-1] != "0" else "1")
    with pytest.raises(RuntimeError):
        tselfcrc.strip_crc_trailer(flipped, TORCH_MARKER, "m", "f")


@pytest.mark.parametrize("n_pieces", [1, 2, 7])
def test_digests_and_combination_match(n_pieces):
    rng = np.random.default_rng(n_pieces)
    pieces = [
        rng.integers(0, 256, int(rng.integers(0, 5000)), dtype=np.uint8).tobytes()
        for _ in range(n_pieces)
    ]
    whole = b"".join(pieces)
    digests = [(tck.crc32_fast(p), tck.adler32_fast(p), len(p)) for p in pieces]
    assert digests == [(jck.crc32_fast(p), jck.adler32_fast(p), len(p)) for p in pieces]
    folded = tck.combine_piece_digests(digests)
    assert folded == jck.combine_piece_digests(digests)
    assert folded == (zlib.crc32(whole), zlib.adler32(whole), len(whole))


def _manifest_state(rng):
    f32 = rng.standard_normal((4, 5)).astype(np.float32)
    bf16 = rng.standard_normal((3, 7)).astype(ml_dtypes.bfloat16)
    i64 = rng.integers(-100, 100, (6,)).astype(np.int64)
    flag = rng.random(9) > 0.5
    c64 = (rng.standard_normal(3) + 1j * rng.standard_normal(3)).astype(np.complex64)
    scalar = np.array(2.5, np.float32)
    empty = np.zeros((0, 4), np.float32)
    big = rng.standard_normal((64, 8)).astype(np.float32)  # over the chunk size
    host = {"f32": f32, "bf16": bf16, "i64": i64, "flag": flag, "c64": c64,
            "scalar": scalar, "empty": empty, "big": big}
    rest = {"step": 3, "lr": 0.5, "name": "run", "tags": {2, 1},
            "nested": {"betas": (0.9, 0.999), "hist": [1.5, 2.5]}}
    return host, rest


def _to_torch(a):
    return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16 \
        else torch.from_numpy(a)


@pytest.mark.parametrize("replicated", [(), ("app/**",)], ids=["per_rank", "replicated"])
@pytest.mark.parametrize("batching", [True, False], ids=["slabs", "no_slabs"])
def test_manifest_json_byte_equal(tmp_path, batching, replicated):
    """The same state taken by both packages renders the same metadata
    document: entries, slab layout, chunking, crc32s and object digests
    (replicated leaves included: namespace, chunked entries kept out of
    slabs)."""
    import torchsnapshot_tpu as jts
    import torchsnapshot_tpu_torch as tts

    host, rest = _manifest_state(np.random.default_rng(3))
    jstate = jts.StateDict({**host, **rest})
    tstate = tts.StateDict({**{k: _to_torch(v) for k, v in host.items()}, **rest})
    with jknobs.override_max_chunk_size_bytes(1024), \
            tknobs.override_max_chunk_size_bytes(1024), \
            jknobs.override_slab_size_threshold_bytes(200), \
            tknobs.override_slab_size_threshold_bytes(200), \
            jknobs.override_disable_batching(not batching), \
            tknobs.override_disable_batching(not batching):
        jsnap = jts.Snapshot.take(str(tmp_path / "jax"), {"app": jstate}, replicated=replicated)
        tsnap = tts.Snapshot.take(str(tmp_path / "torch"), {"app": tstate}, replicated=replicated)
    jdoc = jts.Snapshot(str(tmp_path / "jax")).metadata.to_json()
    tdoc = tts.Snapshot(str(tmp_path / "torch")).metadata.to_json()
    assert tdoc == jdoc
    assert tsnap.metadata.to_json() == jsnap.metadata.to_json()
    assert ("batched" in tdoc) == batching
    assert ("replicated/app" in tdoc) == bool(replicated)
    meta = (tmp_path / "torch" / ".snapshot_metadata").read_bytes()
    assert meta == (tmp_path / "jax" / ".snapshot_metadata").read_bytes()
