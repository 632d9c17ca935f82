"""The port's ``verify_snapshot`` against the JAX package's on the same
snapshot: the ``VerifyResult`` field for field, shallow and deep, on an
intact snapshot and on one with an object missing, truncated, corrupt
(one flipped byte) or degraded; an encoded snapshot is verified by the
JAX package and refused by the port with its typed error.

``unreadable`` carries each package's own exception text, so it is
compared by the paths it names; every other field exactly.
"""

import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu_torch import knobs as tknobs

_FIELDS = ("objects_checked", "entries_checked", "missing", "truncated", "corrupt", "degraded", "ok", "complete")


def _fields(res):
    d = {f: getattr(res, f) for f in _FIELDS}
    d = {k: [tuple(x) if isinstance(x, (list, tuple)) else x for x in v] if isinstance(v, list) else v
         for k, v in d.items()}
    d["unreadable"] = sorted(p for p, _ in res.unreadable)
    d["str_head"] = str(res).split("unreadable=")[0]
    return d


def _take(pkg, path, seed):
    rng = np.random.default_rng(seed)
    arrays = {
        "w": rng.standard_normal((32, 16)).astype(np.float32),
        "v": rng.integers(-1000, 1000, (300,)).astype(np.int64),
        "small": rng.standard_normal(8).astype(np.float32),
    }
    if pkg == "port":
        tts.Snapshot.take(path, {"app": tts.StateDict(step=3, **{k: torch.from_numpy(v) for k, v in arrays.items()})})
    else:
        jts.Snapshot.take(path, {"app": jts.StateDict(step=3, **arrays)})


def _damage(path, case):
    md_path = os.path.join(path, ".snapshot_metadata")
    md = jts.Snapshot(path).metadata
    loc = md.manifest["0/app/w"].location
    full = os.path.join(path, loc)
    if case == "missing":
        os.remove(full)
    elif case == "truncated":
        with open(full, "r+b") as f:
            f.truncate(os.path.getsize(full) - 7)
    elif case == "corrupt":
        with open(full, "r+b") as f:
            f.seek(5)
            b = f.read(1)
            f.seek(5)
            f.write(bytes([b[0] ^ 0xFF]))
    elif case == "degraded":
        md.degraded = {"app/v": {"origin_rank": 0, "kind": "Array"}}
        with open(md_path, "w") as f:
            f.write(md.to_yaml())


@pytest.mark.parametrize("taker", ["port", "jax"])
@pytest.mark.parametrize("case", ["intact", "missing", "truncated", "corrupt", "degraded"])
def test_verify_result_equals_jax(tmp_path, taker, case):
    path = str(tmp_path / "s")
    with jknobs.override_disable_batching(True), tknobs.override_disable_batching(True):
        _take(taker, path, seed=1)
    _damage(path, case)
    for deep in (False, True):
        got = tts.verify_snapshot(path, deep=deep)
        want = jts.verify_snapshot(jts.Snapshot(path), deep=deep)
        assert _fields(got) == _fields(want), (deep, str(got), str(want))
        assert got.ok == (case in ("intact", "degraded") or (case == "corrupt" and not deep))
        assert got.complete == (case == "intact" or (case == "corrupt" and not deep))
        if case == "corrupt" and deep:
            assert [c[0] for c in got.corrupt] == [jts.Snapshot(path).metadata.manifest["0/app/w"].location]
    # the same through Snapshot.verify
    assert _fields(tts.Snapshot(path).verify(deep=True)) == _fields(jts.Snapshot(path).verify(deep=True))


def test_verify_of_a_slabbed_snapshot_equals_jax(tmp_path):
    """Members of one slab: extents are the largest byte_range end, each
    member's crc32 covers its range."""
    path = str(tmp_path / "s")
    _take("port", path, seed=2)
    assert any("batched" in loc for loc in jts.Snapshot(path).metadata.objects)
    for deep in (False, True):
        assert _fields(tts.verify_snapshot(path, deep=deep)) == _fields(jts.verify_snapshot(path, deep=deep))


@pytest.mark.parametrize("encoding", ["codec", "cas"])
def test_encoded_snapshot_raises_the_typed_error(tmp_path, encoding):
    w = np.random.default_rng(7).standard_normal(1 << 22).astype(np.float32)  # 16 MiB
    path = str(tmp_path / "run" / "s")
    if encoding == "codec":
        with jknobs.override_codec("zlib"), jknobs.override_stripe_min_object_size_bytes(4 << 20):
            jts.Snapshot.take(path, {"m": jts.StateDict(w=w)})
        table = "codec frame table"
    else:
        jts.Snapshot.take(path, {"m": jts.StateDict(w=w)}, cas=True)
        table = "CAS chunk table"
    assert jts.verify_snapshot(path, deep=True).ok
    for deep in (False, True):
        with pytest.raises(tts.EncodedPayloadError, match=table):
            tts.verify_snapshot(path, deep=deep)


def test_verify_result_text_and_raise(tmp_path):
    path = str(tmp_path / "s")
    _take("port", path, seed=3)
    res = tts.verify_snapshot(path)
    assert str(res) == str(jts.verify_snapshot(path))
    res.raise_if_failed()
    _damage(path, "missing")
    bad = tts.verify_snapshot(path)
    assert str(bad) == str(jts.verify_snapshot(path)) and str(bad).startswith("FAILED missing=")
    with pytest.raises(RuntimeError, match="verification failed"):
        bad.raise_if_failed()
    # the objects table's exact sizes: a file grown by one byte is caught
    path2 = str(tmp_path / "s2")
    _take("port", path2, seed=4)
    loc = next(iter(tts.Snapshot(path2).metadata.objects))
    with open(os.path.join(path2, loc), "ab") as f:
        f.write(b"\0")
    grown = tts.verify_snapshot(path2)
    assert _fields(grown) == _fields(jts.verify_snapshot(path2))
    assert [t[0] for t in grown.truncated] == [loc]
