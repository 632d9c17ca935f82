"""The port's content-addressed chunk store (``cas/``) against the JAX
package's, and CAS snapshots across the two packages.

Units: chunk keys, ``validate_table`` and ``diff_tables`` (hypothesis
over sizes and chunk sizes), ``record_root``/``resolve_root``.  Interop
(fs, 64 KiB chunks, streaming at a 128 KiB threshold): the same seeded
state taken with ``cas=True`` by either package lays down the same chunk
files and an equal ``metadata.cas``; either package restores the
other's CAS snapshot bitwise, also through budgeted ``read_object``
tiles that straddle chunks, ``materialize`` and deep ``verify``; a
corrupt chunk fails deep verify and a ``VERIFY_ON_RESTORE`` restore in
both; two ranks merge their chunk tables at commit.  Comparisons are
exact.
"""

import contextlib
import filecmp
import logging
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import cas as jcas
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu_torch import cas as tcas
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import obs as tobs
from torchsnapshot_tpu_torch.test_utils import run_multiprocess

CHUNK = 64 << 10
MIN = 128 << 10


@settings(max_examples=60, deadline=None)
@given(
    size=st.integers(0, 5000),
    chunk=st.integers(1, 700),
    seed=st.integers(0, 2**32 - 1),
    mutate=st.integers(0, 4),
)
def test_chunk_keys_tables_and_diffs_match_jax(size, chunk, seed, mutate):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size, dtype=np.uint8)
    spans = tcas.store.plan_parts(size, chunk)
    keys = []
    for lo, hi in spans:
        d = tcas.store._digest_piece(data[lo:hi])
        assert d == jcas.store._digest_piece(data[lo:hi])
        key = tcas.chunk_key(d)
        assert key == jcas.chunk_key(d) and tcas.key_size(key) == jcas.key_size(key) == hi - lo
        assert tcas.chunk_location(key) == jcas.chunk_location(key)
        keys.append(key)
    table = tcas.make_table(chunk, size, keys)
    assert table == jcas.make_table(chunk, size, keys)
    # structural damage of every kind is judged alike
    bad = [
        table,
        {**table, "keys": keys[:-1]},
        {**table, "size": size + 1},
        {**table, "chunk_size": 0},
        {**table, "keys": [k[:-1] + "x" for k in keys]},
        {"chunk_size": chunk},
        "not a table",
    ]
    for t in bad:
        assert tcas.validate_table(t) == jcas.validate_table(t)
    assert tcas.validate_table(table)
    # a mutated copy: changed and reused chunk positions
    other = data.copy()
    if size:
        other[rng.integers(0, size, mutate)] ^= 0xFF
    okeys = [tcas.chunk_key(tcas.store._digest_piece(other[lo:hi])) for lo, hi in spans]
    new = tcas.make_table(chunk, size, okeys)
    for old in (table, None, {**table, "chunk_size": chunk + 1}):
        assert tcas.diff_tables(old, new) == jcas.store.diff_tables(old, new)


def test_record_and_resolve_root_match_jax():
    cases = [
        ("/ckpt/run/step_1", "/ckpt/run/cas"),
        ("/ckpt/run/step_1/", "/ckpt/run/cas/"),
        ("/ckpt/run/step_1", "/elsewhere/pool"),
        ("/ckpt/run/step_1", "/ckpt/run/a/b"),
        ("step_1", "cas"),
        ("fs:///ckpt/run/s", "fs:///ckpt/run/pool"),
        ("memory://bucket/s", "memory://bucket/cas"),
    ]
    for snap, root in cases:
        rec = tcas.record_root(snap, root)
        assert rec == jcas.record_root(snap, root), (snap, root)
        assert tcas.resolve_root(snap, rec) == jcas.resolve_root(snap, rec)
    assert tcas.record_root("/a/b/s", "/a/b/cas") == "../cas"
    assert tcas.resolve_root("/a/b/s", "../cas") == "/a/b/cas"
    for ref in ("fs:///a/b/", "/a/b", "/a/b//"):
        assert tcas.norm_ref(ref) == jcas.norm_ref(ref)


def _state(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(90001).astype(np.float32)  # 360 KiB: streamed, ragged last chunk
    return {
        "w": w,
        "tied": w.copy(),  # the same content: written once
        "h": rng.standard_normal(40000).astype(np.float16),
        "i": rng.integers(-99, 99, 3300).astype(np.int64),
        "z": np.zeros(50000, np.float32),
        "s": np.ones(10, np.float32),
    }


@contextlib.contextmanager
def _knobs(batching=False):
    with contextlib.ExitStack() as stack:
        for k in (tknobs, jknobs):
            stack.enter_context(k.override_cas_chunk_size_bytes(CHUNK))
            stack.enter_context(k.override_stripe_part_size_bytes(CHUNK))
            stack.enter_context(k.override_stripe_min_object_size_bytes(MIN))
            stack.enter_context(k.override_disable_batching(not batching))
        yield


def _port_take(path, state, asynchronous=False, **kw):
    app = {"app": tts.StateDict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})}
    if asynchronous:
        return tts.Snapshot.async_take(path, app, **kw).wait()
    return tts.Snapshot.take(path, app, **kw)


def _port_restored(path, state):
    dest = tts.StateDict({k: torch.zeros(v.shape, dtype=torch.from_numpy(np.array(v)).dtype) for k, v in state.items()})
    tts.Snapshot(path).restore({"app": dest}, device="cpu")
    return {k: t.numpy() for k, t in dest.items()}


def _jax_restored(path, state):
    dest = jts.StateDict({k: np.zeros_like(v) for k, v in state.items()})
    jts.Snapshot(path).restore({"app": dest})
    return dict(dest)


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


def _pool_files(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "objects")):
        for f in files:
            out[os.path.relpath(os.path.join(dirpath, f), root)] = os.path.join(dirpath, f)
    return out


def _fields(res):
    return (res.ok, res.complete, res.objects_checked, res.entries_checked, sorted(res.missing),
            sorted(res.truncated), sorted(p for p, _ in res.unreadable), sorted(res.corrupt))


@pytest.mark.parametrize("batching", [True, False])
@pytest.mark.parametrize("mode", ["take", "async_take"])
def test_port_and_jax_takes_lay_down_the_same_chunks(tmp_path, batching, mode):
    """Whole-staged (slabs) and chunk-streamed writes: the same chunk
    keys, files and ``metadata.cas``; each package loads and self-checks
    the other's ``index.json``; the tied copy is written once."""
    state = _state(3)
    port, jax = str(tmp_path / "port" / "s"), str(tmp_path / "jax" / "s")
    c0 = dict(tobs.counters())
    with _knobs(batching):
        with tknobs.override_trace(1):
            tobs.get_tracer().reset()
            _port_take(port, state, asynchronous=mode == "async_take", cas=True)
            names = [sp.name for sp in tobs.get_tracer().spans()]
        jts.Snapshot.take(jax, {"app": jts.StateDict(dict(state))}, cas=True)
    c1 = tobs.counters()
    # slabs go whole through chunked_write; a host array at the threshold
    # streams chunk by chunk
    assert ("cas/stream_write" in names) == (not batching)
    assert "cas/chunked_write" in names and "cas/commit_refs" in names
    tm, jm = tts.Snapshot(port).metadata, jts.Snapshot(jax).metadata
    assert tm.cas == jm.cas and tm.cas["root"] == "../cas" and tm.cas["chunk_size"] == CHUNK
    assert tm.objects == jm.objects and tm.cas["chunks"]
    assert not [f for f in os.listdir(port) if not f.startswith(".")]  # no per-step object
    pf, jf = _pool_files(str(tmp_path / "port" / "cas")), _pool_files(str(tmp_path / "jax" / "cas"))
    assert sorted(pf) == sorted(jf)
    for rel in pf:
        assert filecmp.cmp(pf[rel], jf[rel], shallow=False), rel
    written = c1["cas.bytes_written"] - c0.get("cas.bytes_written", 0)
    shared = c1.get("cas.bytes_shared", 0) - c0.get("cas.bytes_shared", 0)
    assert written == sum(os.path.getsize(p) for p in pf.values())
    assert written + shared == sum(int(t["size"]) for t in tm.cas["chunks"].values())
    if not batching:
        assert shared >= state["tied"].nbytes  # the second copy of the tied weight
    for root in ("port", "jax"):
        store = str(tmp_path / root / "cas")
        ti = tcas.ChunkIndex.load(tcas.ChunkStore(store))
        ji = jcas.ChunkIndex.load(jcas.ChunkStore(store))
        assert ti.chunks == ji.chunks and ti.rollup() == ji.rollup()
    # the two pools differ only in the step they name
    tr, jr = (tcas.ChunkIndex.load(tcas.ChunkStore(str(tmp_path / r / "cas"))).rollup() for r in ("port", "jax"))
    assert tr.pop("per_step") == {port: jr.pop("per_step")[jax]} and tr == jr


def _read_paths(snap_mod, path, state, device_kw):
    """Budgeted reads whose tiles straddle chunks, and whole reads."""
    snap = snap_mod.Snapshot(path)
    for budget in (CHUNK + 12, 3 * CHUNK // 2 + 8, None):
        if snap_mod is tts:
            tmpl = torch.zeros(state["w"].shape)
            assert snap.read_object("0/app/w", obj_out=tmpl, memory_budget_bytes=budget, **device_kw) is tmpl
            assert tmpl.numpy().tobytes() == state["w"].tobytes()
            f64 = snap.read_object("0/app/w", obj_out=torch.zeros(state["w"].shape, dtype=torch.float64),
                                   memory_budget_bytes=budget, **device_kw)
            assert torch.equal(f64, torch.from_numpy(state["w"]).double())
        else:
            got = snap.read_object("0/app/w", memory_budget_bytes=budget)
            assert np.asarray(got).tobytes() == state["w"].tobytes()


@pytest.mark.parametrize("batching", [True, False])
def test_jax_cas_snapshot_restores_bitwise_in_the_port(tmp_path, batching):
    state = _state(4)
    path = str(tmp_path / "run" / "s")
    with _knobs(batching):
        jts.Snapshot.take(path, {"app": jts.StateDict(dict(state))}, cas=True)
    _assert_bitwise(_port_restored(path, state), state)
    _read_paths(tts, path, state, {"device": "cpu"})
    mat = tts.Snapshot(path).materialize(device="cpu")["app"]
    _assert_bitwise({k: v.numpy() for k, v in mat.items()}, state)
    for deep in (False, True):
        got = tts.verify_snapshot(path, deep=deep)
        assert got.ok and got.complete and _fields(got) == _fields(jts.verify_snapshot(path, deep=deep))


@pytest.mark.parametrize("mode", ["take", "async_take"])
def test_port_cas_snapshot_restores_bitwise_in_jax(tmp_path, mode):
    state = _state(5)
    path = str(tmp_path / "run" / "s")
    with _knobs(batching=True):
        _port_take(path, state, asynchronous=mode == "async_take", cas=str(tmp_path / "pool"))
    assert tts.Snapshot(path).metadata.cas["root"] == str(tmp_path / "pool")
    _assert_bitwise(_jax_restored(path, state), state)
    _read_paths(jts, path, state, {})
    mat = jts.Snapshot(path).materialize()["app"]
    _assert_bitwise({k: np.asarray(v) for k, v in mat.items()}, state)
    assert jts.verify_snapshot(path, deep=True).ok
    _assert_bitwise(_port_restored(path, state), state)


def test_corrupt_or_missing_chunk_fails_verify_and_a_verified_restore(tmp_path):
    state = _state(6)
    path = str(tmp_path / "run" / "s")
    with _knobs():
        _port_take(path, state, cas=True)
    md = tts.Snapshot(path).metadata
    loc = md.manifest["0/app/h"].location
    key = md.cas["chunks"][loc]["keys"][0]
    chunk = os.path.join(str(tmp_path / "run" / "cas"), tcas.chunk_location(key))
    with open(chunk, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    shallow = tts.verify_snapshot(path)
    assert shallow.ok and _fields(shallow) == _fields(jts.verify_snapshot(path))
    deep = tts.verify_snapshot(path, deep=True)
    assert not deep.ok and _fields(deep) == _fields(jts.verify_snapshot(path, deep=True))
    assert [c[0] for c in deep.corrupt] == [loc]
    with tknobs.override_verify_on_restore(True), pytest.raises(RuntimeError, match="checksum mismatch"):
        _port_restored(path, state)
    with jknobs.override_verify_on_restore(True), pytest.raises(RuntimeError, match="checksum mismatch"):
        _jax_restored(path, state)
    os.remove(chunk)
    for deep in (False, True):
        got = tts.verify_snapshot(path, deep=deep)
        assert got.missing == [tcas.chunk_location(key)]
        assert _fields(got) == _fields(jts.verify_snapshot(path, deep=deep))


def test_cas_supersedes_base_needs_checksums_and_a_put_fault_commits_nothing(tmp_path, caplog):
    state = _state(7)
    run = tmp_path / "run"
    with _knobs():
        _port_take(str(run / "s0"), state)
        with caplog.at_level(logging.WARNING):
            _port_take(str(run / "s1"), state, cas=True, base=str(run / "s0"))
        assert "supersedes base" in caplog.text
        assert tts.Snapshot(str(run / "s1")).metadata.cas["chunks"]
        with tknobs.override_write_checksums(False), caplog.at_level(logging.WARNING):
            _port_take(str(run / "s2"), state, cas=True)
        assert "needs WRITE_CHECKSUMS=1" in caplog.text
        assert not tts.Snapshot(str(run / "s2")).metadata.cas
        _assert_bitwise(_jax_restored(str(run / "s2"), state), state)
        with tknobs.override_failpoints("cas.chunk.put=io::1"), pytest.raises(OSError):
            _port_take(str(run / "s3"), {k: v + 1 for k, v in state.items()}, cas=True)
    assert not os.path.exists(run / "s3" / ".snapshot_metadata")
    assert tcas.norm_ref(str(run / "s3")) not in {
        r for e in tcas.ChunkIndex.load(tcas.ChunkStore(str(run / "cas"))).chunks.values() for r in e["refs"]
    }
    with pytest.raises(ValueError, match="parent directory"):
        tts.Snapshot.take("s", {"app": tts.StateDict(w=torch.zeros(2))}, cas=True)


_WORKER_TIMEOUT_S = 90


def test_two_ranks_merge_chunk_tables_at_commit(tmp_path):
    """Two ranks in subprocesses over a FileCoordinator: each writes its
    own chunks into one pool, rank 0 merges the tables and registers the
    refs; both packages restore the snapshot at world 2 and at world 1."""
    body = """
    from torchsnapshot_tpu_torch import knobs
    with knobs.override_cas_chunk_size_bytes(4096), knobs.override_disable_batching(True):
        state = tts.StateDict(mine=torch.arange(5000, dtype=torch.float64) + rank,
                              shared=torch.ones(3000, dtype=torch.float32))
        tts.Snapshot.take(snap_dir + "/s", {"app": state}, coordinator=coord,
                          replicated=["app/shared"], cas=True)
        dest = tts.StateDict(mine=torch.zeros(5000, dtype=torch.float64),
                             shared=torch.zeros(3000, dtype=torch.float32))
        tts.Snapshot(snap_dir + "/s", coordinator=coord).restore({"app": dest}, device="cpu")
        assert torch.equal(dest["mine"], torch.arange(5000, dtype=torch.float64) + rank)
        assert torch.equal(dest["shared"], torch.ones(3000))
    """
    run_multiprocess(tmp_path, 2, body, timeout_s=_WORKER_TIMEOUT_S)
    path = str(tmp_path / "snap" / "s")
    md = jts.Snapshot(path).metadata
    locs = {md.manifest[f"{r}/app/mine"].location for r in (0, 1)}
    assert locs <= set(md.cas["chunks"]) and md.cas["root"] == "../cas"
    index = tcas.ChunkIndex.load(tcas.ChunkStore(str(tmp_path / "snap" / "cas")))
    assert all(e["refs"] == [path] for e in index.chunks.values())
    for r in (0, 1):
        want = np.arange(5000, dtype=np.float64) + r
        assert tts.Snapshot(path).read_object(f"{r}/app/mine", device="cpu").numpy().tobytes() == want.tobytes()
        assert np.asarray(jts.Snapshot(path).read_object(f"{r}/app/mine")).tobytes() == want.tobytes()
        assert jts.verify_snapshot(path, deep=True, rank=r).ok
        assert _fields(tts.verify_snapshot(path, deep=True, rank=r)) == _fields(
            jts.verify_snapshot(path, deep=True, rank=r))
    # world 1: rank 0's view in both packages
    for restored in (_port_restored, _jax_restored):
        got = restored(path, {"mine": np.zeros(5000), "shared": np.zeros(3000, np.float32)})
        assert got["mine"].tobytes() == np.arange(5000, dtype=np.float64).tobytes()
        assert got["shared"].tobytes() == np.ones(3000, np.float32).tobytes()
