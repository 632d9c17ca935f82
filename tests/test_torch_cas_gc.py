"""The port's refcounted chunk index and GC (``cas/index.py``,
``cas/gc.py``) and the manager's chunk-store lifecycle, against the JAX
package's.

Each package loads and self-checks the other's ``index.json``; a flipped
byte fails both.  ``commit_refs``, ``release_step``, ``run_gc`` (grace 0,
set through the argument or the knob, never a sleep) and ``fsck`` give
the same results and indexes as the JAX functions on copies of one pool.
The ``cas.index.commit`` crash window is reconciled by ``fsck``.  One
root takes steps from both managers, the port's sharing the JAX step's
chunks, and retention in either package releases refs that the other's
GC honours.  The index lock times out with a named error.
"""

import contextlib
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import cas as jcas
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu_torch import cas as tcas
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import obs as tobs
from torchsnapshot_tpu_torch.cas import index as tindex

CHUNK = 4096
NOW = 1_700_000_000.0


def _state(seed, bump=0.0):
    rng = np.random.default_rng(seed)
    return {
        "frozen": rng.standard_normal(6000),  # 47 KiB, 12 chunks
        "hot": rng.standard_normal(3000).astype(np.float32) + np.float32(bump),
    }


def _port_app(state):
    return {"app": tts.StateDict({k: torch.from_numpy(v.copy()) for k, v in state.items()})}


def _jax_app(state):
    return {"app": jts.StateDict({k: v.copy() for k, v in state.items()})}


def _knobs(stack):
    for k in (tknobs, jknobs):
        stack.enter_context(k.override_cas_chunk_size_bytes(CHUNK))
        stack.enter_context(k.override_disable_batching(True))


def _pool(tmp_path, steps=3):
    """A manager root with ``steps`` CAS steps from the port (the hot
    tensor changes every step, the frozen one never)."""
    root = str(tmp_path / "root")
    with contextlib.ExitStack() as stack:
        _knobs(stack)
        mgr = tts.SnapshotManager(root, cas=True)
        for s in range(steps):
            mgr.save(_port_app(_state(1, bump=s)), step=s)
    return root


def _norm(obj, root):
    """``obj`` with the root's path replaced, for comparing two copies."""
    return json.loads(json.dumps(obj).replace(root, "<root>"))


def _index(mod, root):
    return mod.ChunkIndex.load(mod.ChunkStore(f"{root}/cas"))


def test_index_json_loads_in_both_and_a_flipped_byte_fails_both(tmp_path):
    root = _pool(tmp_path)
    t, j = _index(tcas, root), _index(jcas, root)
    assert t.chunks == j.chunks and t.rollup() == j.rollup() and t.to_json() == j.to_json()
    # the port writes what the JAX package writes
    tcas.ChunkIndex(t.chunks).save(tcas.ChunkStore(f"{root}/cas"))
    assert _index(jcas, root).chunks == j.chunks
    path = f"{root}/cas/index.json"
    raw = bytearray(open(path, "rb").read())
    for pos in (10, len(raw) // 2, len(raw) - 3):
        bad = bytearray(raw)
        bad[pos] ^= 0x01
        open(path, "wb").write(bytes(bad))
        with pytest.raises(tcas.ChunkIndexCorruptError):
            _index(tcas, root)
        with pytest.raises(jcas.ChunkIndexCorruptError):
            _index(jcas, root)
    open(path, "wb").write(bytes(raw))
    assert _index(tcas, root).chunks == j.chunks


def _copies(tmp_path, root):
    t, j = str(tmp_path / "t" / "root"), str(tmp_path / "j" / "root")
    shutil.copytree(root, t)
    shutil.copytree(root, j)
    return t, j


def test_commit_release_gc_and_fsck_match_jax_on_copies_of_one_pool(tmp_path):
    # two pools built alike (refs are absolute paths, so a copied tree
    # would still name the original's steps)
    t, j = _pool(tmp_path / "t"), _pool(tmp_path / "j")
    for mod, root in ((tcas, t), (jcas, j)):
        assert _norm(_index(mod, root).rollup(), root) == _norm(_index(tcas, t).rollup(), t)
    steps = ["step_0000000000", "step_0000000001", "step_0000000002"]
    results = {}
    for mod, snap, root in ((tcas, tts, t), (jcas, jts, j)):
        out = []
        # commit again an existing step's tables under a new ref
        md = snap.Snapshot(f"{root}/{steps[2]}").metadata
        store = mod.ChunkStore(f"{root}/cas")
        mod.commit_refs(store, f"{root}/copy_of_2", md.cas["chunks"])
        store.sync_close()
        out.append(_index(mod, root).rollup())
        # delete step 0: its metadata, then its refs
        shutil.rmtree(f"{root}/{steps[0]}")
        out.append(mod.release_step(f"{root}/cas", f"{root}/{steps[0]}", grace_s=3600, now=NOW))
        out.append(_index(mod, root).chunks)
        # mark: the copy never committed; sweep at grace 0
        out.append(mod.run_gc(f"{root}/cas", grace_s=0, now=NOW + 1))
        out.append(_index(mod, root).chunks)
        os.remove(f"{root}/cas/index.json")
        out.append(mod.fsck(f"{root}/cas", now=NOW + 2))
        out.append(_index(mod, root).chunks)
        results[mod] = _norm(out, root)
    assert results[tcas] == results[jcas]
    gc = results[tcas][3]
    assert gc["swept_chunks"] > 0 and results[tcas][5]["snapshots_committed"] == 2
    for root in (t, j):
        for s in steps[1:]:
            assert tts.verify_snapshot(f"{root}/{s}", deep=True).ok
            assert jts.verify_snapshot(f"{root}/{s}", deep=True).ok


def test_commit_failpoint_window_is_reconciled_by_fsck(tmp_path):
    root = _pool(tmp_path, steps=1)
    with contextlib.ExitStack() as stack:
        _knobs(stack)
        mgr = tts.SnapshotManager(root, cas=True)
        with tknobs.override_failpoints("cas.index.commit=io::1"), pytest.raises(OSError):
            mgr.save(_port_app(_state(1, bump=7)), step=1)
    dead = f"{root}/step_0000000001"
    assert not os.path.exists(f"{dead}/.snapshot_metadata")
    # refs of the uncommitted step are in the index: the crash window
    assert any(dead in e["refs"] for e in _index(tcas, root).chunks.values())
    t, j = _copies(tmp_path, root)
    got = _norm([tts.SnapshotManager(t, cas=True).fsck(), _index(tcas, t).chunks], t)
    want = _norm([jts.SnapshotManager(j, cas=True).fsck(), _index(jcas, j).chunks], j)
    assert [got[0], {k: {**v, "orphaned_at": 0} for k, v in got[1].items()}] == \
        [want[0], {k: {**v, "orphaned_at": 0} for k, v in want[1].items()}]
    index = _index(tcas, t)
    assert not any("step_0000000001" in r for e in index.chunks.values() for r in e["refs"])
    orphans = [k for k, e in index.chunks.items() if "orphaned_at" in e]
    assert orphans  # the dead take's own chunks, swept after the grace window
    with tknobs.override_cas_gc_grace_s(0):
        assert tts.SnapshotManager(t, cas=True).cas_gc()["swept_chunks"] == len(orphans)
    assert tts.verify_snapshot(f"{t}/step_0000000000", deep=True).ok


def test_jax_and_port_managers_share_one_pool(tmp_path):
    root = str(tmp_path / "root")
    with contextlib.ExitStack() as stack:
        _knobs(stack)
        jts.SnapshotManager(root, cas=True).save(_jax_app(_state(2)), step=0)
        c0 = dict(tobs.counters())
        tts.SnapshotManager(root, cas=True).save(_port_app(_state(2, bump=1)), step=1)
        c1 = tobs.counters()
    frozen = _state(2)["frozen"].nbytes
    assert c1["cas.bytes_shared"] - c0.get("cas.bytes_shared", 0) >= frozen
    assert c1["cas.bytes_written"] - c0.get("cas.bytes_written", 0) < frozen
    per_step = _index(jcas, root).rollup()["per_step"]
    assert per_step[f"{root}/step_0000000001"]["shared_bytes"] >= frozen
    assert tts.SnapshotManager(root).steps() == jts.SnapshotManager(root).steps() == [0, 1]
    for s, bump in ((0, 0.0), (1, 1.0)):
        want = _state(2, bump)
        dest = tts.StateDict({k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in want.items()})
        tts.SnapshotManager(root).snapshot(s).restore({"app": dest}, device="cpu")
        jdest = jts.StateDict({k: np.zeros_like(v) for k, v in want.items()})
        jts.SnapshotManager(root).snapshot(s).restore({"app": jdest})
        for k, v in want.items():
            assert dest[k].numpy().tobytes() == v.tobytes() == np.asarray(jdest[k]).tobytes()


@pytest.mark.parametrize("retention", ["port", "jax"])
def test_retention_in_either_package_releases_refs_the_other_gc_honours(tmp_path, retention):
    """keep_last_n=1 over three steps: retention deletes each older step
    metadata first and releases its refs; the other package's GC at grace
    0 sweeps exactly the chunks no committed step references."""
    root = str(tmp_path / "root")
    pkg, other = (tts, jts) if retention == "port" else (jts, tts)
    app = _port_app if retention == "port" else _jax_app
    with contextlib.ExitStack() as stack:
        _knobs(stack)
        mgr = pkg.SnapshotManager(root, keep_last_n=1, cas=True)
        for s in range(3):
            mgr.save(app(_state(3, bump=s)), step=s)
    assert pkg.SnapshotManager(root).steps() == [2]
    index = _index(tcas, root)
    live = {k for k, e in index.chunks.items() if "orphaned_at" not in e}
    md = tts.Snapshot(f"{root}/step_0000000002").metadata
    referenced = {k for t in md.cas["chunks"].values() for k in t["keys"]}
    assert live == referenced
    with tknobs.override_cas_gc_grace_s(0), jknobs.override_cas_gc_grace_s(0):
        result = other.SnapshotManager(root, cas=True).cas_gc()
    assert result["swept_chunks"] == len(index.chunks) - len(referenced)
    assert set(_index(jcas, root).chunks) == referenced
    for snap in (tts, jts):
        assert snap.verify_snapshot(f"{root}/step_0000000002", deep=True).ok


def test_index_lock_times_out_with_a_named_error(tmp_path, monkeypatch):
    root = str(tmp_path / "cas")
    monkeypatch.setattr(tindex, "INDEX_LOCK_DEADLINE_S", 0.1)
    held, release = threading.Event(), threading.Event()

    def holder():
        with tindex.index_lock(root):
            held.set()
            release.wait(10)

    th = threading.Thread(target=holder)
    th.start()
    try:
        assert held.wait(10)
        with pytest.raises(tcas.ChunkIndexLockTimeout, match="not acquired within 0.1 s"):
            tcas.run_gc(root, grace_s=0)
    finally:
        release.set()
        th.join(10)
    # re-entrant in one thread, and free again
    with tindex.index_lock(root), tindex.index_lock(root):
        pass
    assert tcas.run_gc(root, grace_s=0)["chunks"] == 0


def test_fsck_refusal_and_a_commit_of_missing_chunks_match_jax(tmp_path):
    root = _pool(tmp_path, steps=1)
    pool = f"{root}/cas"
    shutil.move(f"{root}/step_0000000000", str(tmp_path / "moved"))
    for mod in (tcas, jcas):
        with pytest.raises(RuntimeError, match="found no committed snapshots"):
            mod.fsck(pool)
    tables = {"x": {"chunk_size": CHUNK, "size": 5, "keys": ["00000000-00000000-5"]}}
    for mod in (tcas, jcas):
        store = mod.ChunkStore(pool)
        with pytest.raises(RuntimeError, match="missing from the pool"):
            mod.commit_refs(store, f"{root}/new", tables)
        store.sync_close()
    # a default scan with explicit paths: fine, and equal
    got = tcas.fsck(pool, [str(tmp_path / "moved")], now=NOW)
    idx_t = _index(tcas, root).chunks
    assert got == jcas.fsck(pool, [str(tmp_path / "moved")], now=NOW) and idx_t == _index(jcas, root).chunks
