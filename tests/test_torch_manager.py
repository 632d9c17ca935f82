"""The port's ``SnapshotManager`` against the JAX package's: the same
step layout and ``manager_index.json``, so either manager reads, resumes
from and prunes the other's root; retention with metadata-first GC;
``restore_latest`` cold and warm; async saves indexed at ``wait()`` or
at the next save; incremental saves (also across two ranks); and the
features not ported yet refused by name.  States come from a seeded
numpy generator; comparisons are exact.
"""

import json
import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.manager import INDEX_FNAME
from torchsnapshot_tpu_torch.storage import fs as tfs
from torchsnapshot_tpu_torch.test_utils import run_multiprocess

_WORKER_TIMEOUT_S = 90


def _w(step):
    return np.random.default_rng(step).standard_normal(64)


def _state(pkg, step):
    if pkg == "port":
        return {"app": tts.StateDict(w=torch.from_numpy(_w(step)), step=step)}
    return {"app": jts.StateDict(w=_w(step), step=step)}


def _mgr(pkg, root, **kw):
    return (tts if pkg == "port" else jts).SnapshotManager(str(root), **kw)


def _restore_latest(pkg, root, **kw):
    mgr = _mgr(pkg, root)
    dest = _state(pkg, 999)
    step = mgr.restore_latest(dest, **kw)
    w = dest["app"]["w"]
    return step, (w.numpy() if isinstance(w, torch.Tensor) else w), dest["app"]["step"]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_either_manager_reads_and_prunes_the_others_root(tmp_path, writer, reader):
    wm = _mgr(writer, tmp_path, keep_last_n=3)
    for step in (3, 7, 11):
        wm.save(_state(writer, step), step=step)
    assert json.loads((tmp_path / INDEX_FNAME).read_text()) == {"steps": [3, 7, 11]}
    assert sorted(os.listdir(tmp_path)) == [INDEX_FNAME, "step_0000000003", "step_0000000007", "step_0000000011"]
    rm = _mgr(reader, tmp_path, keep_last_n=3)
    assert rm.steps() == [3, 7, 11] and rm.latest_step() == 11
    assert rm.path_for_step(7) == wm.path_for_step(7)
    step, w, s = _restore_latest(reader, tmp_path)
    assert step == 11 and s == 11 and w.tobytes() == _w(11).tobytes()
    # the reader saves on, and its retention evicts the writer's oldest
    rm.save(_state(reader, 12), step=12)
    assert _mgr(writer, tmp_path).steps() == [7, 11, 12]
    assert not os.path.exists(tmp_path / "step_0000000003")
    assert json.loads((tmp_path / INDEX_FNAME).read_text()) == {"steps": [7, 11, 12]}


def test_retention_and_metadata_first_gc(tmp_path, monkeypatch):
    mgr = tts.SnapshotManager(str(tmp_path), keep_last_n=2)
    for step in range(4):
        mgr.save(_state("port", step), step=step)
    assert mgr.steps() == [2, 3]
    assert not os.path.exists(mgr.path_for_step(0)) and not os.path.exists(mgr.path_for_step(1))
    # a GC that dies after its first delete leaves an aborted snapshot:
    # the metadata goes first, so the step is no longer committed
    deleted = []

    async def delete_then_die(self, path):
        deleted.append(path)
        if len(deleted) > 1:
            raise OSError("storage lost mid-GC")
        os.remove(os.path.join(self.root, path))

    monkeypatch.setattr(tfs.FSStoragePlugin, "delete", delete_then_die)
    with pytest.raises(OSError, match="mid-GC"):
        tts.delete_snapshot(mgr.path_for_step(2))
    assert deleted[0] == ".snapshot_metadata"
    assert os.path.exists(mgr.path_for_step(2))
    assert mgr.steps() == [3] and jts.SnapshotManager(str(tmp_path)).steps() == [3]
    monkeypatch.undo()
    # the JAX package's delete finishes the job on the aborted snapshot
    jts.delete_snapshot(mgr.path_for_step(2))
    assert not os.path.exists(mgr.path_for_step(2))
    mgr.gc()
    assert mgr.steps() == [3]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restore_latest_cold_and_warm(tmp_path, pkg):
    """A cold start returns None and leaves the state alone; a warm one
    restores the newest step, skipping a step whose metadata is corrupt,
    and ``paths=`` restores the matching leaves only."""
    assert _restore_latest("port", tmp_path / "run")[0] is None
    mgr = _mgr(pkg, tmp_path / "run")
    for step in (1, 2):
        mgr.save(_state(pkg, step), step=step)
    step, w, s = _restore_latest("port", tmp_path / "run")
    assert step == 2 and s == 2 and w.tobytes() == _w(2).tobytes()
    step, w, s = _restore_latest("port", tmp_path / "run", paths=["app/step"])
    assert step == 2 and s == 2 and w.tobytes() == _w(999).tobytes()
    (tmp_path / "run" / "step_0000000002" / ".snapshot_metadata").write_bytes(b"{not yaml")
    for reader in ("port", "jax"):
        step, w, _ = _restore_latest(reader, tmp_path / "run")
        assert step == 1 and w.tobytes() == _w(1).tobytes()


def test_async_save_indexed_at_wait_or_at_the_next_save(tmp_path, monkeypatch):
    """With the scan off (the index is the only discovery, as on a store
    with no listing): ``wait()`` indexes the step and applies retention;
    a handle never waited on is indexed by the next save."""
    mgr = tts.SnapshotManager(str(tmp_path), keep_last_n=2)
    monkeypatch.setattr(mgr, "_scan_fs", lambda: [])
    mgr.save(_state("port", 1), step=1)
    mgr.save(_state("port", 2), step=2)
    snap = mgr.save(_state("port", 3), step=3, async_=True).wait()
    assert snap.get_manifest() and mgr.steps() == [2, 3]
    assert not os.path.exists(mgr.path_for_step(1))
    handle = mgr.save(_state("port", 4), step=4, async_=True)
    handle._pending.wait()  # the commit lands; the manager's hook does not run
    assert json.loads((tmp_path / INDEX_FNAME).read_text()) == {"steps": [2, 3]}
    mgr.save(_state("port", 5), step=5)
    assert mgr.steps() == [4, 5] and 4 not in mgr._pending_async
    jm = jts.SnapshotManager(str(tmp_path))
    monkeypatch.setattr(jm, "_scan_fs", lambda: [])
    assert jm.steps() == [4, 5]


def test_incremental_save_links_the_previous_step(tmp_path):
    mgr = tts.SnapshotManager(str(tmp_path), keep_last_n=2)
    frozen = torch.from_numpy(_w(0))
    with tknobs.override_disable_batching(True):
        mgr.save({"app": tts.StateDict(emb=frozen, step=1)}, step=1, incremental=True)  # cold: full
        mgr.save({"app": tts.StateDict(emb=frozen, step=2)}, step=2, incremental=True, async_=True).wait()
        mgr.save({"app": tts.StateDict(emb=frozen, step=3)}, step=3, incremental=True)
    loc = mgr.snapshot(3).get_manifest()["0/app/emb"].location
    st = os.stat(os.path.join(mgr.path_for_step(3), loc))
    assert st.st_ino == os.stat(os.path.join(mgr.path_for_step(2), loc)).st_ino
    # step 1 was retained out; its inode lives on in steps 2 and 3
    assert mgr.steps() == [2, 3] and st.st_nlink == 2
    dest = {"app": jts.StateDict(emb=np.zeros(64), step=0)}
    assert jts.SnapshotManager(str(tmp_path)).restore_latest(dest) == 3
    assert dest["app"]["emb"].tobytes() == _w(0).tobytes() and dest["app"]["step"] == 3
    assert jts.verify_snapshot(mgr.path_for_step(3), deep=True).ok


def test_two_rank_incremental_manager_save(tmp_path):
    """Two ranks over a FileCoordinator (the launcher's deadline on every
    wait): rank 0 picks the previous step and reads the base table, both
    broadcast; each rank links its own unchanged object."""
    body = """
    from torchsnapshot_tpu_torch import knobs
    mgr = tts.SnapshotManager(snap_dir, keep_last_n=2, coordinator=coord)
    with knobs.override_disable_batching(True):
        for step in (1, 2):
            state = {"app": tts.StateDict(mine=torch.full((1024,), float(rank), dtype=torch.float64),
                                          hot=torch.full((8,), float(step + rank), dtype=torch.float64))}
            mgr.save(state, step=step, incremental=True)
    dest = {"app": tts.StateDict(mine=torch.zeros(1024, dtype=torch.float64),
                                 hot=torch.zeros(8, dtype=torch.float64))}
    assert mgr.restore_latest(dest) == 2
    assert dest["app"]["hot"][0].item() == 2.0 + rank
    """
    run_multiprocess(tmp_path, 2, body, timeout_s=_WORKER_TIMEOUT_S)
    root = tmp_path / "snap"
    man = jts.Snapshot(str(root / "step_0000000002")).get_manifest()
    for r in (0, 1):
        loc = man[f"{r}/app/mine"].location
        assert os.stat(root / "step_0000000002" / loc).st_ino == os.stat(root / "step_0000000001" / loc).st_ino
        assert jts.verify_snapshot(jts.Snapshot(str(root / "step_0000000002")), deep=True, rank=r).ok
    assert jts.SnapshotManager(str(root)).steps() == [1, 2]


def test_unported_features_are_refused_by_name(tmp_path):
    """Publication is refused by name (repair is ported: a root without
    degraded steps has nothing to heal); tiers (``tier=``,
    ``repromote``) and the chunk store (``cas=``, the CAS knob, ``cas_gc``,
    ``fsck``) are configured and run as the JAX manager's do."""
    with pytest.raises(ValueError, match="keep_last_n"):
        tts.SnapshotManager(str(tmp_path), keep_last_n=0)
    # publisher= is taken: a committed save is published from rank 0
    from torchsnapshot_tpu_torch.publish import Publisher, root_rollup

    pub = Publisher(str(tmp_path / "pub"))
    published = tts.SnapshotManager(str(tmp_path / "published"), publisher=pub)
    published.save({"app": tts.StateDict(w=torch.arange(64, dtype=torch.float32))}, step=3)
    pub.close()
    roll = root_rollup(str(tmp_path / "pub"))
    assert roll["step"] == 3 and roll["source"] == "snapshot" and roll["leaves"] == 1
    refusals = []
    mgr = tts.SnapshotManager(str(tmp_path))
    assert mgr.repair([str(tmp_path / "mirrors")]) == {}
    # an untiered manager has nothing to re-promote; a tier dict becomes the
    # same TierConfig as in the JAX manager
    assert mgr.repromote() == [] and mgr.tier is None
    tiered = tts.SnapshotManager(str(tmp_path), tier={"fast_root": str(tmp_path / "fast")})
    assert vars(tiered.tier) == vars(
        jts.SnapshotManager(str(tmp_path), tier={"fast_root": str(tmp_path / "fast")}).tier
    )
    assert tiered.repromote() == [] and tiered.durable_steps() == []
    for fn, item in refusals:
        with pytest.raises(NotImplementedError, match=f"queue A {item}"):
            fn()
    root = str(tmp_path / "root")
    for cas in (True, 1, str(tmp_path / "pool"), {"chunk_size_bytes": 8192}, None, False):
        assert tts.SnapshotManager(root, cas=cas).cas == jts.SnapshotManager(root, cas=cas).cas
    for on in (True, False):
        with tknobs.override_cas(on), jknobs.override_cas(on):
            assert tts.SnapshotManager(root).cas == jts.SnapshotManager(root).cas
    # the knob is overridden in either direction by the argument
    with tknobs.override_cas(True):
        assert tts.SnapshotManager(str(tmp_path), cas=False).steps() == []
        assert tts.SnapshotManager(str(tmp_path), cas=False).cas is None
    # without the chunk store cas_gc and fsck do nothing, as in the JAX package
    for pkg in (tts, jts):
        assert pkg.SnapshotManager(root).cas_gc() is None and pkg.SnapshotManager(root).fsck() is None
    # an empty pool: the same GC and rebuild summaries
    assert tts.SnapshotManager(root, cas=True).cas_gc(grace_s=0) == \
        jts.SnapshotManager(root, cas=True).cas_gc(grace_s=0)
    assert tts.SnapshotManager(root, cas=True).fsck() == jts.SnapshotManager(root, cas=True).fsck()
