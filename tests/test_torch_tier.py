"""The port's tiered storage (``tier/``) against the JAX package's: a fast
tier over a durable one, write-through and write-back, on the same
files.  Either package's tiered steps restore bitwise in the other, from
the fast tier and from the durable tier; an interrupted write-back
promotion of either package is not durably committed, and the other
package's ``repromote()`` completes it; a corrupt fast payload or fast
metadata falls back and is repaired; a peer's fast root serves a restore
with no durable copy; fast retention (either package's, on either
package's root) never evicts an unpromoted step or breaks a dedup chain;
the chunk store under a tier; budgeted ``read_object`` through a tier;
and the ``tiers`` CLI printing what the JAX CLI prints.  States come
from a seeded numpy generator; comparisons are exact.  Every test leaves
both promoters resumed and drained.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu.tier.promoter as jpromoter
import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.tier.promoter as tpromoter
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.__main__ import main as jax_main
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.__main__ import main as port_main

PKGS = {"port": tts, "jax": jts}
_PROMOTERS = {"port": tpromoter, "jax": jpromoter}
N = 2048


@pytest.fixture(autouse=True)
def _drained_promoters():
    yield
    for mod in _PROMOTERS.values():
        mod.get_promoter().resume()
    tts.drain_promotions(raise_on_error=False, timeout_s=120)
    jts.drain_promotions(raise_on_error=False)


def _w(seed):
    return np.random.default_rng(seed).standard_normal(N).astype(np.float32)


def _state(pkg, seed, zero=False):
    w = np.zeros(N, np.float32) if zero else _w(seed)
    b = np.arange(333, dtype=np.int32) * (0 if zero else seed)
    if pkg == "port":
        return {"app": tts.StateDict(w=torch.from_numpy(w), b=torch.from_numpy(b), step=0 if zero else seed)}
    return {"app": jts.StateDict(w=w, b=b, step=0 if zero else seed)}


def _got(dest):
    app = dest["app"]
    w, b = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (app["w"], app["b"]))
    return w.tobytes(), b.tobytes(), app["step"]


def _want(seed):
    return _w(seed).tobytes(), (np.arange(333, dtype=np.int32) * seed).tobytes(), seed


def _restore(pkg, path, opts):
    dest = _state(pkg, 0, zero=True)
    snap = PKGS[pkg].Snapshot(path, storage_options=opts)
    if pkg == "port":
        snap.restore(dest, device="cpu")
    else:
        snap.restore(dest)
    return _got(dest)


def _opts(fast, policy, **extra):
    return {"tier": {"fast_url": str(fast), "policy": policy, **extra}}


def _counters(pkg, *names):
    c = PKGS[pkg].obs.metrics_snapshot()["counters"]
    return [c.get(n, 0) for n in names]


def _payload_files(root):
    return sorted(
        os.path.join(dp, f)
        for dp, _, files in os.walk(root)
        for f in files
        if not f.startswith(".snapshot") and f != "manager_index.json"
    )


def _other(pkg):
    return "jax" if pkg == "port" else "port"


@pytest.mark.parametrize("policy", ["write_through", "write_back"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tiered_steps_restore_in_the_other_package_from_either_tier(tmp_path, writer, policy):
    fast, dur = tmp_path / "fast", tmp_path / "dur"
    opts = _opts(fast, policy)
    reader = _other(writer)
    promoter = _PROMOTERS[writer].get_promoter()
    promoter.pause()
    PKGS[writer].Snapshot.take(str(dur), _state(writer, 7), storage_options=opts)
    assert (fast / ".snapshot_metadata").exists()
    # write-through commits both tiers at once; write-back only the fast
    # one until the promoter runs
    assert (dur / ".snapshot_metadata").exists() == (policy == "write_through")
    hits0, misses0 = _counters(reader, "tier.fast_hits", "tier.fast_misses")
    for pkg in (reader, writer):
        assert _restore(pkg, str(dur), opts) == _want(7), pkg
    hits1, misses1 = _counters(reader, "tier.fast_hits", "tier.fast_misses")
    assert hits1 > hits0 and misses1 == misses0
    promoter.resume()
    PKGS[writer].drain_promotions()
    assert (dur / ".snapshot_metadata").exists()
    # the durable tier alone, in both packages, then through the tier after
    # the fast root is lost (the fallback repairs the fast data objects)
    for pkg in (reader, writer):
        assert _restore(pkg, str(dur), None) == _want(7), pkg
    shutil.rmtree(fast)
    repairs0 = _counters(reader, "tier.fast_repairs")[0]
    assert _restore(reader, str(dur), opts) == _want(7)
    assert _counters(reader, "tier.fast_repairs")[0] > repairs0
    assert _payload_files(fast) and not (fast / ".snapshot_metadata").exists()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_interrupted_promotion_is_completed_by_the_other_packages_repromote(
    tmp_path, monkeypatch, writer
):
    dur, fast = str(tmp_path / "dur"), str(tmp_path / "fast")
    tier = {"fast_root": fast, "policy": "write_back"}
    recoverer = _other(writer)
    mod = _PROMOTERS[writer]
    orphan = mod.get_promoter()
    orphan.pause()
    mgr = PKGS[writer].SnapshotManager(dur, tier=tier)
    mgr.save(_state(writer, 1), step=1)
    assert mgr.steps() == [1] and mgr.durable_steps() == []
    # the crash: the queued jobs die with the process
    monkeypatch.setattr(mod, "_PROMOTER", mod.Promoter())
    for pkg in ("port", "jax"):
        assert PKGS[pkg].SnapshotManager(dur).restore_latest(_state(pkg, 0, zero=True)) is None
    rmgr = PKGS[recoverer].SnapshotManager(dur, tier=tier)
    assert rmgr.repromote() == [1]
    PKGS[recoverer].drain_promotions()
    assert rmgr.durable_steps() == [1] and rmgr.repromote() == []
    shutil.rmtree(fast)
    for pkg in ("port", "jax"):
        dest = _state(pkg, 0, zero=True)
        kw = {"device": "cpu"} if pkg == "port" else {}
        snap = PKGS[pkg].Snapshot(PKGS[pkg].SnapshotManager(dur).path_for_step(1))
        snap.restore(dest, **kw)
        assert _got(dest) == _want(1), pkg
    # a partial recovery (an object this host never had) withholds the
    # marker in either package
    monkeypatch.setattr(mod, "_PROMOTER", mod.Promoter())
    orphan2 = mod.get_promoter()
    orphan2.pause()
    fast2, dur2 = str(tmp_path / "fast2"), str(tmp_path / "dur2")
    m2 = PKGS[writer].SnapshotManager(dur2, tier={"fast_root": fast2, "policy": "write_back"})
    m2.save(_state(writer, 2), step=2)
    monkeypatch.setattr(mod, "_PROMOTER", mod.Promoter())
    os.remove(_payload_files(m2.fast_path_for_step(2))[0])
    r2 = PKGS[recoverer].SnapshotManager(dur2, tier={"fast_root": fast2, "policy": "write_back"})
    assert r2.repromote() == [2]
    with pytest.raises(RuntimeError, match="promotion"):
        PKGS[recoverer].drain_promotions()
    assert not os.path.exists(os.path.join(r2.path_for_step(2), ".snapshot_metadata"))
    for p in (orphan, orphan2):
        p.resume()
        if writer == "port":
            p.drain(raise_on_error=False, timeout_s=120)
        else:
            p.drain(raise_on_error=False)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fast_payload_and_metadata_corruption_fall_back_and_repair(tmp_path, writer):
    fast, dur = tmp_path / "fast", tmp_path / "dur"
    opts = _opts(fast, "write_through")
    with tknobs.override_disable_batching(True), jknobs.override_disable_batching(True):
        PKGS[writer].Snapshot.take(str(dur), _state(writer, 5), storage_options=opts)
    victim = _payload_files(fast)[0]
    rel = os.path.relpath(victim, fast)
    raw = bytearray(open(victim, "rb").read())
    raw[len(raw) // 2] ^= 0x40
    open(victim, "wb").write(bytes(raw))
    corrupt0, repairs0 = _counters("port", "tier.fast_corrupt", "tier.fast_repairs")
    assert _restore("port", str(dur), opts) == _want(5)
    corrupt1, repairs1 = _counters("port", "tier.fast_corrupt", "tier.fast_repairs")
    assert (corrupt1 - corrupt0, repairs1 - repairs0) == (1, 1)
    assert open(victim, "rb").read() == open(dur / rel, "rb").read()
    # the repaired copy is trusted again, in both packages
    for pkg in ("port", "jax"):
        assert _restore(pkg, str(dur), opts) == _want(5), pkg
    assert _counters("port", "tier.fast_corrupt")[0] == corrupt1
    # a flipped byte in the fast metadata fails its self-checksum: served
    # from the durable tier, never repaired through the read path
    meta = fast / ".snapshot_metadata"
    raw = bytearray(meta.read_bytes())
    raw[10] ^= 1
    meta.write_bytes(bytes(raw))
    for pkg in ("port", "jax"):
        assert _restore(pkg, str(dur), opts) == _want(5), pkg
    assert meta.read_bytes() == bytes(raw)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_peer_fast_root_serves_a_restore_with_no_durable_copy(tmp_path, writer):
    peer_fast, my_fast, dur = (str(tmp_path / n) for n in ("peer_fast", "my_fast", "dur"))
    _PROMOTERS[writer].get_promoter().pause()
    PKGS[writer].Snapshot.take(dur, _state(writer, 9), storage_options=_opts(peer_fast, "write_back"))
    assert not os.path.exists(dur)
    opts = _opts(my_fast, "write_back", peer_fast_urls=[my_fast, peer_fast])
    for pkg in ("port", "jax"):
        peer0 = _counters(pkg, "tier.peer_hits")[0]
        assert _restore(pkg, dur, opts) == _want(9), pkg
        assert _counters(pkg, "tier.peer_hits")[0] > peer0
        shutil.rmtree(my_fast)
    assert not os.path.exists(dur)  # no durable read created it


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fast_retention_keeps_unpromoted_steps_on_either_packages_root(tmp_path, writer):
    dur, fast = str(tmp_path / "dur"), str(tmp_path / "fast")
    tier = {"fast_root": fast, "policy": "write_back", "fast_keep_last_n": 1}
    sweeper = _other(writer)
    promoter = _PROMOTERS[writer].get_promoter()
    promoter.pause()
    mgr = PKGS[writer].SnapshotManager(dur, tier=tier)
    for s in (1, 2, 3):
        mgr.save(_state(writer, s), step=s)
    smgr = PKGS[sweeper].SnapshotManager(dur, tier=tier)
    smgr.gc()
    # nothing is durable yet: every fast copy survives keep-last-1, in the
    # writer's sweeps and in the other package's
    assert mgr._scan_dir(fast) == [1, 2, 3] and smgr.steps() == [1, 2, 3]
    assert smgr.durable_steps() == []
    promoter.resume()
    PKGS[writer].drain_promotions()
    smgr.gc()
    assert smgr._scan_dir(fast, require_metadata=False) == [3]
    assert smgr.durable_steps() == mgr.durable_steps() == [1, 2, 3]
    for pkg in ("port", "jax"):
        dest = _state(pkg, 0, zero=True)
        m = PKGS[pkg].SnapshotManager(dur, tier=tier)
        m.snapshot(1).restore(dest, **({"device": "cpu"} if pkg == "port" else {}))
        assert _got(dest) == _want(1), pkg


def test_tiered_retention_never_breaks_an_incremental_dedup_chain(tmp_path):
    dur, fast = str(tmp_path / "dur"), str(tmp_path / "fast")
    tier = tts.TierConfig(fast_root=fast, policy="write_through", fast_keep_last_n=1)
    mgr = tts.SnapshotManager(dur, keep_last_n=1, tier=tier)
    frozen = torch.from_numpy(np.random.default_rng(3).standard_normal(4096))
    with tknobs.override_disable_batching(True):
        mgr.save({"app": tts.StateDict(emb=frozen.clone(), step=1)}, step=1)
        mgr.save({"app": tts.StateDict(emb=frozen.clone(), step=2)}, step=2, incremental=True)
    assert tts.obs.counters().get("bytes_deduped", 0) >= frozen.numel() * 8
    # retention evicted the base from both tiers; the linked step is whole
    assert mgr.steps() == [2] and not os.path.exists(mgr.path_for_step(1))
    assert mgr._scan_dir(fast, require_metadata=False) == [2]
    shutil.rmtree(fast)
    dest = {"app": tts.StateDict(emb=torch.zeros(4096, dtype=torch.float64), step=0)}
    assert mgr.restore_latest(dest) == 2 and torch.equal(dest["app"]["emb"], frozen)
    assert jts.Snapshot(mgr.path_for_step(2)).verify(deep=True).ok


def test_chunk_store_under_a_write_back_tier(tmp_path):
    dur, fast = str(tmp_path / "dur"), str(tmp_path / "fast")
    tier = {"fast_root": fast, "policy": "write_back", "fast_keep_last_n": 1}
    with tknobs.override_cas_chunk_size_bytes(4096):
        mgr = tts.SnapshotManager(dur, tier=tier, cas=True)
        for s in (1, 2):
            mgr.save(_state("port", s), step=s)
        tts.drain_promotions()
        mgr.gc()
        assert mgr.durable_steps() == [1, 2]
        assert mgr._scan_dir(fast, require_metadata=False) == [2]
        # the fast copy's eviction released no chunk ref: GC keeps step 1's
        summary = mgr.cas_gc(grace_s=0)
        assert summary["swept_chunks"] == 0 and summary["marked"] == 0
    shutil.rmtree(fast)
    for step in (1, 2):
        for pkg in ("port", "jax"):
            dest = _state(pkg, 0, zero=True)
            snap = PKGS[pkg].Snapshot(mgr.path_for_step(step))
            snap.restore(dest, **({"device": "cpu"} if pkg == "port" else {}))
            assert _got(dest) == _want(step), (pkg, step)
        assert jts.Snapshot(mgr.path_for_step(step)).metadata.cas["chunks"]


def test_budgeted_read_object_through_the_tier(tmp_path):
    fast, dur = tmp_path / "fast", tmp_path / "dur"
    opts = _opts(fast, "write_through")
    with tknobs.override_disable_batching(True):
        tts.Snapshot.take(str(dur), _state("port", 4), storage_options=opts)
    snap = tts.Snapshot(str(dur), storage_options=opts)
    hits0 = _counters("port", "tier.fast_hits")[0]
    for budget in (None, 1024):
        got = snap.read_object("0/app/w", device="cpu", memory_budget_bytes=budget)
        assert got.numpy().tobytes() == _w(4).tobytes(), budget
    assert _counters("port", "tier.fast_hits")[0] > hits0
    # with the fast copy gone the tiles come from the durable tier
    shutil.rmtree(fast)
    template = torch.zeros(N, dtype=torch.float64)
    got = tts.Snapshot(str(dur), storage_options=opts).read_object(
        "0/app/w", obj_out=template, memory_budget_bytes=1024
    )
    assert torch.equal(got, torch.from_numpy(_w(4)).double())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tiers_cli_prints_what_the_jax_cli_prints(tmp_path, capsys, writer):
    dur, fast = str(tmp_path / "dur"), str(tmp_path / "fast")
    mgr = PKGS[writer].SnapshotManager(dur, tier={"fast_root": fast, "policy": "write_back"})
    mgr.save(_state(writer, 1), step=1)
    PKGS[writer].drain_promotions()
    _PROMOTERS[writer].get_promoter().pause()
    mgr.save(_state(writer, 2), step=2)
    outs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        for flags in ([], ["--json"]):
            rc = main(["tiers", dur, "--fast", fast, *flags])
            cap = capsys.readouterr()
            outs[name, bool(flags)] = (rc, cap.out, cap.err)
    assert outs["port", False] == outs["jax", False]
    assert outs["port", True] == outs["jax", True]
    rows = {r["step"]: r for r in json.loads(outs["port", True][1])["steps"]}
    assert rows[1]["status"] == "durable+fast" and rows[2]["status"] == "promoting"
    assert rows[2]["durable_objects"] < rows[2]["objects"]


@pytest.mark.parametrize("site", ["tier.promote.data", "tier.promote.commit"])
def test_a_failed_promotion_job_withholds_the_durable_marker(tmp_path, site):
    """A fault in either promotion job (the failpoint sites the JAX
    promoter has) fails the drain and leaves the durable tier without a
    commit marker, while the fast commit stands; ``repromote`` then
    completes the step."""
    dur, fast = str(tmp_path / "dur"), str(tmp_path / "fast")
    mgr = tts.SnapshotManager(dur, tier={"fast_root": fast, "policy": "write_back"})
    with tknobs.override_failpoints(f"{site}=io"):
        mgr.save(_state("port", 3), step=3)
        with pytest.raises(RuntimeError, match="promotion job"):
            tts.drain_promotions(timeout_s=60)
    assert mgr.steps() == [3] and mgr.durable_steps() == []
    assert not os.path.exists(os.path.join(mgr.path_for_step(3), ".snapshot_metadata"))
    assert tts.SnapshotManager(dur, tier={"fast_root": fast}).repromote() == [3]
    tts.drain_promotions(timeout_s=60)
    assert mgr.durable_steps() == [3]
    assert _restore("jax", mgr.path_for_step(3), None) == _want(3)

