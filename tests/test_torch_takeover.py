"""Rank death mid-commit, degraded commits and their repair, in the port,
against the JAX package.

Two processes take over one ``FileCoordinator`` directory; rank 1 dies
(``os._exit``) at the start of the commit, where it would publish its
commit payload (the port's ``_TakePlan.local_payload``, the JAX package's
``_crc_payload``).  Rank 0 must commit degraded within 30 s, its
``degraded`` section naming what the JAX package's names on the same
scenario.  Then each package restores, verifies and repairs the other's
degraded snapshots from a continuous mirror written by either package's
``encode_leaf``; ``SnapshotManager.repair`` heals a managed step; the
death-aware waits raise ``RankDeadError``; the mirror format is byte for
byte the JAX package's.
"""

import os
import shutil
import subprocess
import sys
import textwrap
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu.continuous import store as jstore
from torchsnapshot_tpu.verify import verify_snapshot as jverify
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.continuous import store as tstore
from torchsnapshot_tpu_torch.resilience.liveness import (
    DegradedSnapshotError,
    LivenessMonitor,
    RankDeadError,
)
from torchsnapshot_tpu_torch.verify import verify_snapshot as tverify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMEOUT_S = 90
_W, _SHARED, _BIG = 64, 32, 128


def _env(package):
    prefix = "TORCHSNAPSHOT_TPU_TORCH_" if package == "port" else "TORCHSNAPSHOT_TPU_"
    env = {**os.environ, prefix + "LIVENESS_TIMEOUT_S": "2", prefix + "LIVENESS_INTERVAL_S": "0.2"}
    if package == "jax":
        env.update(PYTHONPATH="", JAX_PLATFORMS="cpu")
    return env


# rank 1 dies where it would publish its commit payload; rank 0 takes the
# same state (w private, shared and big replicated) and must commit
# degraded, with no wait near the barrier deadline
_PORT_BODY = """
    if rank == DEAD:
        tts.snapshot._TakePlan.local_payload = lambda *a, **k: os._exit(9)
    state = {"app": tts.StateDict(
        w=torch.arange(W, dtype=torch.float32) + rank,
        shared=torch.full((SHARED,), 7.0, dtype=torch.float64),
        big=torch.arange(BIG, dtype=torch.float64),
    )}
    t0 = time.monotonic()
    if MODE == "sync":
        snap = tts.Snapshot.take(snap_dir, state, replicated=["app/shared", "app/big"], coordinator=coord)
    else:
        snap = tts.Snapshot.async_take(
            snap_dir, state, replicated=["app/shared", "app/big"], coordinator=coord
        ).wait()
    wall = time.monotonic() - t0
    c = tts.obs.counters()
    print("RESULT", json.dumps({
        "wall": wall, "degraded": snap.metadata.degraded,
        "objects": c.get("takeover.objects", 0), "bytes": c.get("takeover.bytes", 0),
        "degraded_commits": c.get("takeover.degraded_commits", 0),
    }))
"""

_JAX_BODY = """
    import torchsnapshot_tpu.snapshot as snap_mod
    if rank == 1:
        snap_mod._crc_payload = lambda *a, **k: os._exit(9)
    state = {"app": StateDict(
        w=np.arange(W, dtype=np.float32) + rank,
        shared=np.full(SHARED, 7.0),
        big=np.arange(BIG, dtype=np.float64),
    )}
    snap = Snapshot.take(snap_dir, state, replicated=["app/shared", "app/big"], coordinator=coord)
    print("RESULT", json.dumps({"wall": 0.0, "degraded": snap.metadata.degraded}))
"""


def _launch(tmp_path, name, package, body, mode="sync", dead=1):
    """Run ``body`` as ranks 0 and 1 of ``package`` over one
    FileCoordinator, rank ``dead`` dying in the commit; returns the
    survivor's RESULT dict and the snapshot's path."""
    work = tmp_path / name
    work.mkdir()
    imports = (
        "import torch\nimport torchsnapshot_tpu_torch as tts\n" if package == "port"
        else "from torchsnapshot_tpu import FileCoordinator, Snapshot, StateDict\n"
    )
    coord = (
        "tts.FileCoordinator" if package == "port" else "FileCoordinator"
    ) + f"({str(work / 'kv')!r}, rank, 2)"
    head = (
        f"import json, os, sys, time\nsys.path.insert(0, {REPO!r})\nimport numpy as np\n{imports}"
        f"rank = int(sys.argv[1])\ncoord = {coord}\nsnap_dir = {str(work / 'snap')!r}\n"
        f"W, SHARED, BIG, MODE, DEAD = {_W}, {_SHARED}, {_BIG}, {mode!r}, {dead}\n"
    )
    script = work / "worker.py"
    script.write_text(head + textwrap.dedent(body))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(r)], env=_env(package),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=_TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    live = 1 - dead
    assert procs[dead].returncode == 9, f"rank {dead} did not die at the commit:\n{outs[dead]}"
    assert procs[live].returncode == 0, f"the survivor failed:\n{outs[live]}"
    import json

    line = next(ln for ln in outs[live].splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), str(work / "snap")


@pytest.fixture(scope="module")
def degraded(tmp_path_factory):
    """Degraded snapshots of the same scenario: the port's sync and
    async takes, and the JAX package's take."""
    tmp = tmp_path_factory.mktemp("takeover")
    return {
        "port": _launch(tmp, "port_sync", "port", _PORT_BODY),
        "port_async": _launch(tmp, "port_async", "port", _PORT_BODY, mode="async"),
        "port_rank0": _launch(tmp, "port_rank0", "port", _PORT_BODY, dead=0),
        "jax": _launch(tmp, "jax_sync", "jax", _JAX_BODY),
    }


def test_liveness_scope_turns_waits_into_rank_dead_errors(tmp_path):
    """``kv_get`` and ``barrier`` raise ``RankDeadError`` inside a
    ``liveness_scope`` when a peer's stamp is frozen, long before their
    deadline; outside a scope there is no evidence of death."""
    coord = tts.FileCoordinator(str(tmp_path / "kv"), 0, 2)
    with tknobs.override_liveness_timeout_s(0.5), tknobs.override_liveness_interval_s(0.05):
        for op, wait in (
            ("op4", lambda: coord.kv_get("op4/never-set", timeout_s=60.0)),
            ("op5", lambda: coord.barrier("op5-bar", timeout_s=60.0)),
        ):
            coord.kv_set(f"{op}/hb/1", "7")  # frozen: rank 1 is dead
            monitor = LivenessMonitor(coord, op)
            assert coord.dead_ranks() == []
            t0 = time.monotonic()
            with coord.liveness_scope(monitor):
                with pytest.raises(RankDeadError) as ei:
                    wait()
                assert coord.dead_ranks() == [1]
            assert ei.value.dead_ranks == [1]
            assert time.monotonic() - t0 < 30.0


@pytest.mark.parametrize("mode", ["port", "port_async"])
def test_rank_death_mid_commit_commits_degraded_like_jax(degraded, mode):
    """Sync and async: the survivor commits within 30 s; rank 1's
    elected replicated share is re-written by rank 0 (``takeover.*``)
    and only its private leaf is degraded, with the JAX package's paths
    and origin rank."""
    res, path = degraded[mode]
    jres, _ = degraded["jax"]
    assert res["wall"] < 30.0, res
    assert res["degraded"] == jres["degraded"], (res["degraded"], jres["degraded"])
    assert sorted(res["degraded"]) == ["app/w"] and res["degraded"]["app/w"]["origin_rank"] == 1
    assert res["degraded_commits"] == 1
    # the world-2 partition gives rank 1 one of the two replicated leaves
    meta = tts.Snapshot(path).metadata
    by_bytes = {"app/shared": _SHARED * 8, "app/big": _BIG * 8}
    assert res["objects"] == 1 and res["bytes"] in by_bytes.values(), res
    assert sorted(meta.degraded) == ["app/w"]
    for r in (0, 1):
        assert f"{r}/app/w" in meta.manifest


def test_the_leader_dying_hands_the_commit_to_the_survivor(degraded):
    """Rank 0, which commits in the clean protocol, dies: rank 1 leads
    the takeover, re-writes rank 0's replicated share and commits with
    rank 0's private leaf degraded; rank 1's view restores whole."""
    res, path = degraded["port_rank0"]
    assert res["wall"] < 30.0 and res["objects"] == 1 and res["degraded_commits"] == 1, res
    assert res["degraded"] == {"app/w": {"origin_rank": 0, "kind": "Array"}}
    got = tts.StateDict(
        w=torch.zeros(_W), shared=torch.zeros(_SHARED, dtype=torch.float64),
        big=torch.zeros(_BIG, dtype=torch.float64),
    )
    tts.Snapshot(path, coordinator=_Rank1()).restore({"app": got}, device="cpu")
    assert torch.equal(got["w"], torch.arange(_W, dtype=torch.float32) + 1)
    assert torch.equal(got["big"], torch.arange(_BIG, dtype=torch.float64))
    assert torch.equal(got["shared"], torch.full((_SHARED,), 7.0, dtype=torch.float64))
    with pytest.raises(DegradedSnapshotError):
        tts.Snapshot(path).restore({"app": tts.StateDict(w=torch.zeros(_W))}, device="cpu")


def _restore_rank0_view(package, path):
    if package == "port":
        got = tts.StateDict(
            w=torch.zeros(_W), shared=torch.zeros(_SHARED, dtype=torch.float64),
            big=torch.zeros(_BIG, dtype=torch.float64),
        )
        tts.Snapshot(path).restore({"app": got}, device="cpu")
        return {k: np.asarray(v) for k, v in got.items()}
    got = jts.StateDict(
        w=np.zeros(_W, np.float32), shared=np.zeros(_SHARED), big=np.zeros(_BIG),
    )
    jts.Snapshot(path).restore({"app": got})
    return dict(got)


def _mirror(package, root, leaf):
    """A continuous mirror of rank 1 holding ``app/w``, by ``package``'s
    ``encode_leaf`` and store."""
    mod = tstore if package == "port" else jstore
    if package == "port":
        from torchsnapshot_tpu_torch.cas.store import chunk_key, chunk_location
        from torchsnapshot_tpu_torch.io_types import WriteIO
        from torchsnapshot_tpu_torch.utils.checksums import adler32_fast, crc32_fast
    else:
        from torchsnapshot_tpu.cas.store import chunk_key, chunk_location
        from torchsnapshot_tpu.io_types import WriteIO
        from torchsnapshot_tpu.utils.checksums import adler32_fast, crc32_fast
    store = mod.ContinuousStore(root)
    try:
        rec, view = mod.encode_leaf(leaf)
        key = chunk_key((crc32_fast(view), adler32_fast(view), view.nbytes))
        store.storage.sync_write(WriteIO(path=chunk_location(key), buf=bytes(view)))
        rec["keys"] = [key]
        store.write_manifest(1, mod.encode_step_manifest(1, 1 << 20, {"app/w": rec}))
        store.write_head(mod.encode_head(1))
    finally:
        store.sync_close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_restores_verifies_and_repairs_the_others(degraded, tmp_path, writer):
    """A degraded snapshot written by ``writer``: both packages restore
    rank 0's view bitwise, refuse rank 1's lost leaf, verify it degraded
    (not missing); then each package repairs a copy from a mirror
    written by the other package's ``encode_leaf``, after which both
    verify it complete and read rank 1's leaf back."""
    _, src = degraded[writer]
    want = {
        "w": np.arange(_W, dtype=np.float32), "shared": np.full(_SHARED, 7.0),
        "big": np.arange(_BIG, dtype=np.float64),
    }
    for reader in ("port", "jax"):
        got = _restore_rank0_view(reader, src)
        for k, v in want.items():
            assert np.asarray(got[k]).tobytes() == v.tobytes(), (reader, k)
    with pytest.raises(DegradedSnapshotError, match="app/w"):
        tts.Snapshot(src, coordinator=_Rank1()).restore(
            {"app": tts.StateDict(w=torch.zeros(_W))}, device="cpu"
        )
    for res in (tverify(tts.Snapshot(src), rank=1), jverify(jts.Snapshot(src), rank=1)):
        assert res.ok and not res.complete and res.degraded == ["app/w"] and res.missing == []
    lost = np.arange(_W, dtype=np.float32) + 1
    for repairer in ("port", "jax"):
        path = str(tmp_path / f"{writer}_by_{repairer}")
        shutil.copytree(src, path)
        mirror_pkg = "jax" if repairer == "port" else "port"
        mirrors = str(tmp_path / f"mirrors_{repairer}")
        _mirror(mirror_pkg, mirrors + "/r1", torch.from_numpy(lost) if mirror_pkg == "port" else lost)
        snap = (tts if repairer == "port" else jts).Snapshot(path)
        assert snap.repair_degraded([mirrors]) == ["app/w"], repairer
        for res in (tverify(tts.Snapshot(path), deep=True, rank=1),
                    jverify(jts.Snapshot(path), deep=True, rank=1)):
            assert res.ok and res.complete, str(res)
        assert tts.Snapshot(path).read_object("1/app/w", device="cpu").numpy().tobytes() == lost.tobytes()
        assert np.asarray(jts.Snapshot(path).read_object("1/app/w")).tobytes() == lost.tobytes()


class _Rank1(tts.LocalCoordinator):
    """Restores alone, as rank 1 of the snapshot's ranks sees it."""

    @property
    def rank(self):
        return 1


def test_manager_repair_heals_degraded_steps(degraded, tmp_path):
    """``SnapshotManager.repair`` heals a managed degraded step (the
    port's async-taken one) and reports ``{step: paths}``; a second call
    has nothing left to heal."""
    _, src = degraded["port_async"]
    root = tmp_path / "root"
    root.mkdir()
    shutil.copytree(src, root / "step_0000000003")
    mirrors = str(tmp_path / "mirrors")
    _mirror("port", mirrors + "/r1", torch.arange(_W, dtype=torch.float32) + 1)
    mgr = tts.SnapshotManager(str(root))
    assert mgr.steps() == [3]
    assert mgr.repair([mirrors]) == {3: ["app/w"]}
    assert mgr.repair([mirrors]) == {}
    assert tts.Snapshot(str(root / "step_0000000003")).verify(deep=True).complete


def test_encode_leaf_and_store_documents_equal_jax():
    """``encode_leaf`` records and bytes equal the JAX package's for f32,
    bf16, int8 and an object leaf (``bfloat16`` as the JAX dtype string,
    its bytes through a uint8 view); ``decode_leaf`` gives them back on
    the named device; heads and step manifests are the same bytes."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf16 = rng.standard_normal(7).astype(ml_dtypes.bfloat16)
    i8 = rng.integers(-128, 127, (4, 4)).astype(np.int8)
    obj = {"step": 3, "tag": "x", "lr": 0.5}
    cases = [
        (torch.from_numpy(f32), f32),
        (torch.from_numpy(bf16.view(np.uint16)).view(torch.bfloat16), bf16),
        (torch.from_numpy(i8), i8),
        (obj, obj),
    ]
    for tleaf, jleaf in cases:
        trec, tview = tstore.encode_leaf(tleaf)
        jrec, jview = jstore.encode_leaf(jleaf)
        assert trec == jrec and bytes(tview) == bytes(jview), (trec, jrec)
        back = tstore.decode_leaf(trec, bytes(tview), device="cpu")
        if isinstance(tleaf, torch.Tensor):
            assert back.dtype == tleaf.dtype and torch.equal(back, tleaf)
        else:
            assert back == obj
    assert tstore.encode_head(5) == jstore.encode_head(5)
    leaves = {"a": {"kind": "array", "dtype": "float32", "shape": [2], "size": 8, "keys": ["k"]}}
    assert tstore.encode_step_manifest(5, 4096, leaves) == jstore.encode_step_manifest(5, 4096, leaves)


def test_continuous_store_read_and_written_by_both_packages(tmp_path):
    """A mirror the port writes (``write_state``) reads back in the JAX
    package, and one the JAX package writes reads in the port, leaf for
    leaf."""
    leaves = {
        "m/w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "m/b": torch.ones(5, dtype=torch.bfloat16),
        "m/meta": {"step": 7},
    }
    tstore.ContinuousStore(str(tmp_path / "p")).write_state(7, leaves, chunk_size=16)
    step, got = jstore.ContinuousStore(str(tmp_path / "p")).read_state()
    assert step == 7 and got["m/meta"] == {"step": 7}
    assert got["m/w"].tobytes() == leaves["m/w"].numpy().tobytes()
    assert got["m/b"].dtype == ml_dtypes.bfloat16
    assert got["m/b"].view(np.uint16).tobytes() == leaves["m/b"].view(torch.uint16).numpy().tobytes()
    _mirror("jax", str(tmp_path / "j"), np.arange(4, dtype=np.float32))
    store = tstore.ContinuousStore(str(tmp_path / "j"))
    step, back = store.read_state(device="cpu")
    store.sync_close()
    assert step == 1 and torch.equal(back["app/w"], torch.arange(4, dtype=torch.float32))
