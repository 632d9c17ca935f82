"""The port's recovery ladder (``continuous/recover.py``), topology-aware
peers, the continuous rollups, and parity with the JAX package's loop.

Mirrors on the port the recovery, rollup and topology tests of
``tests/test_continuous.py`` and the continuous chaos tests of
``tests/test_chaos.py`` (the SIGTERM one is in
``test_torch_preemption.py``).  Parity: one seeded numpy state sequence
(float32, bfloat16, int64 and object leaves, 3 steps, 4 KiB chunks) goes
through both packages' loops, which write the same step manifests and
chunk keys and count the same continuous deltas; a store written by
either loop is recovered bitwise by the other package's
``recover_state``."""

import json
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
import torchsnapshot_tpu.continuous as jcont
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import knobs, obs, recover_state
from torchsnapshot_tpu_torch.cas.store import chunk_location
from torchsnapshot_tpu_torch.continuous import ContinuousStore, step_manifest_path
from torchsnapshot_tpu_torch.continuous.recover import TemplateMismatchError
from torchsnapshot_tpu_torch.resilience import preemption
from torchsnapshot_tpu_torch.storage.memory import reset_namespace
from torchsnapshot_tpu_torch.tier.promoter import drain_promotions, get_promoter
from torchsnapshot_tpu_torch.topology import Topology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 4096
N = 4096


@pytest.fixture(autouse=True)
def _hooks_and_promoter():
    yield
    preemption.uninstall()
    get_promoter().resume()
    drain_promotions(raise_on_error=False, timeout_s=120)


def _state(seed=0.0):
    return {"app": tts.StateDict(w=torch.arange(N, dtype=torch.float32) + seed,
                                 meta={"lr": 0.1, "name": "run7"})}


def _dest():
    return {"app": tts.StateDict(w=torch.zeros(N), meta={"lr": 0.0, "name": ""})}


def _cc(tmp_path, **kw):
    kw.setdefault("replica_roots", [str(tmp_path / "peer")])
    kw.setdefault("chunk_size_bytes", CHUNK)
    kw.setdefault("device", "cpu")
    return tts.ContinuousCheckpointer(str(tmp_path / "local"), **kw)


def _recover(dest, **kw):
    return recover_state(dest, device="cpu", **kw)


def _counter(name):
    return obs.counter(name).value


def test_recover_source_ladder_local_peer_durable(tmp_path):
    cc = _cc(tmp_path, durable_root=str(tmp_path / "durable"), promote_every_n=1)
    state = _state()
    try:
        cc.step(state, 1)
        cc.drain()
        drain_promotions(timeout_s=120)
    finally:
        cc.close()
    local, peer, durable = (str(tmp_path / d / "r0") for d in ("local", "peer", "durable"))
    l0 = _counter(obs.CONTINUOUS_RESTORES_FROM_LOCAL)
    h0 = obs.histogram(obs.CONTINUOUS_RESTORE_S).count
    assert _recover(_dest(), local=local, peers=[peer], durable=durable)["source"] == "local"
    assert _counter(obs.CONTINUOUS_RESTORES_FROM_LOCAL) == l0 + 1
    assert obs.histogram(obs.CONTINUOUS_RESTORE_S).count == h0 + 1
    shutil.rmtree(local)
    p0 = _counter(obs.CONTINUOUS_RESTORES_FROM_PEER)
    assert _recover(_dest(), local=local, peers=[peer], durable=durable)["source"] == "peer"
    assert _counter(obs.CONTINUOUS_RESTORES_FROM_PEER) == p0 + 1
    shutil.rmtree(peer)
    dest = _dest()
    d0 = _counter(obs.CONTINUOUS_RESTORES_FROM_DURABLE)
    res = _recover(dest, local=local, peers=[peer], durable=durable)
    assert res["source"] == "durable" and res["step"] == 1
    assert _counter(obs.CONTINUOUS_RESTORES_FROM_DURABLE) == d0 + 1
    assert torch.equal(dest["app"]["w"], state["app"]["w"])
    shutil.rmtree(durable)
    assert _recover(_dest(), local=local, peers=[peer], durable=durable) is None


def test_corrupt_peer_chunk_fails_closed_to_next_source(tmp_path):
    cc = _cc(tmp_path, durable_root=str(tmp_path / "durable"), promote_every_n=1)
    state = _state()
    try:
        cc.step(state, 1)
        cc.drain()
        drain_promotions(timeout_s=120)
    finally:
        cc.close()
    peer = str(tmp_path / "peer" / "r0")
    store = ContinuousStore(peer)
    key = store.read_step_manifest(store.read_head()["manifest"])["leaves"]["app/w"]["keys"][0]
    with open(os.path.join(peer, chunk_location(key)), "r+b") as f:
        f.write(b"\xff\xff\xff\xff")
    dest = _dest()
    res = _recover(dest, peers=[peer], durable=str(tmp_path / "durable" / "r0"))
    assert res["source"] == "durable"
    assert torch.equal(dest["app"]["w"], state["app"]["w"])


def test_recover_strict_missing_leaves(tmp_path):
    cc = _cc(tmp_path)
    try:
        cc.step({"app": tts.StateDict(w=torch.ones(8))}, 1)
        cc.drain()
    finally:
        cc.close()
    peer = str(tmp_path / "peer" / "r0")
    grown = {"app": tts.StateDict(w=torch.zeros(8), extra=torch.ones(4))}
    with pytest.raises(TemplateMismatchError):
        _recover(grown, peers=[peer], strict=True)
    assert _recover(grown, peers=[peer], strict=False)["step"] == 1
    assert torch.equal(grown["app"]["w"], torch.ones(8))
    assert torch.equal(grown["app"]["extra"], torch.ones(4))  # the template's own


def test_recover_prefers_freshest_source_over_ladder_order(tmp_path):
    """A LAGGING local store (its replication failed) loses to a fresher
    peer; at equal freshness the ladder order (local first) wins."""
    local_ns = f"ttcclocal_{os.getpid()}"
    cc = tts.ContinuousCheckpointer(
        f"memory://{local_ns}", replica_roots=[str(tmp_path / "peer")],
        chunk_size_bytes=CHUNK, device="cpu",
    )
    state = _state()
    local = f"memory://{local_ns}/r0"
    peer = str(tmp_path / "peer" / "r0")
    try:
        cc.step(state, 1)
        cc.drain()
        with knobs.override_failpoints("storage.memory.write=io"):
            state["app"]["w"][0] += 1.0
            cc.step(state, 2)
            cc.drain()
        assert cc.summary()["target_heads"][local] == 1
        dest = _dest()
        res = _recover(dest, local=local, peers=[peer])
        assert res["step"] == 2 and res["source"] == "peer", res
        assert torch.equal(dest["app"]["w"], state["app"]["w"])
        state["app"]["w"][1] += 1.0
        cc.step(state, 3)
        cc.drain()
        res = _recover(_dest(), local=local, peers=[peer])
        assert res["step"] == 3 and res["source"] == "local", res
    finally:
        cc.close()
        reset_namespace(local_ns)


def test_flight_record_and_doctor_carry_continuous_rollup(tmp_path, capsys):
    """The rank payload carries the live loop's summary, the merged record
    the fleet's floors, and ``doctor`` prints the JAX CLI's rows for it."""
    from torchsnapshot_tpu.__main__ import _render_doctor as jax_render
    from torchsnapshot_tpu_torch.__main__ import _render_doctor
    from torchsnapshot_tpu_torch.obs import aggregate

    cc = _cc(tmp_path)
    try:
        cc.step(_state(), 12)
        cc.drain()
        payload = aggregate.rank_payload(0, "take", aggregate.capture())
        assert payload["continuous"]["last_step"] == 12
        rec = aggregate.merge_payloads([payload], "take", str(tmp_path), 1)
        assert rec["continuous"]["last_peer_step_floor"] == 12
        assert rec["continuous"]["max_replication_lag_steps"] == 0
        _render_doctor(rec)
        out = capsys.readouterr().out
        assert "continuous: peer-step floor 12" in out and "rank 0: step 12" in out
        jax_render(json.loads(json.dumps(rec)))
        assert capsys.readouterr().out == out
    finally:
        cc.close()


def test_stats_cli_continuous_rollup(tmp_path):
    cc = _cc(tmp_path)
    try:
        cc.step(_state(), 3)
        cc.drain()
    finally:
        cc.close()
    out = subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch", "stats", str(tmp_path / "peer"), "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    rollup = json.loads(out.stdout)
    assert rollup["stores"]["r0"]["head_step"] == 3 and rollup["stores"]["r0"]["pool_chunks"] > 0


def test_topology_replica_preference_prefers_other_slice():
    """On a 0,0,0,1 topology the lone rank of slice 1 is every slice-0
    rank's first replica, and rank 3's own preference goes to slice 0."""
    topo = Topology.from_spec("0,0,0,1", rank=0, world_size=4)
    pref = topo.replica_preference(0)
    assert pref[0] == 3 and set(pref) == {1, 2, 3}
    assert topo.slice_of[topo.replica_preference(3)[0]] == 0


def test_tier_pick_replica_targets_topology_aware():
    from torchsnapshot_tpu_torch.tier.plugin import TieredStoragePlugin

    peers = [f"/fast/{r}" for r in range(4)]
    plugin = TieredStoragePlugin.__new__(TieredStoragePlugin)
    plugin.fast_url = peers[0]
    plugin.replica_count = 1
    topo = Topology.from_spec("0,0,0,1", rank=0, world_size=4)
    assert plugin._pick_replica_targets(peers, 0, topo) == ["/fast/3"]
    assert plugin._pick_replica_targets(peers, 0, None) == ["/fast/1"]
    assert plugin._pick_replica_targets(peers, 0, Topology.flat(0, 4)) == ["/fast/1"]


def test_continuous_picks_different_slice_peer(tmp_path):
    """The loop's peers follow the same preference: rank 0 of an uneven
    topology mirrors to the slice-1 host; ``restore_latest`` tries the
    peers in that order."""
    roots = [str(tmp_path / f"h{r}") for r in range(4)]

    class _FourRankCoord(tts.LocalCoordinator):
        @property
        def world_size(self):
            return 4

    cc = tts.ContinuousCheckpointer(
        roots[0], coordinator=_FourRankCoord(), peer_roots=roots, replica_count=1,
        topology=Topology.from_spec("0,0,0,1", rank=0, world_size=4), chunk_size_bytes=CHUNK,
        device="cpu",
    )
    try:
        assert cc._ensure_targets() == [f"{roots[0]}/r0", f"{roots[3]}/r0"]
        assert cc.restore_latest(_dest()) is None  # a cold start: nothing written
    finally:
        cc.close()


def test_chaos_preemption_both_dead_falls_back_to_durable(tmp_path):
    """Host and peer both gone: recovery degrades to the last promoted
    durable step in bounded time, and an empty world is a cold start."""
    local, peer, durable = (str(tmp_path / d) for d in ("local", "peer", "durable"))
    cc = tts.ContinuousCheckpointer(
        local, durable_root=durable, replica_roots=[peer], promote_every_n=2,
        chunk_size_bytes=16384, device="cpu",
    )
    state = {"app": tts.StateDict(w=torch.arange(1 << 14, dtype=torch.float32))}
    try:
        for s in range(1, 6):  # promotions at steps 1, 3, 5
            state["app"]["w"] += 1.0
            cc.step(state, s)
        cc.drain()
        drain_promotions(timeout_s=120)
    finally:
        cc.close()
    shutil.rmtree(local)
    shutil.rmtree(peer)
    stores = dict(local=os.path.join(local, "r0"), peers=[os.path.join(peer, "r0")],
                  durable=os.path.join(durable, "r0"))
    t0 = time.monotonic()
    dest = {"app": tts.StateDict(w=torch.zeros(1 << 14))}
    res = _recover(dest, **stores)
    assert time.monotonic() - t0 < 30, "the degradation must not wedge"
    assert res is not None and res["source"] == "durable" and res["step"] == 5
    assert torch.equal(dest["app"]["w"], state["app"]["w"])
    shutil.rmtree(durable)
    assert _recover(dest, **stores) is None


_RTO_CHILD = """
import os, sys
sys.path.insert(0, {repo!r})
import torch
import torchsnapshot_tpu_torch as tts

rank, world = int(sys.argv[1]), int(sys.argv[2])
coord = tts.FileCoordinator({kv!r}, rank, world)
base = {base!r}
cc = tts.ContinuousCheckpointer(
    os.path.join(base, f"host{{rank}}"), durable_root=os.path.join(base, "durable"),
    coordinator=coord, peer_roots=[os.path.join(base, f"host{{r}}") for r in range(world)],
    replica_count=1, promote_every_n=3, chunk_size_bytes=16384, preemption_hook=False,
    device="cpu",
)
state = {{"app": tts.StateDict(w=torch.zeros(1 << 17))}}
for s in range(1, 7):
    state["app"]["w"] = torch.arange(1 << 17, dtype=torch.float32) + rank * 1000.0 + s
    cc.step(state, s)
    print(f"TRAINED {{s}}", flush=True)
    if rank == 1 and s == 6:
        os._exit(9)  # preempted with no notice, its replication maybe in flight
cc.drain()
tts.drain_promotions(timeout_s=120)
cc.close()
print(f"rank {{rank}} CHAOS-OK", flush=True)
"""


def test_chaos_continuous_rto_peer_vs_durable_cold(tmp_path, monkeypatch):
    """A host killed mid-training with no notice (rank 1 exits with a
    replication in flight) restores from its peer, losing at most one
    step, an order of magnitude faster than a durable cold restore in the
    same harness (every durable read delayed 50 ms over one connection, a
    cloud round trip's stand-in; the peer's reads are local)."""
    script = tmp_path / "rto_child.py"
    script.write_text(textwrap.dedent(_RTO_CHILD.format(
        repo=REPO, kv=str(tmp_path / "kv"), base=str(tmp_path))))
    env = {**os.environ, "PYTHONPATH": ""}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert procs[0].returncode == 0 and "rank 0 CHAOS-OK" in outs[0], outs[0]
    assert procs[1].returncode == 9 and "TRAINED 6" in outs[1], outs[1]

    def want(step):
        return torch.arange(1 << 17, dtype=torch.float32) + 1000.0 + step

    dest = {"app": tts.StateDict(w=torch.zeros(1 << 17))}
    res_peer = _recover(dest, peers=[str(tmp_path / "host0" / "r1")])
    assert res_peer is not None and res_peer["source"] == "peer"
    assert res_peer["step"] >= 5, res_peer  # at most ONE lost step
    assert torch.equal(dest["app"]["w"], want(res_peer["step"]))
    dest2 = {"app": tts.StateDict(w=torch.zeros(1 << 17))}
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_TORCH_MAX_PER_RANK_IO_CONCURRENCY", "1")
    with knobs.override_failpoints("storage.fs.read=delay50"):
        res_durable = _recover(dest2, durable=str(tmp_path / "durable" / "r1"))
    assert res_durable is not None and res_durable["source"] == "durable"
    assert res_durable["step"] <= res_peer["step"]
    assert torch.equal(dest2["app"]["w"], want(res_durable["step"]))
    assert res_peer["seconds"] < 10.0, res_peer
    assert res_durable["seconds"] / max(res_peer["seconds"], 1e-9) >= 10.0, (res_peer, res_durable)


# ------------------------------------------------- parity with the JAX package


def _np_states():
    """Three steps of one seeded numpy state: the first whole, then one
    chunk of ``w`` changed, then all of ``w`` and ``b``."""
    rng = np.random.default_rng(16)
    w = rng.standard_normal(N).astype(np.float32)
    b = rng.standard_normal(2048).astype(ml_dtypes.bfloat16)
    i = rng.integers(-(1 << 40), 1 << 40, 1000, dtype=np.int64)
    out = [(w.copy(), b.copy(), i)]
    w[3] += 1.0
    out.append((w.copy(), b.copy(), i))
    w += 1.0
    b = (b.astype(np.float32) * 2).astype(ml_dtypes.bfloat16)
    out.append((w.copy(), b.copy(), i))
    return out


def _jax_state(w, b, i):
    return {"app": jts.StateDict(w=w.copy(), b=b.copy(), i=i.copy(), meta={"lr": 0.1, "name": "run7"})}


def _torch_state(w, b, i):
    return {"app": tts.StateDict(
        w=torch.from_numpy(w.copy()), b=torch.from_numpy(b.view(np.uint16).copy()).view(torch.bfloat16),
        i=torch.from_numpy(i.copy()), meta={"lr": 0.1, "name": "run7"})}


_CONT_COUNTERS = ("continuous.chunks_replicated", "continuous.chunks_skipped",
                  "continuous.bytes_replicated", "continuous.bytes_skipped")


def _run_loop(pkg, obs_mod, root, make_state):
    """Each step's (decoded manifest, chunk keys written, counter deltas)."""
    kw = dict(replica_roots=[f"{root}/peer"], chunk_size_bytes=CHUNK, preemption_hook=False)
    if pkg is tts:
        kw["device"] = "cpu"
    cc = pkg.ContinuousCheckpointer(f"{root}/local", **kw)
    out = []
    try:
        for s, arrays in enumerate(_np_states(), start=1):
            before = {n: obs_mod.counter(n).value for n in _CONT_COUNTERS}
            cc.step(make_state(*arrays), s)
            cc.drain()
            man = ContinuousStore(f"{root}/peer/r0").read_step_manifest(step_manifest_path(s))
            keys = {k for rec in man["leaves"].values() for k in rec["keys"]}
            out.append((man, keys, {n: obs_mod.counter(n).value - before[n] for n in _CONT_COUNTERS}))
    finally:
        cc.close()
    return out


def test_same_state_sequence_same_manifests_keys_and_counters(tmp_path):
    port = _run_loop(tts, tts.obs, str(tmp_path / "port"), _torch_state)
    jax = _run_loop(jts, jts.obs, str(tmp_path / "jax"), _jax_state)
    for s, (p, j) in enumerate(zip(port, jax), start=1):
        assert p[0] == j[0], f"step {s}: manifests differ"
        assert p[1] == j[1], f"step {s}: chunk keys differ"
        assert p[2] == j[2], f"step {s}: counters {p[2]} != {j[2]}"
    assert port[1][2]["continuous.chunks_replicated"] == 1  # the one changed chunk
    # retention left the same chunk files and step manifests in both
    for root in ("local", "peer"):
        trees = []
        for pkg in ("port", "jax"):
            base = tmp_path / pkg / root / "r0"
            trees.append(sorted(os.path.relpath(os.path.join(d, f), base)
                                for d, _s, fs in os.walk(base) for f in fs))
        assert trees[0] == trees[1], root


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_either_package_recovers_the_others_store_bitwise(tmp_path, writer):
    steps = _np_states()
    root = str(tmp_path)
    if writer == "port":
        _run_loop(tts, tts.obs, root, _torch_state)
    else:
        _run_loop(jts, jts.obs, root, _jax_state)
    w, b, i = steps[-1]
    store = f"{root}/peer/r0"
    jdest = {"app": jts.StateDict(w=np.zeros_like(w), b=np.zeros_like(b), i=np.zeros_like(i),
                                  meta={"lr": 0.0, "name": ""})}
    res = jcont.recover_state(jdest, peers=[store])
    assert res["step"] == 3
    assert jdest["app"]["w"].tobytes() == w.tobytes() and jdest["app"]["b"].tobytes() == b.tobytes()
    assert jdest["app"]["i"].tobytes() == i.tobytes() and jdest["app"]["meta"] == {"lr": 0.1, "name": "run7"}
    tdest = {"app": tts.StateDict(w=torch.zeros(N), b=torch.zeros(2048, dtype=torch.bfloat16),
                                  i=torch.zeros(1000, dtype=torch.int64), meta={"lr": 0.0, "name": ""})}
    res = _recover(tdest, local=store)
    assert res["step"] == 3 and res["source"] == "local"
    got = tdest["app"]
    assert got["w"].numpy().tobytes() == w.tobytes()
    assert got["b"].view(torch.uint16).numpy().tobytes() == b.tobytes()
    assert got["i"].numpy().tobytes() == i.tobytes() and got["meta"] == {"lr": 0.1, "name": "run7"}
