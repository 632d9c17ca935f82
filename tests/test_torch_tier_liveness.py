"""The pieces the port's tier borrows from the fleet subsystems, against
the JAX package's: liveness stamps and dead-rank detection
(``resilience/liveness.py``) driven through the same scripted KV
history; the topology model and replica placement
(``topology/model.py``, ``TieredStoragePlugin._pick_replica_targets``)
over a grid of ranks, peer counts and explicit topologies; the promoter
skipping a dead peer only after re-proving durable residency; the
promoter's bounded drain; and peer replicas across two ranks in
subprocesses, restored with no durable tier and one host's fast root
lost.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu.resilience import liveness as jlive
from torchsnapshot_tpu.storage import url_to_storage_plugin as jurl
from torchsnapshot_tpu.topology import model as jtopo
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.io_types import WriteIO
from torchsnapshot_tpu_torch.resilience import liveness as tlive
from torchsnapshot_tpu_torch.storage import url_to_storage_plugin as turl
from torchsnapshot_tpu_torch.tier import get_promoter
from torchsnapshot_tpu_torch.tier.promoter import PromotionGroup
from torchsnapshot_tpu_torch.topology import model as ttopo
from torchsnapshot_tpu_torch.test_utils import run_multiprocess


@pytest.fixture(autouse=True)
def _drained_promoter():
    yield
    get_promoter().resume()
    tts.drain_promotions(raise_on_error=False, timeout_s=120)


class _KV:
    """A coordinator of ``world`` ranks seen from ``rank``: a dict for a
    KV, enough for both packages' liveness classes."""

    def __init__(self, rank, world, kv=None):
        self.rank, self.world_size = rank, world
        self.kv = {} if kv is None else kv

    def kv_set(self, key, value):
        self.kv[key] = value

    def kv_try_get(self, key):
        return self.kv.get(key)

    def kv_try_delete(self, key):
        self.kv.pop(key, None)


def test_liveness_declares_the_same_ranks_dead_as_the_jax_monitor():
    """One scripted history of stamps (rank 1 advances, rank 2 freezes,
    rank 3 never stamps), sampled by both packages' monitors: the same
    dead sets at every step, with and without the absence rule."""
    with tknobs.override_liveness_timeout_s(0.3), tknobs.override_liveness_interval_s(0.01), \
            jknobs.override_liveness_timeout_s(0.3), jknobs.override_liveness_interval_s(0.01):
        kv = {}
        coord = _KV(0, 4, kv)
        monitors = {
            (pkg, absent): mod.LivenessMonitor(coord, "op/7", absent_after_s=absent)
            for pkg, mod in (("port", tlive), ("jax", jlive))
            for absent in (None, 0.3)
        }
        history = []
        t0 = time.monotonic()
        seq = 0
        while time.monotonic() - t0 < 0.9:
            kv["op/7/hb/1"] = str(seq)
            if seq < 3:
                kv["op/7/hb/2"] = str(seq)
            seq += 1
            history.append({k: m.dead_ranks() for k, m in monitors.items()})
            time.sleep(0.02)
        for snap in history:
            for absent in (None, 0.3):
                assert snap["port", absent] == snap["jax", absent], snap
        assert history[-1]["port", None] == [2]
        assert history[-1]["port", 0.3] == [2, 3]
        with pytest.raises(tlive.RankDeadError) as e:
            monitors["port", None].check()
        assert e.value.dead_ranks == [2]


def test_liveness_session_stamps_and_clears_its_key():
    kv = {}
    with tknobs.override_liveness_interval_s(0.01):
        session = tlive.LivenessSession(_KV(1, 2, kv), "op/3").start()
        deadline = time.monotonic() + 10
        while int(kv.get("op/3/hb/1", "-1")) < 3:
            assert time.monotonic() < deadline, kv
            time.sleep(0.01)
        session.stop()
    assert "op/3/hb/1" not in kv
    # a world of one publishes nothing
    kv1 = {}
    tlive.LivenessSession(_KV(0, 1, kv1), "op/4").start().stop()
    assert kv1 == {}


_SPECS = [None, "flat", "0,0,1,1", "0,1,0,1", "0/h0,0/h0,1/h1,1/h2", "0,0,0,1,1,1",
          "0/a,0/b,1/a,1/b,2/c,2/c", "0,1", "0,0,0,0,0,0"]


def _topologies(spec, rank, n):
    if spec is None:
        return None, None
    if spec == "flat":
        return ttopo.Topology.flat(rank, n), jtopo.Topology.flat(rank, n)
    return ttopo.Topology.from_spec(spec, rank, n), jtopo.Topology.from_spec(spec, rank, n)


def test_topology_and_replica_targets_equal_the_jax_packages(tmp_path):
    """For every explicit topology (and none, and flat), every rank,
    peer counts 2-6 and replica counts 1-3: the same ``Topology`` fields,
    ``replica_preference``, candidate order and
    replica targets as the JAX package's."""
    checked = 0
    for n in range(2, 7):
        for spec in _SPECS:
            if spec not in (None, "flat") and len(spec.split(",")) != n:
                continue
            peers = [f"memory://tierplace{n}/fast{r}" for r in range(n)]
            for rank in range(n):
                t, j = _topologies(spec, rank, n)
                if t is not None:
                    assert (t.slice_of, t.host_of, t.explicit) == (j.slice_of, j.host_of, j.explicit)
                    assert t.replica_preference() == j.replica_preference()
                    assert t.describe() == j.describe()
                assert ttopo.replica_candidate_order(t, rank, n) == jtopo.replica_candidate_order(j, rank, n)
                for count in (1, 2, 3):
                    opts = {"tier": {"fast_url": peers[rank], "replica_count": count,
                                     "peer_fast_urls": peers}}
                    tp = turl(str(tmp_path / "d"), opts)
                    jp = jurl(str(tmp_path / "d"), opts)
                    assert tp._pick_replica_targets(peers, rank, t) == jp._pick_replica_targets(peers, rank, j)
                    assert tp._peers_for_read(f"{rank}/app/w") == jp._peers_for_read(f"{rank}/app/w")
                    checked += 1
    assert checked > 200
    # an unusable spec runs flat in both, and the slice hint is the knob's
    coord = tts.LocalCoordinator()
    with tknobs.override_topology("0,1"):
        assert not tts.topology.detect_topology(coord).explicit
    with tknobs.override_topology_slice_id(3):
        topo = tts.topology.detect_topology(coord)
        assert topo.explicit and tts.topology.current_topology_info() == topo.describe()


def test_replicas_land_on_the_jax_packages_peers(tmp_path):
    """``finalize_take`` mirrors the payloads, and the commit write the
    metadata, into the same peer fast roots as the JAX plugin."""
    trees = {}
    for name, urlfn, coord in (("port", turl, tts.LocalCoordinator()),
                               ("jax", jurl, jts.LocalCoordinator())):
        roots = [str(tmp_path / name / f"fast{i}") for i in range(3)]
        plugin = urlfn(str(tmp_path / name / "dur"), {"tier": {
            "fast_url": roots[0], "policy": "write_through", "replica_count": 1,
            "peer_fast_urls": roots}})
        wio = WriteIO if name == "port" else jts.io_types.WriteIO
        plugin.sync_write(wio(path="0/obj_a", buf=b"payload-a"))
        plugin.sync_write(wio(path="0/obj_b", buf=b"payload-b"))
        plugin.finalize_take(coord, "commit/0")
        plugin.sync_write(wio(path=".snapshot_metadata", buf=b"{}", durable=True))
        plugin.sync_close()
        trees[name] = sorted(
            (os.path.relpath(os.path.join(dp, f), tmp_path / name), open(os.path.join(dp, f), "rb").read())
            for dp, _, fs in os.walk(tmp_path / name) for f in fs
        )
    assert trees["port"] == trees["jax"]
    assert ("fast1/0/obj_a", b"payload-a") in trees["port"]
    assert not any(p.startswith("fast2/") for p, _ in trees["port"])


def _take_for_promotion(tmp_path):
    fast, dur = str(tmp_path / "fast"), str(tmp_path / "dur")
    get_promoter().pause()
    with tknobs.override_disable_batching(True):
        tts.Snapshot.take(dur, {"app": tts.StateDict(a=torch.arange(64.0), b=torch.arange(32))},
                          storage_options={"tier": {"fast_url": fast, "policy": "write_back"}})
    get_promoter().resume()
    tts.drain_promotions(timeout_s=60)
    shutil.rmtree(dur)
    locs = sorted(tts.Snapshot(fast).metadata.objects)
    assert len(locs) == 2
    return fast, dur, locs


@pytest.mark.parametrize("complete", [True, False])
def test_promoter_skips_a_dead_peer_only_after_the_residency_proof(tmp_path, complete):
    """Rank 0 of a world of two; rank 1 never stamps its heartbeat nor
    publishes its done key.  It is declared dead after the liveness
    timeout and skipped; the durable marker lands only when every
    manifest location is durable (rank 1 died after its copies landed),
    and is withheld otherwise."""
    fast, dur, locs = _take_for_promotion(tmp_path)
    group = PromotionGroup(fast, dur)
    group.paths = set(locs if complete else locs[:1])
    group.coordinator = tts.FileCoordinator(str(tmp_path / "kv"), 0, 2)
    group.uid = "commit/0"
    dead0 = tts.obs.counters().get(tts.obs.TAKEOVER_PROMOTER_DEAD_PEERS, 0)
    with tknobs.override_liveness_timeout_s(0.3), tknobs.override_liveness_interval_s(0.02):
        promoter = get_promoter()
        promoter.enqueue_data(group)
        promoter.enqueue_commit(group)
        if complete:
            tts.drain_promotions(timeout_s=60)
        else:
            with pytest.raises(RuntimeError, match="promotion job"):
                tts.drain_promotions(timeout_s=60)
    assert tts.obs.counters()[tts.obs.TAKEOVER_PROMOTER_DEAD_PEERS] == dead0 + 1
    assert os.path.exists(os.path.join(dur, ".snapshot_metadata")) == complete
    assert group.coordinator.kv_try_get("commit/0/tierdone/0") == "ok"
    # the data job's heartbeat left no stamp behind
    assert group.coordinator.kv_try_get("commit/0/tier/hb/0") is None


def test_drain_deadline_names_the_unfinished_work(tmp_path):
    get_promoter().pause()
    tts.Snapshot.take(str(tmp_path / "dur"), {"app": tts.StateDict(a=torch.arange(8.0))},
                      storage_options={"tier": {"fast_url": str(tmp_path / "fast"), "policy": "write_back"}})
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 job\\(s\\) unfinished after 0.2 s"):
        tts.drain_promotions(timeout_s=0.2)
    assert time.monotonic() - t0 < 5
    get_promoter().resume()
    tts.drain_promotions(timeout_s=60)
    assert (tmp_path / "dur" / ".snapshot_metadata").exists()


_REPLICA_TAKE = """
import os
fast_roots = [snap_dir + f"_fast{r}" for r in range(world)]
opts = {"tier": {"fast_url": fast_roots[rank], "policy": "write_back",
                 "replica_count": 1, "peer_fast_urls": fast_roots}}
state = tts.StateDict(mine=torch.full((1024,), float(rank), dtype=torch.float64),
                      shared=torch.arange(64, dtype=torch.float64))
tts.Snapshot.take(snap_dir, {"app": state}, replicated=["app/shared"], coordinator=coord,
                  storage_options=opts)
tts.drain_promotions(timeout_s=60)
"""

_REPLICA_RESTORE = """
import os
coord = tts.FileCoordinator({kv!r}, rank, world)
snap_dir = {snap!r}
fast_roots = [snap_dir + f"_fast{{r}}" for r in range(world)]
opts = {{"tier": {{"fast_url": fast_roots[rank], "policy": "write_back",
                  "replica_count": 1, "peer_fast_urls": fast_roots}}}}
dest = tts.StateDict(mine=torch.zeros(1024, dtype=torch.float64),
                     shared=torch.zeros(64, dtype=torch.float64))
tts.Snapshot(snap_dir, coordinator=coord, storage_options=opts).restore({{"app": dest}}, device="cpu")
assert torch.equal(dest["mine"], torch.full((1024,), float(rank), dtype=torch.float64)), rank
assert torch.equal(dest["shared"], torch.arange(64, dtype=torch.float64))
assert not os.path.exists(snap_dir), "the restore touched the durable tier"
"""


def test_lost_host_restores_from_peer_replicas_across_two_ranks(tmp_path):
    run_multiprocess(tmp_path, 2, _REPLICA_TAKE, timeout_s=120)
    snap_dir = str(tmp_path / "snap")
    for r, peer in ((0, 1), (1, 0)):
        own = {
            os.path.relpath(os.path.join(dp, f), f"{snap_dir}_fast{r}")
            for dp, _, fs in os.walk(f"{snap_dir}_fast{r}") for f in fs
            if f != ".snapshot_obsrecord"  # telemetry: never replicated
        }
        assert own, r
        for rel in own:
            assert os.path.exists(os.path.join(f"{snap_dir}_fast{peer}", rel)), (r, rel)
    # the JAX package reads the promoted durable step at world 1
    got = jts.Snapshot(snap_dir).read_object("0/app/shared")
    assert np.array_equal(got, np.arange(64, dtype=np.float64))
    shutil.rmtree(snap_dir)
    shutil.rmtree(f"{snap_dir}_fast0")
    body = _REPLICA_RESTORE.format(kv=str(tmp_path / "kv2"), snap=snap_dir)
    (tmp_path / "r2").mkdir()
    run_multiprocess(tmp_path / "r2", 2, body, timeout_s=120)
