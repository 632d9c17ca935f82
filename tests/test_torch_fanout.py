"""Topology-aware writer election and the fan-out restore, in the port,
against the JAX package.

The pure functions (``_topology_chooser``,
``partition_replicated_writes(topology=)``,
``assign_box_writers(topology=)``, ``elect_takeover_writers``,
``shared_read_locations``, ``ordered_shared_locations``,
``fanout_enabled``, ``fanout_world_uniform``) equal the JAX package's on
inputs drawn from a seed.  Then processes over one ``FileCoordinator``
directory (the KV engine): a two-rank fan-out restore over a one-slice,
two-host topology makes one durable read per shared object for the slice
and restores bitwise (mapped reads on and off), with its blobs cleaned
up; a designated reader that dies is replaced by the next candidate,
whose publication serves the remaining sibling; and a JAX-written
world-2 snapshot is fanned out by the port.
"""

import json
import os
import subprocess
import sys
import textwrap
from collections import namedtuple

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu.partitioner as jpart
import torchsnapshot_tpu.preparers.sharded as jsharded
import torchsnapshot_tpu.topology as jtopo
import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.partitioner as tpart
import torchsnapshot_tpu_torch.preparers.sharded as tsharded
import torchsnapshot_tpu_torch.topology as ttopo
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu_torch import knobs as tknobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_Dev = namedtuple("_Dev", "process_index")


def _specs(rng, world):
    """A few topology specs of ``world`` ranks: explicit slices with and
    without host ids, and a non-explicit (flat) one."""
    slices = rng.integers(0, max(1, world // 2), world)
    hosts = rng.integers(0, max(1, world - 1), world)
    return [
        ",".join(str(s) for s in slices),
        ",".join(f"{s}/h{h}" for s, h in zip(slices, hosts)),
        None,
    ]


def _topos(spec, world, rank=0):
    if spec is None:
        return ttopo.Topology.flat(rank, world), jtopo.Topology.flat(rank, world)
    return (
        ttopo.Topology.from_spec(spec, rank, world),
        jtopo.Topology.from_spec(spec, rank, world),
    )


def test_writer_elections_equal_jax():
    """``_topology_chooser`` keys after every charge,
    ``partition_replicated_writes``, ``assign_box_writers`` and
    ``elect_takeover_writers`` (with and without ``origin_of``) give the
    JAX package's answers for every topology drawn."""
    rng = np.random.default_rng(0)
    for trial in range(40):
        world = int(rng.integers(2, 9))
        preloads = [int(x) for x in rng.integers(0, 1000, world)]
        items = [(f"p{i}", int(rng.integers(1, 500))) for i in range(int(rng.integers(1, 30)))]
        boxes = {}
        for b in range(int(rng.integers(1, 8))):
            holders = sorted({int(x) for x in rng.integers(0, world, int(rng.integers(1, world + 1)))})
            boxes[((b * 4, 0), (int(rng.integers(1, 9)), 4))] = holders
        dead = sorted({int(x) for x in rng.integers(0, world, int(rng.integers(1, world)))})
        if len(dead) == world:
            dead = dead[:-1]
        orphans = items[: max(1, len(items) // 2)]
        origin_of = {p: dead[i % len(dead)] for i, (p, _) in enumerate(orphans)}
        for spec in _specs(rng, world):
            t, j = _topos(spec, world)
            if t.explicit:
                tl, jl = list(preloads), list(preloads)
                (tkey, tcharge), (jkey, jcharge) = (
                    tpart._topology_chooser(t, tl), jpart._topology_chooser(j, jl)
                )
                for r, n in [(int(x), int(y)) for x, y in rng.integers(0, world, (5, 2))]:
                    assert [tkey(q) for q in range(world)] == [jkey(q) for q in range(world)]
                    tcharge(r, n * 10)
                    jcharge(r, n * 10)
            assert tpart.partition_replicated_writes(items, world, preloads, topology=t) == \
                jpart.partition_replicated_writes(items, world, preloads, topology=j), (trial, spec)
            tl, jl = list(preloads), list(preloads)
            got = tsharded.assign_box_writers(boxes, 4, world, preloads=tl, topology=t)
            want = jsharded.assign_box_writers(
                {b: [_Dev(p) for p in h] for b, h in boxes.items()}, 4, world, preloads=jl, topology=j,
            )
            assert got == want and tl == jl, (trial, spec)
            for oo in (None, origin_of):
                assert tpart.elect_takeover_writers(
                    orphans, dead, world, preloads, topology=t, origin_of=oo
                ) == jpart.elect_takeover_writers(
                    orphans, dead, world, preloads, topology=j, origin_of=oo
                ), (trial, spec)
    with pytest.raises(ValueError):
        tpart.elect_takeover_writers([("a", 1)], [0, 1], 2)
    # a live rank of the dead writer's slice is preferred
    t4 = ttopo.Topology.from_spec("0,0,1,1", 0, 4)
    assert tpart.elect_takeover_writers([("a", 100)], [3], 4, topology=t4, origin_of={"a": 3}) == {"a": 2}


def test_shared_locations_and_fanout_decisions_equal_jax(tmp_path):
    """On the manifest of a take with replicated whole, chunked and
    slab-batched leaves, ``shared_read_locations`` and
    ``ordered_shared_locations`` equal the JAX functions'; and
    ``fanout_enabled``/``fanout_world_uniform`` agree over topologies,
    FANOUT modes and the shared cache knob."""
    state = tts.StateDict(
        big=torch.arange(1024, dtype=torch.float32),
        chunked=torch.arange(3000, dtype=torch.float64),
        small_a=torch.ones(4), small_b=torch.zeros(3), mine=torch.ones(2),
    )
    path = str(tmp_path / "snap")
    with tknobs.override_max_chunk_size_bytes(8192), tknobs.override_slab_size_threshold_bytes(1024):
        tts.Snapshot.take(path, {"a": state, "b": tts.StateDict(x=torch.ones(5))},
                          replicated=["a/big", "a/chunked", "a/small_*", "b/**"])
    tman = tts.Snapshot(path).metadata.manifest
    jman = jts.Snapshot(path).metadata.manifest
    shared = ttopo.shared_read_locations(tman)
    assert shared == jtopo.shared_read_locations(jman)
    assert "replicated/a/big" in shared and len([p for p in shared if "chunked" in p]) > 1
    assert not any("small" in p for p in shared)  # slab-batched under the rank
    for order in (["a", "b"], ["b", "a"], ["b"]):
        assert ttopo.ordered_shared_locations(tman, shared, order) == \
            jtopo.ordered_shared_locations(jman, shared, order)
    rng = np.random.default_rng(1)
    for world in (1, 2, 4):
        for spec in _specs(rng, world) + ["0/h0," * (world - 1) + "0/h0"]:
            for mode in ("auto", "on", "off"):
                for cache in (None, str(tmp_path / "cache")):
                    t, j = _topos(spec, world, rank=world - 1)
                    with tknobs.override_fanout(mode), jknobs.override_fanout(mode), \
                            tknobs.override_cache_dir(cache), jknobs.override_cache_dir(cache):
                        assert ttopo.fanout_enabled(t) == jtopo.fanout_enabled(j), (spec, mode, cache)
                        assert ttopo.fanout_world_uniform(t) == jtopo.fanout_world_uniform(j)


_RESTORE_BODY = """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import torch
    import torchsnapshot_tpu_torch as tts
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    coord = tts.FileCoordinator({kv!r}, rank, world)
    K, N = 4, 50_000
    want = {{f"w{{i}}": torch.arange(N, dtype=torch.float32) * (i + 1) for i in range(K)}}
    if {take!r}:
        tts.Snapshot.take({snap!r}, {{"m": tts.StateDict(**want)}}, replicated=["**"], coordinator=coord)
    got = tts.StateDict(**{{k: torch.zeros(N) for k in want}})
    tts.Snapshot({snap!r}, coordinator=coord).restore({{"m": got}}, device="cpu")
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    c = tts.obs.counters()
    print("RESULT " + json.dumps({{
        "durable": c.get("topology.fanout_durable_reads", 0),
        "saved": c.get("topology.durable_gets_saved", 0),
        "redistributed": c.get("topology.fanout_bytes_redistributed", 0),
        "fallbacks": c.get("topology.fanout_fallbacks", 0),
        "kv_bytes": c.get("transport.kv_bytes", 0),
    }}))
"""


def _run(tmp_path, name, body, world, env, tag="RESULT ", timeout=90):
    script = tmp_path / f"{name}.py"
    script.write_text(textwrap.dedent(body))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(world)],
                         env={**os.environ, **env}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)
    ]
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, out in zip(procs, outs):
        line = next((ln for ln in out.splitlines() if ln.startswith(tag)), None)
        results.append((p.returncode, json.loads(line[len(tag):]) if line else None, out))
    return results


_FANOUT_ENV = {
    "TORCHSNAPSHOT_TPU_TORCH_TOPOLOGY": "0/h0,0/h1",
    "TORCHSNAPSHOT_TPU_TORCH_DISABLE_BATCHING": "1",
}


@pytest.mark.parametrize("mmap", ["1", "0"])
def test_two_rank_fanout_restore_reads_once_per_slice(tmp_path, mmap):
    """One slice over two hosts: each of the K replicated objects is read
    from the durable tier once for the slice and handed to the other
    rank as a KV blob (``durable_gets_saved`` K, the objects' bytes
    redistributed), bitwise under mapped reads and copying reads alike;
    the KV directory holds no fan-out key afterwards."""
    kv = str(tmp_path / "kv")
    body = _RESTORE_BODY.format(repo=REPO, kv=kv, snap=str(tmp_path / "snap"), take=True)
    results = _run(tmp_path, "w", body, 2, {**_FANOUT_ENV, "TORCHSNAPSHOT_TPU_TORCH_MMAP": mmap})
    for rc, res, out in results:
        assert rc == 0 and res is not None, out
    K, N = 4, 50_000
    total = {k: sum(res[k] for _, res, _ in results) for k in results[0][1]}
    assert total["durable"] == K and total["saved"] == K and total["fallbacks"] == 0, total
    assert total["redistributed"] == K * N * 4 and total["kv_bytes"] >= 2 * K * N * 4
    assert not [n for n in os.listdir(kv) if "%2Ffan%2F" in n]


_DEAD_READER_BODY = """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.io_types import ReadIO
    from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin
    from torchsnapshot_tpu_torch.topology import FanoutReadPlugin, Topology
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    coord = tts.FileCoordinator({kv!r}, rank, world)
    topo = Topology.from_spec("0,0,0", rank, world)
    cands = topo.reader_candidates("replicated/l0")
    if rank == cands[0]:
        os._exit(17)  # the designated reader died before reading
    plugin = FanoutReadPlugin(FSStoragePlugin(root={root!r}), coord, topo, "fantakeover", ["replicated/l0"])
    io = ReadIO(path="replicated/l0")
    plugin.sync_read(io)
    got = np.frombuffer(bytes(memoryview(io.buf).cast("B")), np.float32)
    assert np.array_equal(got, np.arange(1024, dtype=np.float32))
    c = tts.obs.counters()
    print("RESULT " + json.dumps({{
        "rank": rank, "fallbacks": c.get("topology.fanout_fallbacks", 0),
        "durable": c.get("topology.fanout_durable_reads", 0),
    }}))
"""


def test_dead_designated_reader_is_replaced_by_the_next_candidate(tmp_path):
    """Three ranks of one slice; the designated reader of an object dies
    before reading.  After one ``FANOUT_TIMEOUT_S`` window the next
    candidate reads and publishes (one fallback, one durable read), and
    the third rank is served from that publication (no direct read),
    all within the bounded windows."""
    root = tmp_path / "objs"
    (root / "replicated").mkdir(parents=True)
    (root / "replicated" / "l0").write_bytes(np.arange(1024, dtype=np.float32).tobytes())
    body = _DEAD_READER_BODY.format(repo=REPO, kv=str(tmp_path / "kv"), root=str(root))
    results = _run(tmp_path, "dead", body, 3, {"TORCHSNAPSHOT_TPU_TORCH_FANOUT_TIMEOUT_S": "1"}, timeout=60)
    cands = ttopo.Topology.from_spec("0,0,0", 0, 3).reader_candidates("replicated/l0")
    assert cands == jtopo.Topology.from_spec("0,0,0", 0, 3).reader_candidates("replicated/l0")
    assert results[cands[0]][0] == 17
    for r in cands[1:]:
        assert results[r][0] == 0, results[r][2]
    assert {k: results[cands[1]][1][k] for k in ("fallbacks", "durable")} == {"fallbacks": 1, "durable": 1}
    assert {k: results[cands[2]][1][k] for k in ("fallbacks", "durable")} == {"fallbacks": 0, "durable": 0}


def test_jax_world2_snapshot_fanned_out_by_the_port(tmp_path):
    """A snapshot two JAX processes took (replicated state) is restored
    by two port processes with fan-out: one durable read per object for
    the slice, bitwise."""
    snap = str(tmp_path / "snap")
    jbody = f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        from torchsnapshot_tpu import FileCoordinator, Snapshot, StateDict
        rank, world = int(sys.argv[1]), int(sys.argv[2])
        coord = FileCoordinator({str(tmp_path / "jkv")!r}, rank, world)
        state = StateDict(**{{f"w{{i}}": np.arange(50_000, dtype=np.float32) * (i + 1) for i in range(4)}})
        Snapshot.take({snap!r}, {{"m": state}}, replicated=["**"], coordinator=coord)
        print("RESULT {{}}")
    """
    jenv = {"PYTHONPATH": "", "JAX_PLATFORMS": "cpu", "TORCHSNAPSHOT_TPU_DISABLE_BATCHING": "1"}
    for rc, _, out in _run(tmp_path, "jax", jbody, 2, jenv):
        assert rc == 0, out
    body = _RESTORE_BODY.format(repo=REPO, kv=str(tmp_path / "kv"), snap=snap, take=False)
    results = _run(tmp_path, "port", body, 2, _FANOUT_ENV)
    for rc, res, out in results:
        assert rc == 0 and res is not None, out
    assert sum(res["durable"] for _, res, _ in results) == 4
    assert sum(res["saved"] for _, res, _ in results) == 4


def test_flight_record_stamps_and_slice_rollup_equal_jax(tmp_path, monkeypatch):
    """After an explicit topology was detected and a transport resolved,
    a rank's flight-record payload carries the JAX package's
    ``topology`` and ``transport`` stamps, and the per-slice rollup of two
    ranks' payloads equals the JAX package's."""
    import torchsnapshot_tpu.coordination as jcoord
    import torchsnapshot_tpu.obs.aggregate as jagg
    import torchsnapshot_tpu.topology.model as jmodel
    import torchsnapshot_tpu.transport as jtransport
    import torchsnapshot_tpu_torch.obs.aggregate as tagg
    import torchsnapshot_tpu_torch.topology.model as tmodel
    import torchsnapshot_tpu_torch.transport as ttransport

    # the detected placement and the last engine are process-wide: later
    # tests in this process get them back as they were
    for mod, name in ((tmodel, "_CURRENT"), (jmodel, "_CURRENT"),
                      (ttransport, "_last_engine"), (jtransport, "_last_engine")):
        monkeypatch.setattr(mod, name, getattr(mod, name))

    with tknobs.override_topology("0/h0,0/h1"), jknobs.override_topology("0/h0,0/h1"), \
            tknobs.override_transport("kv"), jknobs.override_transport("kv"):
        ttopo.detect_topology(tts.FileCoordinator(str(tmp_path / "t"), 1, 2))
        jtopo.detect_topology(jcoord.FileCoordinator(str(tmp_path / "j"), 1, 2))
        ttransport.resolve_transport(tts.LocalCoordinator(), device="cpu")
        jtransport.resolve_transport(jcoord.LocalCoordinator())
    tp = tagg.rank_payload(1, "restore", tagg.capture())
    jp = jagg.rank_payload(1, "restore", jagg.capture())
    assert tp["topology"] == jp["topology"] == {
        "slice": 0, "host": 1, "num_slices": 1, "num_hosts": 2, "explicit": True,
    }
    assert tp["transport"] == jp["transport"] and tp["transport"]["engine"] == "kv"
    counters = {
        "topology.replicated_objects_written": 3, "topology.fanout_durable_reads": 2,
        "topology.durable_gets_saved": 5, "topology.fanout_bytes_redistributed": 1000,
    }
    payloads = [
        {"rank": r, "topology": {**tp["topology"], "host": r}, "metrics": {"counters": counters}}
        for r in (1, 0)
    ]
    assert tagg._topology_rollup(payloads) == jagg._topology_rollup(payloads)
    assert tagg._topology_rollup(payloads)["slices"]["0"]["ranks"] == [0, 1]


class _AcceptingSession:
    """A collective session stub that covers every key and accepts every
    offer (the source's branch where the session owns delivery)."""

    def __init__(self):
        self.offers = []

    def covers(self, key):
        return True

    def offer(self, key, data, kv_prefix):
        self.offers.append((key, len(data)))
        return True

    def decline(self, key):
        raise AssertionError("a whole read is never declined")


class _BytesPlugin:
    """An inner plugin serving one payload per path."""

    def __init__(self, payloads):
        self.payloads = payloads

    async def read(self, read_io):
        read_io.buf = bytes(self.payloads[read_io.path])


def test_collective_session_offer_counts_as_the_jax_package(tmp_path):
    """A designated reader whose payloads a collective session accepts
    advances the fan-out counters exactly as the JAX package does: one
    durable read each, and no publication or redistributed byte of its
    own (the session delivers)."""
    import asyncio

    import torchsnapshot_tpu.io_types as jio
    import torchsnapshot_tpu.obs as jobs
    import torchsnapshot_tpu.topology.fanout as jfan
    import torchsnapshot_tpu_torch.io_types as tio
    import torchsnapshot_tpu_torch.topology.fanout as tfan

    rng = np.random.default_rng(16)
    payloads = {f"0/obj_{i}": rng.integers(0, 256, 1000 + 37 * i, dtype=np.uint8).tobytes()
                for i in range(6)}
    names = ("topology.fanout_durable_reads", "topology.fanout_publishes",
             "topology.fanout_bytes_redistributed", "topology.fanout_fallbacks")
    coord = namedtuple("_Coord", "rank world_size")(0, 2)
    deltas = {}
    for label, fan, obs_mod, topo_mod, io_mod in (
        ("port", tfan, tts.obs, ttopo, tio),
        ("jax", jfan, jobs, jtopo, jio),
    ):
        topo = topo_mod.Topology.from_spec("0,0", 0, 2)
        mine = [p for p in payloads if topo.designated_reader(p) == 0]
        assert mine, "rank 0 reads none of the paths"
        plugin = fan.FanoutReadPlugin(_BytesPlugin(payloads), coord, topo, "u16", mine)
        session = _AcceptingSession()
        plugin.transport_session = session
        before = {n: obs_mod.counter(n).value for n in names}

        async def _reads():
            for p in mine:
                rio = io_mod.ReadIO(path=p)
                await plugin.read(rio)
                assert bytes(memoryview(rio.buf).cast("B")) == payloads[p]

        asyncio.run(_reads())
        deltas[label] = {n: obs_mod.counter(n).value - before[n] for n in names}
        assert len(session.offers) == len(mine)
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"]["topology.fanout_publishes"] == 0
