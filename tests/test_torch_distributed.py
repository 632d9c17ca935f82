"""Take and restore across many ranks of one host, in the port, against
the JAX package: N subprocesses coordinate through a ``FileCoordinator``
over a shared directory or a ``TorchStoreCoordinator`` over a
``TCPStore`` on localhost.

Covers replicated writes split across ranks and restored at world 2 and
world 1 (bitwise, by both packages), a JAX package snapshot restored by
the port, the async commit barrier, a peer's failure raising a typed
abort with no metadata written, divergent "replicated" state demoted to
per-rank entries, a replicated chunked array split across ranks, the
``Replicated`` marker and DDP inference (gloo DDP on the CPU), and the
replication fingerprint against the JAX package's.  Each subprocess run
has a timeout of its own.
"""

import os
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.resilience.abort import SnapshotAbortedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMEOUT_S = 60


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(tmp_path, world, body, package="port", kind="file", kv="kv"):
    """Run ``body`` (python source; names: rank, world, coord, snap_dir,
    np, torch, tts or the JAX package's names) in ``world`` processes;
    fail the test if any fails or outlives the timeout.  ``kind``: the
    coordinator ("file", "store", or "gloo": a process group whose store
    the default coordinator uses)."""
    port = _free_port()
    if package == "port":
        head = f"""
            import sys
            sys.path.insert(0, {REPO!r})
            import numpy as np
            import torch
            import torchsnapshot_tpu_torch as tts
            rank, world = int(sys.argv[1]), int(sys.argv[2])
            snap_dir = {str(tmp_path / "snap")!r}
            if {kind!r} == "file":
                coord = tts.FileCoordinator({str(tmp_path / kv)!r}, rank, world)
            elif {kind!r} == "store":
                import datetime
                from torch.distributed import TCPStore
                store = TCPStore("127.0.0.1", {port}, world, is_master=rank == 0,
                                 timeout=datetime.timedelta(seconds={_TIMEOUT_S}))
                coord = tts.TorchStoreCoordinator(store, rank, world)
            else:
                import torch.distributed as dist
                dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                                        rank=rank, world_size=world)
                coord = tts.get_default_coordinator()
                assert isinstance(coord, tts.TorchStoreCoordinator), type(coord)
            """
        env = {**os.environ}
    else:
        head = f"""
            import sys
            sys.path.insert(0, {REPO!r})
            import numpy as np
            from torchsnapshot_tpu import FileCoordinator, Snapshot, StateDict
            rank, world = int(sys.argv[1]), int(sys.argv[2])
            coord = FileCoordinator({str(tmp_path / kv)!r}, rank, world)
            snap_dir = {str(tmp_path / "snap")!r}
            """
        env = {**os.environ, "PYTHONPATH": "", "JAX_PLATFORMS": "cpu"}
    script = tmp_path / f"worker_{package}_{kv}.py"
    script.write_text(textwrap.dedent(head) + textwrap.dedent(body))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(r), str(world)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"worker {r} failed:\n{out}")
    return outs


_TAKE_BODY = """
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Linear(64, 16))
    state = tts.StateDict(
        shared=torch.arange(4096, dtype=torch.float64),   # replicated by glob
        local=torch.full((8,), float(rank)),               # per rank
        tag=f"rank{rank}",
    )
    written = lambda: tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0)
    w0 = written()
    tts.Snapshot.take(snap_dir, {"app": state, "model": tts.Replicated(model)},
                      replicated=["app/shared"], coordinator=coord)
    print("wrote", written() - w0)
    # restore at world 2 into fresh state
    model2 = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Linear(64, 16))
    dest = tts.StateDict(shared=torch.zeros(4096, dtype=torch.float64), local=torch.zeros(8), tag="")
    tts.Snapshot(snap_dir, coordinator=coord).restore({"app": dest, "model": tts.Replicated(model2)})
    assert torch.equal(dest["shared"], state["shared"])
    assert torch.equal(dest["local"], state["local"]) and dest["tag"] == f"rank{rank}"
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)
"""


def _model_state():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Linear(64, 16)).state_dict()


@pytest.mark.parametrize("kind", ["file", "store"])
def test_two_rank_take_restores_at_world_2_and_1_in_both_packages(tmp_path, kind):
    outs = run_workers(tmp_path, 2, _TAKE_BODY, kind=kind)
    wrote = [int(line.split()[1]) for o in outs for line in o.splitlines() if line.startswith("wrote")]
    # the replicated bytes (model + shared, ~43 KB) are split: each rank
    # writes a share, neither all of them
    assert len(wrote) == 2 and all(w > 8000 for w in wrote), wrote
    snap = tts.Snapshot(str(tmp_path / "snap"))
    manifest = snap.metadata.manifest
    assert snap.metadata.world_size == 2
    assert [k for k in manifest if k.endswith("app/shared")] in (["0/app/shared"], ["1/app/shared"])
    assert "0/app/local" in manifest and "1/app/local" in manifest
    # world 1: rank 0's per-rank state plus every replicated entry
    want = _model_state()
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Linear(64, 16))
    dest = tts.StateDict(shared=torch.zeros(4096, dtype=torch.float64), local=torch.ones(8), tag="")
    snap.restore({"app": dest, "model": tts.Replicated(model)})
    assert torch.equal(dest["shared"], torch.arange(4096, dtype=torch.float64))
    assert torch.equal(dest["local"], torch.zeros(8)) and dest["tag"] == "rank0"
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v)
    # the JAX package restores the same snapshot at world 1, bitwise
    jdest = jts.StateDict(shared=np.zeros(4096), local=np.ones(8, np.float32), tag="")
    jmodel = jts.StateDict({k: np.zeros(tuple(v.shape), np.float32) for k, v in want.items()})
    jts.Snapshot(str(tmp_path / "snap")).restore({"app": jdest, "model": jmodel})
    assert np.array_equal(jdest["shared"], np.arange(4096, dtype=np.float64))
    assert np.array_equal(jdest["local"], np.zeros(8, np.float32)) and jdest["tag"] == "rank0"
    for k, v in want.items():
        assert jmodel[k].tobytes() == v.numpy().tobytes()
    assert jts.Snapshot(str(tmp_path / "snap")).read_object("1/app/tag") == "rank1"


def test_jax_two_rank_snapshot_restored_by_the_port_at_world_1_and_2(tmp_path):
    run_workers(tmp_path, 2, """
        state = StateDict(
            shared=np.arange(512, dtype=np.float32),
            local=np.full(8, float(rank)),
            step=100 + rank,
        )
        Snapshot.take(snap_dir, {"app": state}, replicated=["app/shared"], coordinator=coord)
        """, package="jax")
    dest = tts.StateDict(shared=torch.zeros(512), local=torch.ones(8, dtype=torch.float64), step=0)
    tts.Snapshot(str(tmp_path / "snap")).restore({"app": dest})
    assert torch.equal(dest["shared"], torch.arange(512, dtype=torch.float32))
    assert torch.equal(dest["local"], torch.zeros(8, dtype=torch.float64)) and dest["step"] == 100
    run_workers(tmp_path, 2, """
        dest = tts.StateDict(shared=torch.zeros(512), local=torch.zeros(8, dtype=torch.float64), step=0)
        tts.Snapshot(snap_dir, coordinator=coord).restore({"app": dest})
        assert torch.equal(dest["shared"], torch.arange(512, dtype=torch.float32))
        assert torch.equal(dest["local"], torch.full((8,), float(rank), dtype=torch.float64))
        assert dest["step"] == 100 + rank
        """, kv="kv2")


def test_async_take_commit_barrier(tmp_path):
    outs = run_workers(tmp_path, 2, """
        state = tts.StateDict(x=torch.full((64,), float(rank)), shared=torch.arange(100.0))
        pending = tts.Snapshot.async_take(snap_dir, {"app": state}, replicated=["app/shared"],
                                          coordinator=coord)
        state["x"].add_(5)  # after the return: not in the snapshot
        snap = pending.wait()
        assert (snap._metadata_cache is not None) == (rank == 0)
        out = tts.Snapshot(snap_dir).read_object(f"{rank}/app/x", device="cpu")
        assert torch.equal(out, torch.full((64,), float(rank)))
        print("rank", rank, "committed")
        """, kind="store")
    assert os.path.exists(tmp_path / "snap" / ".snapshot_metadata")
    assert all("committed" in o for o in outs)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_peer_failure_raises_a_typed_abort_and_writes_no_metadata(tmp_path, mode):
    """Rank 1's storage fails: rank 1 raises its own error, rank 0 a
    ``SnapshotAbortedError`` naming rank 1, both within 10 s; no
    ``.snapshot_metadata``."""
    outs = run_workers(tmp_path, 2, f"""
        import asyncio, time
        import torchsnapshot_tpu_torch.snapshot as snapmod
        from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

        class Faulty(FSStoragePlugin):
            async def write(self, write_io):
                await asyncio.sleep(0.2)
                raise OSError("rank1 disk failure")

        if rank == 1:
            snapmod.url_to_storage_plugin = lambda p: Faulty(root=p)
        state = tts.StateDict(x=torch.full((64,), float(rank)), big=torch.zeros(1 << 16))
        t0 = time.monotonic()
        try:
            if {mode!r} == "sync":
                tts.Snapshot.take(snap_dir, {{"app": state}}, coordinator=coord)
            else:
                tts.Snapshot.async_take(snap_dir, {{"app": state}}, coordinator=coord).wait()
        except tts.SnapshotAbortedError as e:
            assert rank == 0 and e.info.origin_rank == 1, e
            print("RESULT", rank, "aborted", time.monotonic() - t0)
        except OSError as e:
            assert rank == 1, e
            print("RESULT", rank, "failed", time.monotonic() - t0)
        else:
            raise AssertionError(f"rank {{rank}} did not observe the failure")
        """)
    assert not os.path.exists(tmp_path / "snap" / ".snapshot_metadata")
    for r, word in enumerate(("aborted", "failed")):
        line = next(line for line in outs[r].splitlines() if line.startswith(f"RESULT {r}"))
        assert word in line and float(line.split()[-1]) < 10, line


def test_peer_restore_failure_aborts_every_rank(tmp_path):
    """Rank 1 reads through a storage plugin that raises: rank 1 raises
    its own error and rank 0 a ``SnapshotAbortedError`` naming rank 1,
    both within 10 s (the port of the JAX package's
    ``test_chaos_multirank_restore_peer_fault_aborts_all_ranks``)."""
    outs = run_workers(tmp_path, 2, """
        import time
        import torchsnapshot_tpu_torch.snapshot as snapmod
        from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

        tts.Snapshot.take(snap_dir, {"app": tts.StateDict(w=torch.arange(128.0))}, coordinator=coord)

        class FailingReads(FSStoragePlugin):
            async def read(self, read_io):
                raise OSError(f"rank {rank}: injected read failure")

        if rank == 1:
            snapmod.url_to_storage_plugin = lambda p: FailingReads(root=p)
        dest = tts.StateDict(w=torch.zeros(128))
        t0 = time.monotonic()
        try:
            tts.Snapshot(snap_dir, coordinator=coord).restore({"app": dest})
        except tts.SnapshotAbortedError as e:
            assert rank == 0 and e.info.origin_rank == 1, e
            print("RESULT", rank, "aborted", time.monotonic() - t0)
        except OSError as e:
            assert rank == 1, e
            print("RESULT", rank, "failed", time.monotonic() - t0)
        else:
            raise AssertionError(f"rank {rank}: restore unexpectedly succeeded")
        """)
    for r, word in enumerate(("aborted", "failed")):
        line = next(line for line in outs[r].splitlines() if line.startswith(f"RESULT {r}"))
        assert word in line and float(line.split()[-1]) < 10, line


class _Rank1View(tts.LocalCoordinator):
    """Restores alone, as rank 1 of the snapshot's ranks sees it."""

    @property
    def rank(self):
        return 1


def test_degraded_snapshot_refuses_only_what_this_rank_would_read(tmp_path):
    """A JAX 2-rank snapshot whose ``degraded`` section names a path:
    rank 0 restores its intact private copy of rank 1's lost private
    path; rank 1 (the origin) raises ``DegradedSnapshotError``, and so
    does any rank when the lost path is replicated."""
    from torchsnapshot_tpu.manifest import SnapshotMetadata as JaxMetadata

    run_workers(tmp_path, 2, """
        state = StateDict(shared=np.arange(64, dtype=np.float32), local=np.full(8, float(rank)))
        Snapshot.take(snap_dir, {"app": state}, replicated=["app/shared"], coordinator=coord)
        """, package="jax")
    meta_path = tmp_path / "snap" / ".snapshot_metadata"
    committed = meta_path.read_text()

    def degrade(lpath):
        meta = JaxMetadata.from_yaml(committed)
        meta.degraded = {lpath: {"origin_rank": 1, "kind": "Array"}}
        meta_path.write_text(meta.to_yaml())

    def dest():
        return tts.StateDict(shared=torch.zeros(64), local=torch.full((8,), -1.0, dtype=torch.float64))

    degrade("app/local")
    d0 = dest()
    tts.Snapshot(str(tmp_path / "snap")).restore({"app": d0})
    assert torch.equal(d0["local"], torch.zeros(8, dtype=torch.float64))
    assert torch.equal(d0["shared"], torch.arange(64, dtype=torch.float32))
    d1 = dest()
    with pytest.raises(tts.DegradedSnapshotError, match="app/local"):
        tts.Snapshot(str(tmp_path / "snap"), coordinator=_Rank1View()).restore({"app": d1})
    degrade("app/shared")
    with pytest.raises(tts.DegradedSnapshotError, match="app/shared"):
        tts.Snapshot(str(tmp_path / "snap")).restore({"app": dest()})


def test_replication_verification_demotes_divergent_state(tmp_path):
    run_workers(tmp_path, 2, """
        state = tts.StateDict(
            shared=torch.arange(16, dtype=torch.float32),   # truly replicated
            drifted=torch.full((4,), float(rank)),          # diverged
        )
        tts.Snapshot.take(snap_dir, {"app": state}, replicated=["app/*"], coordinator=coord)
        dest = tts.StateDict(shared=torch.zeros(16), drifted=torch.zeros(4))
        tts.Snapshot(snap_dir, coordinator=coord).restore({"app": dest})
        assert torch.equal(dest["drifted"], torch.full((4,), float(rank)))
        assert torch.equal(dest["shared"], torch.arange(16, dtype=torch.float32))
        """)
    manifest = tts.Snapshot(str(tmp_path / "snap")).metadata.manifest
    assert "0/app/drifted" in manifest and "1/app/drifted" in manifest
    assert len([k for k in manifest if k.endswith("app/shared")]) == 1


def test_replicated_chunked_array_split_across_ranks(tmp_path):
    """Each rank writes a disjoint, non-empty subset of a replicated
    chunked array's chunks; every chunk lands once, with its crc32 in the
    committed manifest, and both packages read the array back."""
    run_workers(tmp_path, 2, """
        from torchsnapshot_tpu_torch.storage import fs as fs_mod
        real_write = fs_mod.FSStoragePlugin.write

        async def spy(self, wio):
            if "big" in wio.path:
                with open(snap_dir + f"_w{rank}.log", "a") as f:
                    f.write(wio.path + "\\n")
            await real_write(self, wio)

        fs_mod.FSStoragePlugin.write = spy
        with tts.knobs.override_max_chunk_size_bytes(128):
            state = tts.StateDict(big=torch.arange(64, dtype=torch.float64))  # 4 chunks
            tts.Snapshot.take(snap_dir, {"app": state}, replicated=["app/big"], coordinator=coord)
        """)
    logs = []
    for r in range(2):
        with open(str(tmp_path / "snap") + f"_w{r}.log") as f:
            logs.append(sorted(line.strip() for line in f))
    assert logs[0] and logs[1] and not set(logs[0]) & set(logs[1]), logs
    assert len(logs[0]) + len(logs[1]) == 4, logs
    snap = tts.Snapshot(str(tmp_path / "snap"))
    entry = snap.metadata.manifest["0/app/big"]
    assert all(c.crc32 is not None for c in entry.chunks)
    with tts.knobs.override_verify_on_restore(True):
        out = snap.read_object("0/app/big", device="cpu")
    assert torch.equal(out, torch.arange(64, dtype=torch.float64))
    jout = jts.Snapshot(str(tmp_path / "snap")).read_object("1/app/big")
    assert np.array_equal(jout, np.arange(64, dtype=np.float64))


def test_replicated_marker_and_ddp_inference(tmp_path):
    """Over a gloo process group (the default coordinator takes its
    store): a DDP-wrapped module is inferred replicated, except the
    parameters it ignores; a ``Replicated`` optimizer state too."""
    run_workers(tmp_path, 2, """
        from torch.nn.parallel import DistributedDataParallel as DDP
        torch.manual_seed(0)
        inner = torch.nn.Linear(16, 8)
        DDP._set_params_and_buffers_to_ignore_for_model(inner, ["bias"])
        ddp = DDP(inner)
        with torch.no_grad():
            inner.bias.fill_(float(rank))  # ignored by DDP: per rank
        opt = torch.optim.SGD(ddp.parameters(), lr=0.1, momentum=0.9)
        ddp(torch.ones(2, 16)).sum().backward()
        opt.step()
        tts.Snapshot.take(snap_dir, {"model": ddp, "opt": tts.Replicated(opt)})
        import torch.distributed as dist
        dist.destroy_process_group()
        """, kind="gloo")
    manifest = tts.Snapshot(str(tmp_path / "snap")).metadata.manifest
    assert len([k for k in manifest if k.endswith("model/module.weight")]) == 1
    assert "0/model/module.bias" in manifest and "1/model/module.bias" in manifest
    assert not manifest["0/model/module.bias"].replicated
    opt_leaves = [k for k, e in manifest.items() if k.split("/", 1)[1].startswith("opt/state")
                  and getattr(e, "replicated", False)]
    assert opt_leaves, sorted(manifest)


def test_replication_fingerprint_edge_cases_match_jax():
    """The port's fingerprint equals the JAX package's on host arrays and
    objects, catches divergence anywhere in a buffer, ignores memory
    layout and NaN's inequality, keeps big blobs small, and checks a
    CUDA-less bf16 tensor by content."""
    from torchsnapshot_tpu.snapshot import _replication_fingerprint as jfp

    from torchsnapshot_tpu_torch.snapshot import _replication_fingerprint as fp

    rng = np.random.default_rng(0)
    for obj in [float("nan"), 0.25, 3, True, None, "x", b"y" * 5000, "z" * 5000, [0.1], {"lr": 0.1},
                np.arange(12, dtype=np.float32).reshape(3, 4), rng.standard_normal((5, 7)),
                torch.arange(10, dtype=torch.int64), np.float64(2.5)]:
        assert fp(obj) == jfp(obj), obj
    assert fp(float("nan")) == fp(float("nan"))
    assert len(repr(fp(b"x" * (5 << 20)))) < 200
    a = np.zeros(1 << 20, np.float32)
    b = a.copy()
    b[400_000] = 1.0
    assert fp(a) != fp(b)
    c = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    assert fp(c) == fp(np.asfortranarray(c)) == jfp(np.asfortranarray(c))
    t = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
    assert fp(t.t().contiguous().t()) == fp(t) == jfp(t)
    d = torch.ones((8, 8), dtype=torch.bfloat16)
    e = d.clone()
    e[4, 4] = 2
    assert fp(d) != fp(e)
    assert fp(d, mode="shape") == fp(e, mode="shape")
    assert fp([0.1]) != fp([0.2])


def _pair(kind, tmp_path):
    if kind == "local":
        return None
    if kind == "file":
        return [tts.FileCoordinator(str(tmp_path / "kv"), r, 2) for r in range(2)]
    import datetime

    from torch.distributed import TCPStore

    port = _free_port()
    master = TCPStore("127.0.0.1", port, 2, is_master=True, wait_for_workers=False,
                      timeout=datetime.timedelta(seconds=30))
    client = TCPStore("127.0.0.1", port, 2, is_master=False, timeout=datetime.timedelta(seconds=30))
    return [tts.TorchStoreCoordinator(master, 0, 2), tts.TorchStoreCoordinator(client, 1, 2)]


def _on_threads(fns):
    out, errs = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append((i, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(_TIMEOUT_S)
    return out, errs


@pytest.mark.parametrize("kind", ["file", "store"])
def test_coordinator_gathers_barriers_and_aborts(tmp_path, kind):
    """Two ranks on two threads: all_gather_object, broadcast_object,
    kv_exchange and barriers agree; a poisoned scope ends a peer's
    abort-aware wait with a typed error naming the origin."""
    coords = _pair(kind, tmp_path)

    def rank_fn(c):
        def fn():
            g = c.all_gather_object({"rank": c.rank, "v": (1, b"x")})
            b = c.broadcast_object(f"from{c.rank}", src=1)
            e = c.kv_exchange("ex/0", str(c.rank * 10))
            c.barrier()
            return g, b, e
        return fn

    out, errs = _on_threads([rank_fn(c) for c in coords])
    assert not errs, errs
    for g, b, e in out:
        assert g == [{"rank": 0, "v": (1, b"x")}, {"rank": 1, "v": (1, b"x")}]
        assert b == "from1" and e == ["0", "10"]

    def waiter():
        with coords[0].abort_scope("op/1"):
            coords[0].barrier("never", timeout_s=30)

    def poisoner():
        coords[1].poison("op/1", cause="boom", site="test")

    out, errs = _on_threads([waiter, poisoner])
    assert len(errs) == 1 and isinstance(errs[0][1], SnapshotAbortedError)
    assert errs[0][1].info.origin_rank == 1 and "boom" in str(errs[0][1])
    with pytest.raises(TimeoutError):
        coords[0].kv_get("absent", timeout_s=0.05)
    assert coords[0].kv_try_get("absent") is None
    coords[0].kv_set("k", "v")
    assert coords[1].kv_try_get("k") == "v"


def test_default_coordinator_is_local_without_torch_distributed():
    before = tts.obs.counters().get(tts.obs.COORDINATOR_LOCAL, 0)
    c = tts.get_default_coordinator()
    assert isinstance(c, tts.LocalCoordinator) and (c.rank, c.world_size) == (0, 1)
    assert c.all_gather_object(5) == [5] and c.broadcast_object(7) == 7
    assert tts.obs.counters()[tts.obs.COORDINATOR_LOCAL] == before + 1


def test_abort_encoding_matches_jax():
    from torchsnapshot_tpu.resilience import abort as jabort

    from torchsnapshot_tpu_torch.resilience import abort as tabort

    info = tabort.AbortInfo(origin_rank=3, cause="OSError('x')", site="take/rank3")
    raw = tabort.encode_poison(info)
    assert raw == jabort.encode_poison(jabort.AbortInfo(3, "OSError('x')", "take/rank3"))
    assert tabort.decode_poison(raw) == info
    assert tabort.decode_poison("{torn").origin_rank == -1
    assert tabort.poison_key("commit/4") == jabort.poison_key("commit/4")
    err = tabort.SnapshotAbortedError(info, scope="commit/4")
    assert "rank 3" in str(err) and "commit/4" in str(err)


def test_replicated_marker_rejects_rng_and_shares_mappings():
    with pytest.raises(ValueError, match="RNGState"):
        tts.Replicated(tts.RNGState())
    with pytest.raises(TypeError):
        tts.Replicated(5)
    d = {"w": torch.zeros(2)}
    r = tts.Replicated(d)
    r.load_state_dict({"w": torch.ones(2)})
    assert torch.equal(d["w"], torch.ones(2))


def test_world_one_take_with_replicated_marker_matches_jax_manifest(tmp_path):
    """At world 1 a ``Replicated`` stateful writes its leaves under
    ``replicated/`` flags, as the JAX package's marker does."""
    state = {"w": np.arange(6, dtype=np.float32)}
    tts.Snapshot.take(str(tmp_path / "p"), {"app": tts.Replicated(tts.StateDict(
        {k: torch.from_numpy(v.copy()) for k, v in state.items()}))})
    jts.Snapshot.take(str(tmp_path / "j"), {"app": jts.Replicated(jts.StateDict(state))})
    pm = tts.Snapshot(str(tmp_path / "p")).metadata.manifest
    jm = jts.Snapshot(str(tmp_path / "j")).metadata.manifest
    assert sorted(pm) == sorted(jm)
    assert pm["0/app/w"].replicated and jm["0/app/w"].replicated


def test_rank_local_app_state_keys_restore_in_both_packages(tmp_path):
    """Rank 0 holds ``{"a", "extra", "rng"}`` and rank 1 ``{"a"}``: the
    take writes the union of the keys, and the restore loops over the
    union, loading on each rank only the keys it holds (every rank runs
    every barrier, RNG state last by a flag every rank agrees on).  The
    port restores its own snapshot bitwise (and rank 0's RNG stream),
    the JAX package restores it, and the port restores a JAX snapshot
    with the same rank-local keys.  Exact comparisons."""
    run_workers(tmp_path, 2, """
        def app(fill):
            st = {"a": tts.StateDict(w=torch.arange(64, dtype=torch.float32) + rank + fill)}
            if rank == 0:
                st["extra"] = tts.StateDict(x=torch.full((16,), 7.0 + fill))
                st["rng"] = tts.RNGState()
            return st
        torch.manual_seed(123)
        tts.Snapshot.take(snap_dir, app(0), coordinator=coord)
        after = torch.rand(3)
        dest = {k: v for k, v in app(100).items()}
        for k in ("a", "extra"):
            if k in dest:
                next(iter(dest[k].values())).zero_()
        tts.Snapshot(snap_dir, coordinator=coord).restore(dest, device="cpu")
        assert torch.equal(dest["a"]["w"], torch.arange(64, dtype=torch.float32) + rank)
        if rank == 0:
            assert torch.equal(dest["extra"]["x"], torch.full((16,), 7.0))
            assert torch.equal(torch.rand(3), after)
        print("ok")
        """)
    assert sorted(tts.Snapshot(str(tmp_path / "snap")).metadata.manifest) == sorted(
        jts.Snapshot(str(tmp_path / "snap")).metadata.manifest
    )
    run_workers(tmp_path, 2, """
        dest = {"a": StateDict(w=np.zeros(64, np.float32))}
        if rank == 0:
            dest["extra"] = StateDict(x=np.zeros(16, np.float32))
        Snapshot(snap_dir, coordinator=coord).restore(dest)
        assert (dest["a"]["w"] == np.arange(64, dtype=np.float32) + rank).all()
        if rank == 0:
            assert (dest["extra"]["x"] == 7.0).all()
        jax_dir = snap_dir + "_jax"
        st = {"a": StateDict(w=np.arange(32, dtype=np.float64) * (rank + 1))}
        if rank == 0:
            st["extra"] = StateDict(x=np.full(5, 3, np.int64))
        Snapshot.take(jax_dir, st, coordinator=coord)
        """, package="jax", kv="kv2")
    run_workers(tmp_path, 2, """
        dest = {"a": tts.StateDict(w=torch.zeros(32, dtype=torch.float64))}
        if rank == 0:
            dest["extra"] = tts.StateDict(x=torch.zeros(5, dtype=torch.int64))
        tts.Snapshot(snap_dir + "_jax", coordinator=coord).restore(dest, device="cpu")
        assert torch.equal(dest["a"]["w"], torch.arange(32, dtype=torch.float64) * (rank + 1))
        if rank == 0:
            assert torch.equal(dest["extra"]["x"], torch.full((5,), 3, dtype=torch.int64))
        """, kv="kv3")
