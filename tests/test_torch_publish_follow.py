"""The port's subscribers in motion: swaps under concurrent readers,
failures, resharding, retention, the announce channel, the follow thread,
the chunk fan-in, processes, the snapshot/manager/continuous hooks, the
CLI and the two publication chaos cases.

Port counterparts of ``tests/test_publish.py:238-570`` and
``tests/test_chaos.py:1507``, ``:1595``, on torch tensors on the CPU
(``device="cpu"``).  Every value check is bitwise.  Processes share a
``FileCoordinator`` directory and exit within their own wall-clock bound.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu.publish as jpub
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import knobs, obs
from torchsnapshot_tpu_torch.coordination import FileCoordinator
from torchsnapshot_tpu_torch.publish import (
    Publisher,
    Subscriber,
    TemplateMismatchError,
    root_rollup,
)
from torchsnapshot_tpu_torch.publish import announce as announce_mod
from torchsnapshot_tpu_torch.resilience import preemption
from torchsnapshot_tpu_torch.tier.promoter import drain_promotions, get_promoter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 1024
N = 4096  # float32: 16 chunks a leaf at CHUNK


@pytest.fixture(autouse=True)
def _hooks_and_promoter():
    yield
    preemption.uninstall()
    get_promoter().resume()
    drain_promotions(raise_on_error=False, timeout_s=120)


def _app(**leaves):
    return {"app": tts.StateDict(**leaves)}


def _sub(root, state, **kw):
    return Subscriber(root, state, device="cpu", **kw)


def _count(name):
    return obs.counter(name).value


def test_atomic_swap_no_torn_reads(tmp_path):
    """Readers under ``pinned()`` see every leaf from one generation while
    the subscriber flips between all-zeros and all-ones states."""
    root = str(tmp_path / "pub")
    state = _app(a=torch.zeros(N), b=torch.zeros(N))
    pub = Publisher(root, chunk_size_bytes=CHUNK)
    sub = _sub(root, state)
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            with sub.live.pinned():
                a0, b_last = float(state["app"]["a"][0]), float(state["app"]["b"][-1])
                if a0 != b_last:
                    torn.append((a0, b_last))
            time.sleep(0.0002)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for step, fill in ((1, 1.0), (2, 0.0), (3, 1.0), (4, 0.0)):
            pub.publish_state(_app(a=torch.full((N,), fill), b=torch.full((N,), fill)), step)
            assert sub.poll_once() == step
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sub.close()
        pub.close()
    assert torn == [], f"torn swap observed: {torn[:5]}"
    assert sub.generation == 4 and sub.step == 4


def test_apply_failure_preserves_generation(tmp_path):
    """A failure between staging and the swap leaves the live state
    bitwise at the last complete generation; the next poll applies."""
    root = str(tmp_path / "pub")
    w = torch.arange(N, dtype=torch.float32)
    pub = Publisher(root, chunk_size_bytes=CHUNK)
    state = _app(w=torch.zeros(N))
    sub = _sub(root, state)
    try:
        pub.publish_state(_app(w=w.clone()), 1)
        assert sub.poll_once() == 1
        held = state["app"]["w"].clone()
        pub.publish_state(_app(w=w + 7.0), 2)
        with knobs.override_failpoints("publish.subscriber.apply=runtime:1:1"):
            with pytest.raises(RuntimeError, match="injected"):
                sub.poll_once()
        assert sub.generation == 1 and sub.step == 1
        assert torch.equal(state["app"]["w"], held)
        assert sub.poll_once() == 2
        assert torch.equal(state["app"]["w"], w + 7.0)
    finally:
        sub.close()
        pub.close()


def test_strict_template_mismatch_raises_and_non_strict_skips(tmp_path):
    root = str(tmp_path / "pub")
    pub = Publisher(root, chunk_size_bytes=CHUNK)
    strict = _sub(root, _app(other=torch.zeros(8)))
    state = _app(w=torch.zeros(N))
    loose = _sub(root, state, strict=False)
    try:
        pub.publish_state(_app(w=torch.ones(N), extra=torch.ones(8)), 1)
        with pytest.raises(TemplateMismatchError):
            strict.poll_once()
        skipped = _count(obs.PUBLISH_LEAVES_SKIPPED)
        assert loose.poll_once() == 1
        assert _count(obs.PUBLISH_LEAVES_SKIPPED) == skipped + 1
        assert torch.equal(state["app"]["w"], torch.ones(N)) and "extra" not in state["app"]
    finally:
        strict.close()
        loose.close()
        pub.close()


def test_resharded_subscriber_holds_dim0_slab(tmp_path):
    """A subscriber holding rows 4..12 of the published [16, 256] array
    fetches only its window and applies into its smaller leaf."""
    root = str(tmp_path / "pub")
    full = torch.arange(N, dtype=torch.float32).reshape(16, 256)
    pub = Publisher(root, chunk_size_bytes=CHUNK)
    state = _app(w=torch.zeros(8, 256))
    sub = _sub(root, state, shard_spec={"app/w": ((4, 0), (8, 256))})
    try:
        pub.publish_state(_app(w=full.clone()), 1)
        assert sub.poll_once() == 1
        assert torch.equal(state["app"]["w"], full[4:12])
        full2 = full.clone()
        full2[5] += 100.0  # inside the window
        full2[0] -= 100.0  # outside: never fetched
        pub.publish_state(_app(w=full2), 2)
        b0 = sub._bytes_fetched_total
        assert sub.poll_once() == 2
        assert torch.equal(state["app"]["w"], full2[4:12])
        assert sub._bytes_fetched_total - b0 == CHUNK
    finally:
        sub.close()
        pub.close()


def test_publish_state_writes_only_new_chunks(tmp_path):
    root = str(tmp_path / "pub")
    w = torch.arange(N, dtype=torch.float32)
    pub = Publisher(root, chunk_size_bytes=CHUNK)
    try:
        assert pub.publish_state(_app(w=w.clone()), 1).endswith(".json")
        pool = os.path.join(root, "objects")
        count1 = sum(len(fs) for _, _, fs in os.walk(pool))
        assert count1 == N * 4 // CHUNK
        w[0] = -1.0
        written = _count(obs.BYTES_WRITTEN)
        pub.publish_state(_app(w=w.clone()), 2)
        assert _count(obs.BYTES_WRITTEN) - written == CHUNK
        # one chunk written, the superseded one pruned
        assert sum(len(fs) for _, _, fs in os.walk(pool)) == count1
        assert set(pub.last_state_s) == {"encode", "digest", "write"}
    finally:
        pub.close()


def test_publish_retention_prunes_records(tmp_path):
    root = str(tmp_path / "pub")
    w = torch.zeros(N)
    pub = Publisher(root, retain=2, chunk_size_bytes=CHUNK)
    try:
        for step in range(1, 6):
            w[0] = step
            pub.publish_state(_app(w=w.clone()), step)
        assert len(os.listdir(os.path.join(root, "records"))) == 2
        assert root_rollup(root)["step"] == 5
    finally:
        pub.close()
    with knobs.override_publish_retain(1):
        pub = Publisher(root, chunk_size_bytes=CHUNK)
        pub.publish_state(_app(w=w + 1), 6)
        pub.publish_state(_app(w=w + 2), 7)
        pub.close()
    assert "0000000006.json" not in os.listdir(os.path.join(root, "records"))


def test_publish_announce_disabled_still_converges(tmp_path):
    root = str(tmp_path / "pub")
    coord = FileCoordinator(str(tmp_path / "kv"), 0, 1)
    with knobs.override_publish_announce(False):
        pub = Publisher(root, coordinator=coord, chunk_size_bytes=CHUNK)
        state = _app(w=torch.zeros(64))
        sub = _sub(root, state, coordinator=coord, poll_s=0.05)
        try:
            pub.publish_state(_app(w=torch.ones(64)), 1)
            fallbacks = _count(obs.PUBLISH_FALLBACK_POLLS)
            assert sub.poll_once(wait_s=0.05) == 1
            assert float(state["app"]["w"][0]) == 1.0
            assert _count(obs.PUBLISH_FALLBACK_POLLS) == fallbacks + 1
            assert coord.kv_try_get(announce_mod.announce_key(announce_mod.ns_for_root(root))) is None
        finally:
            sub.close()
            pub.close()


def test_announce_the_precheck_finds_is_delivered_not_a_fallback(tmp_path):
    """An announce already pending when the poll starts counts as
    delivered in the port; the reference counts its swap in
    ``publish.fallback_polls`` (a deliberate difference)."""
    root = str(tmp_path / "pub")
    coord = FileCoordinator(str(tmp_path / "kv"), 0, 1)
    pub = Publisher(root, coordinator=coord, chunk_size_bytes=CHUNK)
    sub = _sub(root, _app(w=torch.zeros(N)), coordinator=coord, poll_s=5.0)
    jsub = jpub.Subscriber(root, {"app": {"w": np.zeros(N, np.float32)}}, coordinator=coord)
    try:
        for step in (1, 2):
            pub.publish_state(_app(w=torch.full((N,), float(step))), step)
            port_fb, jax_fb = _count(obs.PUBLISH_FALLBACK_POLLS), _jax_count("publish.fallback_polls")
            t0 = time.monotonic()
            assert sub.poll_once(wait_s=5.0) == step and jsub.poll_once(wait_s=5.0) == step
            assert time.monotonic() - t0 < 4.0  # neither waited out the watch
            assert _count(obs.PUBLISH_FALLBACK_POLLS) == port_fb
            assert _jax_count("publish.fallback_polls") == jax_fb + 1
    finally:
        sub.close()
        jsub.close()
        pub.close()


def _jax_count(name):
    from torchsnapshot_tpu import obs as jobs

    return jobs.counter(name).value


def test_follow_thread_survives_and_swaps(tmp_path):
    """The watcher survives a failing poll (counted in
    ``publish.watch_errors``) and goes on swapping; ``stop`` joins it."""
    root = str(tmp_path / "pub")
    pub = Publisher(root, chunk_size_bytes=CHUNK)
    state = _app(w=torch.zeros(N))
    sub = _sub(root, state, poll_s=0.02)
    swaps = []
    errors = _count(obs.PUBLISH_WATCH_ERRORS)
    with knobs.override_failpoints("publish.subscriber.apply=runtime:1:1"):
        handle = sub.follow(on_swap=lambda step, gen: swaps.append((step, gen)))
        try:
            pub.publish_state(_app(w=torch.ones(N)), 1)
            deadline = time.monotonic() + 20
            while not swaps and time.monotonic() < deadline:
                time.sleep(0.01)
            assert swaps == [(1, 1)] and handle.alive
            assert _count(obs.PUBLISH_WATCH_ERRORS) == errors + 1
            assert torch.equal(state["app"]["w"], torch.ones(N))
        finally:
            handle.stop(timeout_s=30)
            sub.close()
            pub.close()
    assert not handle.alive


def test_chunk_fanin_over_the_collective_engine_local_mode(tmp_path, monkeypatch):
    """Two subscribers of one process on the collective engine's local
    mode: the second takes every keyed chunk from the device registry
    (``try_fetch``'s bytearray), reads nothing from storage, and both
    hold the published bytes."""
    root = str(tmp_path / "pub")
    coord = FileCoordinator(str(tmp_path / "kv"), 0, 1)
    pub = Publisher(root, chunk_size_bytes=CHUNK)
    w = torch.randn(N, generator=torch.Generator().manual_seed(3))
    states = [_app(w=torch.zeros(N)), _app(w=torch.zeros(N))]
    with knobs.override_transport("collective"):
        subs = [_sub(root, s, coordinator=coord) for s in states]
        try:
            pub.publish_state(_app(w=w.clone()), 1)
            assert subs[0].poll_once() == 1
            assert subs[0]._transport is not None and len(subs[0]._transport_pub) == N * 4 // CHUNK
            from torchsnapshot_tpu_torch import scheduler

            reads = []
            orig = scheduler.sync_execute_chunk_reads
            monkeypatch.setattr(
                scheduler, "sync_execute_chunk_reads",
                lambda items, *a, **k: reads.append(items) or orig(items, *a, **k),
            )
            assert subs[1].poll_once() == 1
            assert reads == [] and subs[1]._fetch_storage == {}
        finally:
            for sub in subs:
                sub.close()
            pub.close()
    for s in states:
        assert torch.equal(s["app"]["w"], w)
    assert subs[0]._transport is None  # swept and closed


def _launch(tmp_path, body, env_per_rank=({}, {}), timeout_s=120):
    script = os.path.join(str(tmp_path), "publish_worker.py")
    with open(script, "w") as f:
        f.write(
            textwrap.dedent(
                f"""
                import os, sys, time, zlib
                sys.path.insert(0, {REPO!r})
                import numpy as np
                import torch
                from torchsnapshot_tpu_torch import StateDict, knobs, obs
                from torchsnapshot_tpu_torch.coordination import FileCoordinator
                from torchsnapshot_tpu_torch.publish import Publisher, Subscriber
                from torchsnapshot_tpu_torch.publish import announce as announce_mod

                rank = int(sys.argv[1])
                world = int(sys.argv[2])
                coord = FileCoordinator({os.path.join(str(tmp_path), "kv")!r}, rank, world)
                pub_root = {os.path.join(str(tmp_path), "pub")!r}
                """
            )
            + textwrap.dedent(body)
        )
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(r), "2"],
            env={**os.environ, **env},
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for r, env in enumerate(env_per_rank)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError("publish worker ran past its wall-clock bound")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return outs


def test_publish_two_process_acceptance(tmp_path):
    """Rank 0 publishes 5 steps (seeded ~2% sparse changes); rank 1
    follows and holds bitwise the published weights after every swap
    (digests over the KV), fetching well under 5 full restores."""
    body = r"""
    CHUNK, STEPS = 1024, 5

    def digest(t):
        return str(zlib.crc32(t.contiguous().view(torch.uint8).numpy().tobytes()))

    if rank == 0:
        w = torch.arange(16384, dtype=torch.float32).reshape(64, 256)
        pub = Publisher(pub_root, coordinator=coord, chunk_size_bytes=CHUNK)
        for step in range(1, STEPS + 1):
            if step > 1:
                rng = np.random.default_rng(step)
                rows = rng.choice(64, 1, replace=False)
                w[torch.from_numpy(rows)] += torch.from_numpy(rng.standard_normal((1, 256)).astype(np.float32))
            pub.publish_state({"app": StateDict(w=w.clone())}, step)
            coord.kv_set(f"acc/pub/{step}/digest", digest(w))
            assert coord.kv_get(f"acc/sub/{step}/digest", timeout_s=60) == digest(w), step
        fetched = int(coord.kv_get("acc/sub/bytes", timeout_s=60))
        assert fetched < 0.5 * STEPS * w.nbytes, fetched
        print(f"PUBLISHER-OK fetched={fetched}")
        pub.close()
    else:
        state = {"app": StateDict(w=torch.zeros(64, 256))}
        sub = Subscriber(pub_root, state, coordinator=coord, poll_s=0.1, device="cpu")
        for step in range(1, STEPS + 1):
            expect = coord.kv_get(f"acc/pub/{step}/digest", timeout_s=60)
            deadline = time.monotonic() + 60
            while sub.step != step and time.monotonic() < deadline:
                sub.poll_once(wait_s=0.05)
            assert sub.step == step, step
            assert digest(state["app"]["w"]) == expect, step
            coord.kv_set(f"acc/sub/{step}/digest", expect)
        coord.kv_set("acc/sub/bytes", str(sub._bytes_fetched_total))
        print("SUBSCRIBER-OK")
        sub.close()
    """
    outs = _launch(tmp_path, body)
    assert "PUBLISHER-OK" in outs[0] and "SUBSCRIBER-OK" in outs[1]


def test_chaos_publisher_dies_before_announce_subscribers_converge(tmp_path):
    """Rank 0 dies between the durable commit of step 2 and its announce;
    rank 1 converges to step 2 through the durable poll (bitwise, the
    fallback counter advanced), and a restarted publisher's ``close``
    leaves no announce key."""
    body = r"""
    N = 4096
    if rank == 0:
        w = torch.arange(N, dtype=torch.float32)
        pub = Publisher(pub_root, coordinator=coord, chunk_size_bytes=1024)
        pub.publish_state({"app": StateDict(w=w.clone())}, 1)
        coord.kv_set("chaos/pub/step1", "ok")
        assert coord.kv_get("chaos/sub/step1", timeout_s=60) == "ok"
        w[0] = -1.0
        try:
            with knobs.override_failpoints("publish.announce=runtime:1:1"):
                pub.publish_state({"app": StateDict(w=w.clone())}, 2)
            raise SystemExit("failpoint publish.announce never fired")
        except RuntimeError:
            pass
        coord.kv_set("chaos/pub/died", "1")
        assert coord.kv_get("chaos/sub/step2", timeout_s=60) == "ok"
        pub2 = Publisher(pub_root, coordinator=coord, chunk_size_bytes=1024)
        w[1] = -2.0
        pub2.publish_state({"app": StateDict(w=w.clone())}, 3)
        pub2.close()
        ns = announce_mod.ns_for_root(pub_root)
        assert coord.kv_try_get(announce_mod.announce_key(ns)) is None
        coord.kv_set("chaos/pub/done", "1")
        print("PUB-OK")
    else:
        state = {"app": StateDict(w=torch.zeros(N))}
        sub = Subscriber(pub_root, state, coordinator=coord, poll_s=0.1, device="cpu")
        coord.kv_get("chaos/pub/step1", timeout_s=60)
        deadline = time.monotonic() + 60
        while sub.step != 1 and time.monotonic() < deadline:
            sub.poll_once(wait_s=0.05)
        assert sub.step == 1
        coord.kv_set("chaos/sub/step1", "ok")
        coord.kv_get("chaos/pub/died", timeout_s=60)
        fb0 = obs.counter(obs.PUBLISH_FALLBACK_POLLS).value
        deadline = time.monotonic() + 60
        while sub.step != 2 and time.monotonic() < deadline:
            sub.poll_once(wait_s=0.1)
        assert sub.step == 2, "durable-poll fallback never converged"
        assert obs.counter(obs.PUBLISH_FALLBACK_POLLS).value > fb0
        w = torch.arange(N, dtype=torch.float32)
        w[0] = -1.0
        assert torch.equal(state["app"]["w"], w)
        coord.kv_set("chaos/sub/step2", "ok")
        coord.kv_get("chaos/pub/done", timeout_s=60)
        deadline = time.monotonic() + 60
        while sub.step != 3 and time.monotonic() < deadline:
            sub.poll_once(wait_s=0.1)
        assert sub.step == 3
        sub.close()
        print("SUB-OK")
    """
    outs = _launch(tmp_path, body)
    assert "PUB-OK" in outs[0] and "SUB-OK" in outs[1]


def test_chaos_subscriber_dies_mid_apply_next_poll_reapplies(tmp_path):
    """A subscriber killed between staging and the swap keeps its last
    complete generation; a fresh subscriber over the same root applies
    from the durable record."""
    body = r"""
    N = 4096
    if rank == 0:
        pub = Publisher(pub_root, coordinator=coord, chunk_size_bytes=1024)
        pub.publish_state({"app": StateDict(w=torch.arange(N, dtype=torch.float32))}, 1)
        coord.kv_set("chaos/pub/step1", "ok")
        assert coord.kv_get("chaos/sub/crashed", timeout_s=60) == "1"
        pub.close()
        print("PUB-OK")
    else:
        state = {"app": StateDict(w=torch.zeros(N))}
        sub = Subscriber(pub_root, state, coordinator=coord, poll_s=0.1, device="cpu")
        coord.kv_get("chaos/pub/step1", timeout_s=60)
        deadline = time.monotonic() + 60
        try:
            while sub.step != 1 and time.monotonic() < deadline:
                sub.poll_once(wait_s=0.05)
            raise SystemExit("failpoint publish.subscriber.apply never fired")
        except RuntimeError:
            pass
        assert sub.generation == 0 and sub.step is None
        assert torch.equal(state["app"]["w"], torch.zeros(N))
        sub2 = Subscriber(pub_root, state, coordinator=coord, poll_s=0.1, device="cpu")
        deadline = time.monotonic() + 60
        while sub2.step != 1 and time.monotonic() < deadline:
            sub2.poll_once(wait_s=0.05)
        assert sub2.step == 1 and sub2.generation == 1
        assert torch.equal(state["app"]["w"], torch.arange(N, dtype=torch.float32))
        sub.close()
        sub2.close()
        coord.kv_set("chaos/sub/crashed", "1")
        print("SUB-OK")
    """
    outs = _launch(
        tmp_path, body,
        env_per_rank=({}, {"TORCHSNAPSHOT_TPU_TORCH_FAILPOINTS": "publish.subscriber.apply=runtime:1:1"}),
    )
    assert "PUB-OK" in outs[0] and "SUB-OK" in outs[1]


class _FailingPublisher:
    def __init__(self):
        self.calls = []

    def publish_snapshot(self, path, step, metadata=None):
        self.calls.append(("snapshot", step))
        raise OSError("publication root unreachable")

    def publish_continuous(self, root, step):
        self.calls.append(("continuous", step))
        raise OSError("publication root unreachable")


def test_continuous_publisher_failure_is_swallowed_and_retried(tmp_path):
    """A failing publisher never fails the loop: each confirmed durable
    promotion tries once (counted in ``exceptions.swallowed``) and the
    durable mirror stands."""
    failing = _FailingPublisher()
    cc = tts.ContinuousCheckpointer(
        str(tmp_path / "local"), durable_root=str(tmp_path / "durable"), promote_every_n=1,
        chunk_size_bytes=4096, replica_roots=[str(tmp_path / "peer")], publisher=failing,
        device="cpu",
    )
    state = _app(w=torch.arange(N, dtype=torch.float32))
    swallowed = _count(obs.EXCEPTIONS_SWALLOWED)
    try:
        for s in (1, 2):
            state["app"]["w"][s] += 1.0
            cc.step(state, s)
            cc.drain()
            drain_promotions(timeout_s=120)
            assert cc.last_durable_step() == s
        assert cc.last_durable_step() == 2
    finally:
        cc.close()
    assert failing.calls == [("continuous", 1), ("continuous", 2)]
    assert _count(obs.EXCEPTIONS_SWALLOWED) >= swallowed + 2


class _Rank1:
    rank, world_size = 1, 2


def test_manager_publishes_from_rank_0_only_and_swallows_failures(tmp_path):
    """Rank 0's sync and async saves are published (the subscriber swaps
    to each); another rank never publishes; a failing publisher leaves the
    save committed."""
    root = str(tmp_path / "pub")
    pub = Publisher(root)
    mgr = tts.SnapshotManager(str(tmp_path / "ckpt"), publisher=pub)
    state = _app(w=torch.arange(N, dtype=torch.float32), step=0)
    live = _app(w=torch.zeros(N), step=-1)
    sub = _sub(root, live)
    try:
        mgr.save(state, step=1)
        assert sub.poll_once() == 1 and live["app"]["step"] == 0
        state["app"]["w"][3] = -1.0
        state["app"]["step"] = 2
        mgr.save(state, step=2, async_=True).wait()
        assert sub.poll_once() == 2 and sub.step == 2
        assert torch.equal(live["app"]["w"], state["app"]["w"]) and live["app"]["step"] == 2
        other = tts.SnapshotManager(str(tmp_path / "ckpt"), publisher=pub, coordinator=_Rank1())
        other._publish(2, None)
        assert root_rollup(root)["step"] == 2
    finally:
        sub.close()
        pub.close()
    failing = _FailingPublisher()
    swallowed = _count(obs.EXCEPTIONS_SWALLOWED)
    mgr = tts.SnapshotManager(str(tmp_path / "ckpt2"), publisher=failing)
    snap = mgr.save(state, step=1)
    assert failing.calls == [("snapshot", 1)] and mgr.steps() == [1]
    assert snap.verify().ok and _count(obs.EXCEPTIONS_SWALLOWED) == swallowed + 1


def test_snapshot_publish_to_raises_on_failure(tmp_path):
    snap = tts.Snapshot.take(str(tmp_path / "s"), _app(w=torch.ones(8)))
    with pytest.raises(OSError, match="unreachable"):
        snap.publish_to(_FailingPublisher(), 1)
    pub = Publisher(str(tmp_path / "pub"))
    pub.close()
    with pytest.raises(RuntimeError, match="closed"):
        snap.publish_to(pub, 1)


def test_cli_stats_names_the_subscribers_step(tmp_path):
    """``python -m torchsnapshot_tpu_torch stats`` of a publication root,
    in a process, names the subscriber and its step and lag."""
    root = str(tmp_path / "pub")
    pub = Publisher(root, chunk_size_bytes=CHUNK)
    sub = _sub(root, _app(w=torch.zeros(N)), sub_id="sub-serving")
    try:
        pub.publish_state(_app(w=torch.ones(N)), 1)
        sub.poll_once()
        pub.publish_state(_app(w=torch.full((N,), 2.0)), 2)
    finally:
        sub.close()
        pub.close()
    out = subprocess.run(
        [sys.executable, "-m", "torchsnapshot_tpu_torch", "stats", root],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "[publication root]" in out.stdout and "published step 2" in out.stdout
    assert "sub-serving: step 1 (lag 1 steps" in out.stdout
