"""The port's continuous per-step checkpoint loop (``continuous/loop.py``):
delta replication, marker-last loss bounds, durable promotion with a
pinned HEAD, retention, the preemption drain, heartbeats, the summary,
and the deadlines of every wait.  Each test mirrors one of
``tests/test_continuous.py`` on the port, with torch tensors on the CPU;
the state is mutated in place right after ``step()`` to show the staged
chunks are private.  Every checkpointer is closed, and the SIGTERM hook
is uninstalled after each test."""

import os

import pytest
import torch

import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.continuous.loop as loop_mod
from torchsnapshot_tpu_torch import knobs, obs, recover_state
from torchsnapshot_tpu_torch.continuous import ContinuousStore, summary_block
from torchsnapshot_tpu_torch.resilience import preemption
from torchsnapshot_tpu_torch.storage.memory import reset_namespace
from torchsnapshot_tpu_torch.tier.promoter import drain_promotions, get_promoter

CHUNK = 4096
N = 4096  # float32 elements: 4 chunks a leaf at CHUNK


@pytest.fixture(autouse=True)
def _hooks_and_promoter():
    yield
    preemption.uninstall()
    get_promoter().resume()
    drain_promotions(raise_on_error=False, timeout_s=120)


def _state(seed=0.0):
    return {
        "app": tts.StateDict(
            w=torch.arange(N, dtype=torch.float32) + seed, meta={"lr": 0.1, "name": "run7"}
        )
    }


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


def test_step_and_recover_roundtrip_from_peer(tmp_path):
    cc = _cc(tmp_path)
    state = _state()
    try:
        for s in range(1, 4):
            state["app"]["w"][s] += 1.0
            assert cc.step(state, s)
        cc.drain()
        assert cc.last_step() == 3 and cc.last_peer_step() == 3
    finally:
        cc.close()
    dest = _dest()
    res = _recover(dest, peers=[str(tmp_path / "peer" / "r0")])
    assert res is not None and res["step"] == 3 and res["source"] == "peer"
    assert torch.equal(dest["app"]["w"], state["app"]["w"])
    assert dest["app"]["meta"] == {"lr": 0.1, "name": "run7"}
    assert res["seconds"] < 30


def test_state_mutated_right_after_step_recovers_pre_mutation_values(tmp_path):
    """``step()`` stages private copies: a CPU tensor's host view is its own
    storage, and the training loop writes into it as soon as ``step()``
    returns, while the replication still runs (slowed here)."""
    cc = _cc(tmp_path)
    state = _state()
    base = state["app"]["w"].clone()
    try:
        for s in (1, 2):
            state["app"]["w"].copy_(base)
            state["app"]["w"][s * 1000] += float(s)
            want = state["app"]["w"].clone()
            with knobs.override_failpoints("continuous.replicate=delay30"):
                assert cc.step(state, s)
                state["app"]["w"].add_(1000.0)  # in place, mid-replication
                cc.drain()
            for root in ("local", "peer"):
                dest = _dest()
                res = _recover(dest, peers=[str(tmp_path / root / "r0")])
                assert res["step"] == s and torch.equal(dest["app"]["w"], want), root
    finally:
        cc.close()


def test_delta_replication_moves_only_changed_chunks(tmp_path):
    cc = _cc(tmp_path)
    state = _state()
    try:
        cc.step(state, 1)
        cc.drain()
        rep0 = _counter(obs.CONTINUOUS_BYTES_REPLICATED)
        skip0 = _counter(obs.CONTINUOUS_BYTES_SKIPPED)
        state["app"]["w"][0] += 1.0  # one chunk changes
        cc.step(state, 2)
        cc.drain()
        moved = _counter(obs.CONTINUOUS_BYTES_REPLICATED) - rep0
        skipped = _counter(obs.CONTINUOUS_BYTES_SKIPPED) - skip0
        # 2 targets x the changed 4 KiB chunk: far below 2 whole copies
        assert moved < 2 * state["app"]["w"].numel() * 4
        assert skipped >= 3 * CHUNK  # the three unchanged chunks, and meta
    finally:
        cc.close()


def test_failed_replication_keeps_previous_step_then_heals(tmp_path):
    """Marker-last: a target whose replication fails stays at its previous
    complete step, training goes on, and the next step heals it."""
    cc = _cc(tmp_path)
    state = _state()
    peer_store = str(tmp_path / "peer" / "r0")
    try:
        cc.step(state, 1)
        cc.drain()
        e0 = _counter(obs.CONTINUOUS_REPLICATION_ERRORS)
        with knobs.override_failpoints("continuous.replicate=io"):
            state["app"]["w"][0] += 1.0
            assert cc.step(state, 2)  # step() itself never raises for it
            cc.drain()
        assert _counter(obs.CONTINUOUS_REPLICATION_ERRORS) > e0
        assert _recover(_dest(), peers=[peer_store])["step"] == 1
        state["app"]["w"][1] += 1.0
        cc.step(state, 3)
        cc.drain()
        dest = _dest()
        assert _recover(dest, peers=[peer_store])["step"] == 3
        assert torch.equal(dest["app"]["w"], state["app"]["w"])
    finally:
        cc.close()


def test_promotion_pins_head_and_survives_both_dead(tmp_path):
    """Every-N promotion through the tier promoter commits the HEAD as of
    enqueue time, and a both-dead recovery restores the last promoted
    step."""
    cc = _cc(tmp_path, durable_root=str(tmp_path / "durable"), promote_every_n=2)
    state = _state()
    try:
        for s in range(1, 6):  # promotions at steps 1, 3, 5
            state["app"]["w"][s] += 1.0
            cc.step(state, s)
        cc.drain()
        drain_promotions(timeout_s=120)
        assert cc.last_durable_step() == 5
        summary = cc.summary()
        assert summary["last_durable_step"] == 5 and summary["last_peer_step"] == 5
        assert _counter(obs.CONTINUOUS_PROMOTIONS) >= 3
    finally:
        cc.close()
    durable = str(tmp_path / "durable" / "r0")
    assert ContinuousStore(durable).read_head()["step"] == 5
    dest = _dest()
    res = _recover(dest, durable=durable)
    assert res["step"] == 5 and res["source"] == "durable"
    assert torch.equal(dest["app"]["w"], state["app"]["w"])


def test_kill_switch_knob_disables_step(tmp_path):
    cc = _cc(tmp_path)
    try:
        with knobs.override_continuous(False):
            assert cc.step(_state(), 1) is False
        assert cc.last_step() is None
    finally:
        cc.close()
    assert knobs.continuous_enabled() and knobs.get_continuous_promote_every_n() == 16
    assert knobs.get_continuous_grace_s() == 10.0


def test_retention_prunes_old_steps_but_head_restorable(tmp_path):
    cc = _cc(tmp_path, retain_steps=2)
    state = _state()
    try:
        for s in range(1, 6):
            state["app"]["w"][:] += 1.0  # every chunk changes
            cc.step(state, s)
        cc.drain()
    finally:
        cc.close()
    resident = sorted(os.listdir(tmp_path / "peer" / "r0" / "steps"))
    assert len(resident) <= 2, resident
    assert _recover(_dest(), peers=[str(tmp_path / "peer" / "r0")])["step"] == 5


def test_preemption_drain_finishes_inflight_replication(tmp_path):
    cc = _cc(tmp_path)
    state = _state()
    try:
        d0 = _counter(obs.CONTINUOUS_PREEMPTION_DRAINS)
        with knobs.override_failpoints("continuous.replicate=delay50"):
            cc.step(state, 1)
            assert preemption.notify_preemption(grace_s=30.0) >= 1
        assert preemption.preemption_requested()
        assert _counter(obs.CONTINUOUS_PREEMPTION_DRAINS) > d0
        assert _recover(_dest(), peers=[str(tmp_path / "peer" / "r0")])["step"] == 1
    finally:
        cc.close()


def test_heartbeat_published_and_cleared(tmp_path):
    coord = tts.LocalCoordinator()
    cc = _cc(tmp_path, coordinator=coord)
    try:
        cc.step(_state(), 1)
        cc.drain()
        assert cc.heartbeats() == {0: 1}
    finally:
        cc.close()
    assert not any("/hb/" in k for k in coord._kv)


def test_summary_block_reports_active_loop(tmp_path):
    cc = _cc(tmp_path)
    try:
        cc.step(_state(), 7)
        cc.drain()
        block = summary_block()
        assert block is not None and block["last_step"] == 7 and block["peer_targets"] == 1
    finally:
        cc.close()


def test_asymmetric_target_failure_heals_completely(tmp_path):
    """Only the PEER's replication fails while the local store advances:
    later steps send every chunk the peer lacks (staging skips on the
    intersection of holds, not the union)."""
    peer_ns = f"ttccpeer_{os.getpid()}"
    cc = tts.ContinuousCheckpointer(
        str(tmp_path / "local"), replica_roots=[f"memory://{peer_ns}"],
        chunk_size_bytes=CHUNK, device="cpu",
    )
    state = _state()
    try:
        cc.step(state, 1)
        cc.drain()
        with knobs.override_failpoints("storage.memory.write=io"):
            state["app"]["w"][0] += 1.0
            cc.step(state, 2)
            cc.drain()
        assert cc.summary()["target_heads"][f"memory://{peer_ns}/r0"] == 1
        state["app"]["w"][CHUNK // 4 + 1] += 1.0  # another chunk
        cc.step(state, 3)
        cc.drain()
        dest = _dest()
        res = _recover(dest, peers=[f"memory://{peer_ns}/r0"])
        assert res is not None and res["step"] == 3, res
        assert torch.equal(dest["app"]["w"], state["app"]["w"])
    finally:
        cc.close()
        reset_namespace(peer_ns)


def test_retention_never_prunes_a_lagging_targets_head(tmp_path):
    peer_ns = f"ttcclag_{os.getpid()}"
    cc = tts.ContinuousCheckpointer(
        str(tmp_path / "local"), replica_roots=[f"memory://{peer_ns}"],
        chunk_size_bytes=CHUNK, retain_steps=2, device="cpu",
    )
    state = _state()
    try:
        cc.step(state, 1)
        cc.drain()
        with knobs.override_failpoints("storage.memory.write=io"):
            for s in range(2, 6):  # far past retain_steps
                state["app"]["w"][:] += 1.0
                cc.step(state, s)
            cc.drain()
            res = _recover(_dest(), peers=[f"memory://{peer_ns}/r0"])
            assert res is not None and res["step"] == 1, res
    finally:
        cc.close()
        reset_namespace(peer_ns)


def test_durable_manifest_retention(tmp_path):
    cc = _cc(tmp_path, durable_root=str(tmp_path / "durable"), promote_every_n=1)
    state = _state()
    try:
        for s in range(1, 5):
            state["app"]["w"][:] += 1.0
            cc.step(state, s)
            cc.drain()
            drain_promotions(timeout_s=120)
        cc.step(state, 5)
        cc.drain()
        drain_promotions(timeout_s=120)
        assert cc.last_durable_step() == 5
    finally:
        cc.close()
    assert sorted(os.listdir(tmp_path / "durable" / "r0" / "steps")) == ["0000000005.json"]
    assert _recover(_dest(), durable=str(tmp_path / "durable" / "r0"))["step"] == 5


def test_retention_defers_manifest_gc_for_pending_promotions(tmp_path):
    promoter = get_promoter()
    cc = _cc(tmp_path, durable_root=str(tmp_path / "durable"), promote_every_n=1, retain_steps=2)
    state = _state()
    promoter.pause()
    try:
        for s in range(1, 5):  # every step promotes; the promoter stalled
            state["app"]["w"][:] += 1.0
            cc.step(state, s)
        cc.drain()
        promoter.resume()
        drain_promotions(timeout_s=120)  # raises if a job missed its manifest
        assert cc.last_durable_step() == 4
    finally:
        promoter.resume()
        cc.close()
    dest = _dest()
    assert _recover(dest, durable=str(tmp_path / "durable" / "r0"))["step"] == 4
    assert torch.equal(dest["app"]["w"], state["app"]["w"])


def test_promotion_self_sufficient_after_earlier_group_fails(tmp_path):
    promoter = get_promoter()
    cc = _cc(tmp_path, durable_root=str(tmp_path / "durable"), promote_every_n=1)
    state = _state()
    promoter.pause()
    try:
        cc.step(state, 1)
        cc.drain()
        state["app"]["w"][0] += 1.0
        cc.step(state, 2)
        cc.drain()
        # both promotions queued; the FIRST data job dies
        with knobs.override_failpoints("tier.promote.data=runtime:1:1"):
            promoter.resume()
            with pytest.raises(RuntimeError):
                drain_promotions(timeout_s=120)
        assert cc.last_durable_step() == 2
    finally:
        promoter.resume()
        cc.close()
    dest = _dest()
    res = _recover(dest, durable=str(tmp_path / "durable" / "r0"))
    assert res is not None and res["step"] == 2, res
    assert torch.equal(dest["app"]["w"], state["app"]["w"])


def test_every_wait_has_a_deadline_that_names_the_step(tmp_path, monkeypatch):
    """The joins the reference leaves unbounded (the next step's join of
    the in-flight job, ``drain()`` without a deadline, ``close()``'s
    drain) raise a ``TimeoutError`` naming the step after
    ``DRAIN_DEADLINE_S``; a preemption drain past its deadline returns
    False."""
    monkeypatch.setattr(loop_mod, "DRAIN_DEADLINE_S", 0.2)
    cc = _cc(tmp_path)
    state = _state()
    try:
        with knobs.override_failpoints("continuous.replicate=delay300"):
            cc.step(state, 1)
            with pytest.raises(TimeoutError, match="replication of step 1 still running"):
                cc.step(state, 2)
            with pytest.raises(TimeoutError, match="step 1"):
                cc.drain()
            assert cc.drain(deadline=0.0) is False
            with pytest.raises(TimeoutError, match="step 1"):
                cc.close()
        assert cc.step(state, 3) is False  # closed all the same
    finally:
        cc.close()
    # the worker finished step 1 on its own; the peer holds it
    assert _recover(_dest(), peers=[str(tmp_path / "peer" / "r0")])["step"] == 1


def test_publisher_is_refused_by_name(tmp_path):
    with pytest.raises(NotImplementedError, match="queue A item 5.4"):
        tts.ContinuousCheckpointer(str(tmp_path / "l"), publisher=object(), device="cpu")
