"""The port's resilience layer (``resilience/{retry,breaker,failpoints}``)
held against the JAX package's on the same inputs: failpoint schedules,
the classifiers' verdicts over an errno table, the breaker's state
machine, the retry engine, the knobs' defaults and clamps; then faults
injected into the port's fs path (a transient commits after one retry,
a permanent failure leaves no ``.snapshot_metadata`` and no temp file,
the breaker fails fast).  Comparisons are exact; every armed failpoint
is disarmed, every ``hang`` released and every breaker reset in a
``finally``.
"""

import asyncio
import contextlib
import errno
import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import knobs as jknobs
from torchsnapshot_tpu import resilience as jres
from torchsnapshot_tpu.resilience import failpoints as jfp
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import obs as tobs
from torchsnapshot_tpu_torch import resilience as tres
from torchsnapshot_tpu_torch.resilience import failpoints as tfp


@pytest.fixture(autouse=True)
def _clean():
    try:
        yield
    finally:
        tfp.release_hangs()
        tres.reset_breakers()
        jres.reset_breakers()


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _schedule(fp_mod, knobs, spec, seed, sites):
    """Which of the evaluations at ``sites`` fired, and what they raised."""
    out = []
    with knobs.override_failpoint_seed(seed), knobs.override_failpoints(spec):
        for site in sites:
            try:
                fp_mod.failpoint(site)
                out.append(None)
            except Exception as e:  # noqa: BLE001 — the schedule records it
                out.append((type(e).__name__, getattr(e, "errno", None)))
    return out


def test_failpoint_schedules_fire_at_the_same_calls_as_jax():
    sites = ["storage.fs.write", "storage.fs.read", "storage.fs.part.write", "scheduler.stage"] * 24
    for spec in (
        "storage.fs.*=eintr:0.5",
        "storage.fs.write=io:0.3:4,storage.fs.read=conn",
        "storage.*=enospc:0.25:*,scheduler.stage=timeout:1:2",
        "storage.fs.part.write=slowdown:0.7:5",
    ):
        for seed in (0, 1, 1234):
            got = _schedule(tfp, tknobs, spec, seed, sites)
            assert got == _schedule(jfp, jknobs, spec, seed, sites), (spec, seed)
            assert any(got) or "0.25" in spec
    assert not tfp.active() and not tres.failpoints.active()


def test_failpoint_spec_grammar_and_counts_match_jax():
    for spec in ("a.b=io:0.5:3, c.*=conn", "x=delay5", "y=hang::1", "z=http500:1:*"):
        got = [(a.pattern, a.kind, a.probability, a.remaining) for a in tfp.parse_failpoints(spec)]
        want = [(a.pattern, a.kind, a.probability, a.remaining) for a in jfp.parse_failpoints(spec)]
        assert got == want
    for bad in ("x", "a=nope", "a=io:2.0", "a=io:0.5:-1", "a=io:1:1:1", "a=io:0"):
        with pytest.raises(ValueError):
            tfp.parse_failpoints(bad)
        with pytest.raises(ValueError):
            jfp.parse_failpoints(bad)
    with pytest.raises(ValueError):
        with tknobs.override_failpoints("malformed-spec"):
            pass
    assert not tfp.active()
    fired = tfp.fired_count()
    with tknobs.override_failpoints("storage.fs.*=eagain::2"):
        for site in ("storage.fs.write", "storage.fs.read"):
            with pytest.raises(BlockingIOError):
                tfp.failpoint(site)
        tfp.failpoint("storage.fs.write")  # its count is spent
        tfp.failpoint("storage.memory.write")  # no match
    assert tfp.fired_count() - fired == 2
    # delay<ms> sleeps and the site goes on
    with tknobs.override_failpoints("d=delay30"):
        t0 = time.perf_counter()
        tfp.failpoint("d")
        assert time.perf_counter() - t0 >= 0.025


def test_hang_failpoint_is_released_and_has_a_deadline(monkeypatch):
    done = threading.Event()
    with tknobs.override_failpoints("h=hang"):
        t = threading.Thread(target=lambda: (tfp.failpoint("h"), done.set()), daemon=True)
        t.start()
        try:
            assert not done.wait(0.2)  # parked
        finally:
            tfp.release_hangs()
        t.join(5)
        assert done.is_set()
        monkeypatch.setattr(tfp, "HANG_DEADLINE_S", 0.1)
        with pytest.raises(TimeoutError, match="not released"):
            tfp.failpoint("h")


_ERRNOS = [
    errno.EINTR, errno.EAGAIN, errno.EIO, errno.ENOSPC, errno.ENOENT, errno.EACCES,
    errno.EBADF, errno.EROFS, errno.EDQUOT, errno.ETIMEDOUT, errno.ECONNRESET,
]


class SlowDown(Exception):
    pass


class EndpointConnectionError(Exception):
    pass


class ReadTimeoutError(Exception):
    pass


def _errors():
    errs = [OSError(e, os.strerror(e)) for e in _ERRNOS]
    errs += [ConnectionError("c"), ConnectionResetError("r"), TimeoutError("t"), RuntimeError("x"),
             ValueError("v"), FileNotFoundError("f"), SlowDown(), EndpointConnectionError(),
             ReadTimeoutError()]
    for code, status in (("SlowDown", 503), ("InternalError", 500), ("NoSuchKey", 404),
                         ("NoSuchUpload", 404), ("AccessDenied", 403), ("Throttling", 400),
                         ("Weird", 502), ("Weird", 409)):
        errs.append(jfp.InjectedClientError(code, status, "site"))
        errs.append(tfp.InjectedClientError(code, status, "site"))
    return errs


def test_classifiers_give_the_jax_verdicts_over_an_errno_table():
    seen = set()
    for e in _errors():
        for name in ("classify_fs", "classify_generic", "classify_s3"):
            got = getattr(tres, name)(e)
            assert got == getattr(jres, name)(e), (name, e)
            seen.add(got)
    assert seen == {tres.TRANSIENT, tres.FATAL, tres.MISSING}


def test_breaker_state_machine_matches_jax():
    """The same events drive both breakers through closed, open,
    half-open (one probe), open again and closed."""
    def drive(mod, name):
        b = mod.CircuitBreaker(name, threshold=3, cooldown_s=0.15)
        states = []
        for ev in ("f", "f", "s", "f", "f", "f", "check", "sleep", "allow", "allow", "f",
                   "check", "sleep", "allow", "release", "allow", "s", "allow", "f"):
            if ev == "f":
                b.record_failure()
            elif ev == "s":
                b.record_success()
            elif ev == "sleep":
                time.sleep(0.2)
            elif ev == "release":
                b.release_probe()
            elif ev == "allow":
                states.append(b.allow())
            else:
                try:
                    b.check("op")
                    states.append("passed")
                except OSError as e:
                    states.append(type(e).__name__)
            states.append(b.state)
        return states

    got = drive(tres, "port_test")
    assert got == drive(jres, "jax_test")
    assert "open" in got and "half_open" in got and got[-1] == "closed"
    assert tobs.gauge("resilience.breaker_state.port_test").value == 0


def test_retry_engine_matches_jax():
    """A transient twice then success; a fatal at once; transients past
    the attempt cap; a missing verdict as FileNotFoundError; the same
    jitter from the same label."""
    def outcomes(mod, obs_mod):
        res = []
        for fail_kind, n_fail, attempts in (("t", 2, 6), ("fatal", 1, 6), ("t", 9, 3), ("m", 1, 6)):
            progress = mod.SharedProgress(window_s=60.0, max_attempts=attempts, label="same")
            delays = [progress.backoff_delay(a) for a in range(1, 5)]

            async def no_sleep(attempt):
                return None

            progress.backoff = no_sleep
            calls = {"n": 0}

            def fn():
                calls["n"] += 1
                if calls["n"] <= n_fail:
                    raise {"t": ConnectionError, "fatal": ValueError, "m": KeyError}[fail_kind]("x")
                return "ok"

            def classify(e):
                return {ConnectionError: mod.TRANSIENT, ValueError: mod.FATAL, KeyError: mod.MISSING}[type(e)]

            r0 = obs_mod.counter(obs_mod.RESILIENCE_RETRIES).value
            try:
                out = _run(mod.retry_call(fn, op_name="op", backend="b", classify=classify,
                                          progress=progress))
            except Exception as e:  # noqa: BLE001
                out = type(e).__name__
            res.append((out, calls["n"], obs_mod.counter(obs_mod.RESILIENCE_RETRIES).value - r0,
                        [round(d, 12) for d in delays]))
        return res

    from torchsnapshot_tpu import obs as jobs

    got = outcomes(tres, tobs)
    assert got == outcomes(jres, jobs)
    assert [g[0] for g in got] == ["ok", "ValueError", "ConnectionError", "FileNotFoundError"]


def test_knob_defaults_and_clamps_match_jax():
    names = ("get_failpoints", "get_failpoint_seed", "get_retry_max_attempts",
             "get_retry_progress_window_s", "get_retry_backoff_cap_s", "get_breaker_threshold",
             "get_breaker_cooldown_s", "get_stripe_part_size_bytes",
             "get_stripe_min_object_size_bytes", "get_codec", "get_codec_level",
             "get_codec_min_ratio")
    assert {n: getattr(tknobs, n)() for n in names} == {n: getattr(jknobs, n)() for n in names}
    assert tknobs.get_stripe_min_object_size_bytes() == 128 << 20
    assert tknobs.get_stripe_part_size_bytes() == 64 << 20
    cases = [
        ("override_stripe_min_object_size_bytes", 0, "get_stripe_min_object_size_bytes"),
        ("override_stripe_min_object_size_bytes", 10, "get_stripe_min_object_size_bytes"),
        ("override_stripe_part_size_bytes", 0, "get_stripe_part_size_bytes"),
        ("override_codec_min_ratio", 0.5, "get_codec_min_ratio"),
        ("override_retry_max_attempts", 0, "get_retry_max_attempts"),
        ("override_breaker_threshold", -3, "get_breaker_threshold"),
        ("override_codec", "ZLIB", "get_codec"),
    ]
    for setter, value, getter in cases:
        with getattr(tknobs, setter)(value), getattr(jknobs, setter)(value):
            assert getattr(tknobs, getter)() == getattr(jknobs, getter)(), (setter, value)
    os.environ["TORCHSNAPSHOT_TPU_TORCH_STRIPE_PART_SIZE_BYTES"] = "4096"
    try:
        assert tknobs.get_stripe_part_size_bytes() == 4096
        assert jknobs.get_stripe_part_size_bytes() == 64 << 20  # the JAX prefix is its own
    finally:
        del os.environ["TORCHSNAPSHOT_TPU_TORCH_STRIPE_PART_SIZE_BYTES"]


def _state(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal(40000).astype(np.float32),  # 160 KB: striped at 128 KiB
        "v": rng.integers(-9, 9, 3000).astype(np.int64),
    }


@contextlib.contextmanager
def _small_stripes():
    with tknobs.override_stripe_part_size_bytes(64 << 10), \
            tknobs.override_stripe_min_object_size_bytes(128 << 10), \
            tknobs.override_retry_backoff_cap_s(0.01), tknobs.override_disable_batching(True):
        yield


def _take(path, state):
    tts.Snapshot.take(path, {"app": tts.StateDict({k: torch.from_numpy(v.copy()) for k, v in state.items()})})


def _jax_restored(path, state):
    dest = jts.StateDict({k: np.zeros_like(v) for k, v in state.items()})
    jts.Snapshot(path).restore({"app": dest})
    return all(dest[k].tobytes() == state[k].tobytes() for k in state)


@pytest.mark.parametrize("site", ["storage.fs.write", "storage.fs.part.write", "storage.fs.write.sync"])
def test_fs_write_with_one_transient_commits(tmp_path, site):
    state = _state(1)
    path = str(tmp_path / "s")
    c0 = dict(tobs.counters())
    with _small_stripes(), tknobs.override_failpoints(f"{site}=eintr::1"):
        _take(path, state)
    c1 = tobs.counters()
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in (
        "resilience.retries", "resilience.fs.retries", "resilience.failpoints_fired",
        "storage.stripe.writes", "storage.stripe.parts_written", "storage.stripe.aborts")}
    assert delta["resilience.retries"] == delta["resilience.fs.retries"] == 1
    assert delta["resilience.failpoints_fired"] == 1
    assert delta["storage.stripe.writes"] == 1 and delta["storage.stripe.aborts"] == 0
    assert delta["storage.stripe.parts_written"] == 3  # 160 KB in 64 KiB parts, each once
    assert os.path.exists(os.path.join(path, ".snapshot_metadata"))
    assert not glob.glob(os.path.join(path, "**", "*.tsnp-tmp-*"), recursive=True)
    assert _jax_restored(path, state)


@pytest.mark.parametrize("site", ["storage.fs.write", "storage.fs.part.write", "storage.fs.write.sync",
                                  "scheduler.stage", "scheduler.write"])
def test_permanent_failure_leaves_no_metadata_and_no_temp_file(tmp_path, site):
    path = str(tmp_path / "s")
    with _small_stripes(), tknobs.override_failpoints(f"{site}=enospc"):
        with pytest.raises(OSError) as e:
            _take(path, _state(2))
    assert e.value.errno == errno.ENOSPC
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))
    assert not glob.glob(os.path.join(path, "**", "*.tsnp-tmp-*"), recursive=True)
    # nothing stays armed: the same take commits afterwards
    _take(path, _state(2))
    assert _jax_restored(path, _state(2))


def test_abort_of_a_failed_commit_outlives_the_takes_cancel(tmp_path):
    """A striped write whose commit failed is still aborting when the take
    cancels it (another object's write failed too).  The take then waits
    for every other task, as the scheduler does; the abort must be one of
    them, so no temp file outlives the take."""
    from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

    plugin = FSStoragePlugin(str(tmp_path))
    aborting = threading.Event()

    async def cancelled_while_aborting():
        handle = await plugin.begin_striped_write("o", 8)
        await handle.write_part(0, 0, b"01234567")
        close_fd = handle._close_fd

        def slow_close():
            aborting.set()
            time.sleep(0.5)  # the abort still runs when the cancel lands
            close_fd()

        handle._close_fd = slow_close
        task = asyncio.ensure_future(handle.complete())
        deadline = time.monotonic() + 30
        while not aborting.is_set():
            assert time.monotonic() < deadline, "the failed commit never aborted"
            await asyncio.sleep(0.01)
        task.cancel()
        await asyncio.wait(asyncio.all_tasks() - {asyncio.current_task()}, timeout=30)
        assert task.cancelled()

    try:
        with tknobs.override_failpoints("storage.fs.write.sync=enospc"):
            _run(cancelled_while_aborting())
        assert aborting.is_set()
        assert not glob.glob(str(tmp_path / "*.tsnp-tmp-*"))
        assert not os.path.exists(tmp_path / "o")
    finally:
        plugin.sync_close()


def test_breaker_fails_fast_after_consecutive_failures(tmp_path):
    trips = tobs.counter(tobs.RESILIENCE_BREAKER_TRIPS).value
    with _small_stripes(), tknobs.override_breaker_threshold(2), \
            tknobs.override_breaker_cooldown_s(60.0), tknobs.override_failpoints("storage.fs.write=io"):
        for i in range(2):
            with pytest.raises(OSError) as e:
                _take(str(tmp_path / f"s{i}"), {"v": np.arange(10)})
            assert not isinstance(e.value, tres.CircuitOpenError)
        assert tres.get_breaker("fs").state == "open"
    with _small_stripes(), pytest.raises(tres.CircuitOpenError, match="circuit breaker"):
        _take(str(tmp_path / "s3"), {"v": np.arange(10)})
    assert tobs.counter(tobs.RESILIENCE_BREAKER_TRIPS).value - trips == 1
    tres.reset_breakers()
    _take(str(tmp_path / "s4"), {"v": np.arange(10)})


def test_memory_plugin_transients_retry_through_a_take():
    from torchsnapshot_tpu_torch.storage.memory import reset_namespace

    state = _state(3)
    c0 = dict(tobs.counters())
    try:
        with _small_stripes(), tknobs.override_failpoints(
            "storage.memory.part.write=conn::1,storage.memory.write=timeout::1,storage.memory.read=eintr::1"
        ):
            _take("memory://res_t", state)
            dest = tts.StateDict({k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in state.items()})
            tts.Snapshot("memory://res_t").restore({"app": dest}, device="cpu")
        assert all(dest[k].numpy().tobytes() == state[k].tobytes() for k in state)
        c1 = tobs.counters()
        assert c1.get("resilience.memory.retries", 0) - c0.get("resilience.memory.retries", 0) == 3
    finally:
        reset_namespace("res_t")
