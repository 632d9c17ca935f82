"""The port's training slice on the CPU: ``train_step`` against the JAX
package's, and ``Snapshot.async_take`` as the JAX package's async tests
(tests/test_async_take.py, tests/test_eager_offload.py) hold it —
unblocking before the I/O is done, errors through ``wait()`` with no
metadata written, sources mutated in place right after return (AdamW's
``step`` counter included), overlapping takes, and interop with the JAX
package.  Inputs come from seeded numpy generators."""

import asyncio
import dataclasses
import gc
import os
import weakref
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu.models import transformer as jtf
from torchsnapshot_tpu_torch import host_offload
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch.host_offload import eager_offload_write_reqs
from torchsnapshot_tpu_torch.models import transformer as ttf
from torchsnapshot_tpu_torch.preparers import prepare_write
from torchsnapshot_tpu_torch.snapshot import SNAPSHOT_METADATA_FNAME
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

# ---------------------------------------------------------------- train step


def _jax_state_dicts(ts):
    """(params, exp_avg, exp_avg_sq, count) of a JAX train state in the
    port's state_dict layout."""
    params = ttf.params_from_jax(jax.tree.map(np.asarray, ts.params))
    adam = ttf._find_adam_state(jax.tree.map(np.asarray, ts.opt_state))
    return params, ttf.params_from_jax(adam.mu), ttf.params_from_jax(adam.nu), int(adam.count)


def test_train_step_matches_jax():
    """TransformerConfig.tiny() in f32 in both packages: one JAX step from
    make_train_state(seed=0), carried into the port by params_from_jax +
    adamw_state_from_jax, then a second step in each on the same tokens.
    Tolerance: loss rtol 1e-5; parameters and Adam moments rtol 1e-4
    with atol 1e-6 / 1e-7 / 1e-9 (same f32 math in another order)."""
    jcfg = dataclasses.replace(jtf.TransformerConfig.tiny(), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    ta, tb = (rng.integers(0, jcfg.vocab, (2, 17)).astype(np.int32) for _ in range(2))
    step = jax.jit(jtf.train_step)
    ts1, _ = step(jtf.make_train_state(jcfg, seed=0), jnp.asarray(ta))
    ts2, want_loss = step(ts1, jnp.asarray(tb))

    cfg = dataclasses.replace(ttf.TransformerConfig.tiny(), dtype=torch.float32)
    model, opt = ttf.make_train_state(cfg, seed=3, device="cpu")
    model.load_state_dict(ttf.params_from_jax(jax.tree.map(np.asarray, ts1.params)))
    opt.load_state_dict(ttf.adamw_state_from_jax(jax.tree.map(np.asarray, ts1.opt_state), model))
    loss = ttf.train_step(model, opt, torch.from_numpy(tb).long())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)

    params, mu, nu, count = _jax_state_dicts(ts2)
    state = opt.state_dict()["state"]
    for i, (name, p) in enumerate(model.named_parameters()):
        torch.testing.assert_close(p.detach(), params[name], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(state[i]["exp_avg"], mu[name], rtol=1e-4, atol=1e-7)
        torch.testing.assert_close(state[i]["exp_avg_sq"], nu[name], rtol=1e-4, atol=1e-9)
        assert float(state[i]["step"]) == count == 2


def test_make_train_state_is_seeded_and_leaves_rng_alone():
    cfg = ttf.TransformerConfig.tiny()
    torch.manual_seed(123)
    before = torch.get_rng_state()
    a, _ = ttf.make_train_state(cfg, seed=4, device="cpu")
    b, opt = ttf.make_train_state(cfg, seed=4, device="cpu")
    assert torch.equal(torch.get_rng_state(), before)
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
    assert opt.defaults["lr"] == 3e-4 and opt.defaults["weight_decay"] == 0.01


# ---------------------------------------------------------------- async take


class SlowFSStoragePlugin(FSStoragePlugin):
    delay_s = 0.3

    async def write(self, write_io):
        await asyncio.sleep(self.delay_s)
        await super().write(write_io)


class FaultyFSStoragePlugin(FSStoragePlugin):
    """Fails after a delay, so the error must surface through wait()."""

    async def write(self, write_io):
        await asyncio.sleep(0.2)
        raise RuntimeError("injected storage failure")


@pytest.fixture
def patch_storage(monkeypatch):
    def patch(plugin_cls):
        import torchsnapshot_tpu_torch.snapshot as snapshot_mod

        monkeypatch.setattr(snapshot_mod, "url_to_storage_plugin", lambda path: plugin_cls(root=path))

    return patch


def _app_state():
    return {"app": tts.StateDict(w=torch.arange(4096, dtype=torch.float32), b=torch.ones(16), step=3)}


def test_async_take_unblocks_before_io_done(tmp_path, patch_storage):
    patch_storage(SlowFSStoragePlugin)
    pending = tts.Snapshot.async_take(str(tmp_path / "s"), _app_state())
    # every write sleeps delay_s first, so the return came before any I/O
    assert not pending.done()
    assert not os.path.exists(tmp_path / "s" / SNAPSHOT_METADATA_FNAME)
    snap = pending.wait()
    assert pending.done() and os.path.exists(tmp_path / "s" / SNAPSHOT_METADATA_FNAME)
    dest = tts.StateDict(w=torch.zeros(4096), b=torch.zeros(16), step=0)
    snap.restore({"app": dest})
    assert dest["step"] == 3 and torch.equal(dest["w"], torch.arange(4096, dtype=torch.float32))


def test_async_take_error_via_wait_and_no_metadata(tmp_path, patch_storage):
    patch_storage(FaultyFSStoragePlugin)
    pending = tts.Snapshot.async_take(str(tmp_path / "s"), _app_state())
    with pytest.raises(RuntimeError, match="injected storage failure"):
        pending.wait()
    assert not os.path.exists(tmp_path / "s" / SNAPSHOT_METADATA_FNAME)
    with pytest.raises(FileNotFoundError, match="not a committed snapshot"):
        _ = tts.Snapshot(str(tmp_path / "s")).metadata


@pytest.mark.parametrize("batching", [True, False], ids=["slabs", "no_slabs"])
def test_async_take_survives_the_next_train_step(tmp_path, patch_storage, batching):
    """The training loop's use: step, async_take, step again at once (it
    changes the parameters, the Adam moments and AdamW's CPU ``step``
    counter in place) while the snapshot drains, then restore into a
    differently seeded model: every tensor equals the state at
    async_take, and the step after it gives the same loss bitwise."""
    patch_storage(SlowFSStoragePlugin)  # the next step beats the writes
    cfg = ttf.TransformerConfig.tiny()
    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9))).long() for _ in range(3)]
    model, opt = ttf.make_train_state(cfg, seed=0, device="cpu")
    ttf.train_step(model, opt, batches[0])
    at_take = {k: v.clone() for k, v in model.state_dict().items()}
    opt_at_take = [{k: v.clone() for k, v in st.items()} for st in opt.state_dict()["state"].values()]
    with tknobs.override_disable_batching(not batching):
        pending = tts.Snapshot.async_take(str(tmp_path / "s"), {"model": model, "optim": opt})
    loss = ttf.train_step(model, opt, batches[1])
    pending.wait()

    model2, opt2 = ttf.make_train_state(cfg, seed=1, device="cpu")
    ttf.train_step(model2, opt2, batches[2])
    tts.Snapshot(str(tmp_path / "s")).restore({"model": model2, "optim": opt2})
    for name, t in model2.state_dict().items():
        assert torch.equal(t, at_take[name]), name
    for st, want in zip(opt2.state_dict()["state"].values(), opt_at_take):
        for k, v in want.items():
            assert torch.equal(st[k], v), k
    assert float(opt2.state_dict()["state"][0]["step"]) == 1.0
    assert torch.equal(ttf.train_step(model2, opt2, batches[1]), loss)


def test_two_async_takes_sequential(tmp_path):
    for p in ("a", "b"):
        tts.Snapshot.async_take(str(tmp_path / p), _app_state()).wait()
        assert os.path.exists(tmp_path / p / SNAPSHOT_METADATA_FNAME)


def test_two_async_takes_overlapping(tmp_path, patch_storage):
    patch_storage(SlowFSStoragePlugin)
    x = torch.arange(50000, dtype=torch.float64)
    y = torch.arange(30000, dtype=torch.float64) * 2
    p1 = tts.Snapshot.async_take(str(tmp_path / "a"), {"m": tts.StateDict(x=x)})
    p2 = tts.Snapshot.async_take(str(tmp_path / "b"), {"m": tts.StateDict(y=y)})
    x.zero_()
    y.zero_()
    s2, s1 = p2.wait(), p1.wait()  # reversed wait order on purpose
    oa, ob = tts.StateDict(x=torch.zeros(50000, dtype=torch.float64)), tts.StateDict(y=torch.zeros(30000, dtype=torch.float64))
    s1.restore({"m": oa})
    s2.restore({"m": ob})
    assert torch.equal(oa["x"], torch.arange(50000, dtype=torch.float64))
    assert torch.equal(ob["y"], torch.arange(30000, dtype=torch.float64) * 2)


@pytest.mark.parametrize("disable", [False, True])
def test_async_take_with_and_without_eager_staging(tmp_path, disable):
    src = torch.arange(4096, dtype=torch.float64)
    with tknobs.override_disable_eager_host_staging(disable):
        pending = tts.Snapshot.async_take(str(tmp_path / "s"), {"app": tts.StateDict(w=src, step=7)})
        src.fill_(-1.0)  # staged (knob on) or copied (knob off) before return
        snap = pending.wait()
    assert torch.equal(snap.read_object("0/app/w", device="cpu"), torch.arange(4096, dtype=torch.float64))
    assert snap.read_object("0/app/step") == 7


def test_eager_offload_takes_defensive_copy_now():
    src = torch.arange(256, dtype=torch.float32)
    _, reqs = prepare_write(src, "app/w", rank=0, is_async_snapshot=True)
    assert eager_offload_write_reqs(reqs) == src.numel() * 4
    src.fill_(-1.0)  # mutate after the offload, before staging
    buf = asyncio.run(reqs[0].buffer_stager.stage_buffer())
    assert np.array_equal(np.frombuffer(bytes(buf), np.float32), np.arange(256, dtype=np.float32))


def test_sync_take_plans_no_copies():
    src = np.arange(64, dtype=np.int32)
    _, reqs = prepare_write(src, "app/w", rank=0)
    assert eager_offload_write_reqs(reqs) == 0
    assert reqs[0].buffer_stager.arr is src


GB = 10**9


@pytest.mark.parametrize(
    "peak, live, want",
    [
        # 30 GB of state and 45 GB of activations: nothing fits beside the
        # next step, so every CUDA tensor blocks on a pinned host copy
        (75 * GB, 0, 0),
        # the same state with 20 GB of activations: 79 - 50 - 5 GB
        (50 * GB, 0, 24 * GB),
        # copies of an earlier take not staged yet come off the budget
        (50 * GB, 10 * GB, 14 * GB),
    ],
)
def test_device_copy_budget_leaves_the_next_step_its_peak(peak, live, want):
    """An 80 GB card whose allocator can hold 79 GB, 5 GB of it held back."""
    budget = host_offload.copy_budget_bytes(79 * GB, peak, live, 80 * GB)
    assert budget == want


def test_device_copies_are_counted_and_keep_their_pool_until_freed():
    device = torch.device("cuda", 7)  # only a key here: nothing is allocated on it
    copy, pool = torch.zeros(16), torch.zeros(1)  # stand-ins for a copy and its MemPool
    pool_ref = weakref.ref(pool)
    host_offload._track_live_copy(SimpleNamespace(tensor=copy), device, 64, pool)
    del pool
    gc.collect()
    assert host_offload._LIVE_COPY_BYTES[device] == 64 and pool_ref() is not None
    del copy
    gc.collect()
    assert host_offload._LIVE_COPY_BYTES[device] == 0 and pool_ref() is None


def test_async_take_snapshot_restores_bitwise_in_jax(tmp_path):
    """An async_take of the port's transformer state (batched into slabs)
    restores bitwise through the JAX package."""
    torch.manual_seed(0)
    cfg = ttf.TransformerConfig.tiny()
    model, _ = ttf.make_train_state(cfg, seed=2, device="cpu")
    with tknobs.override_slab_size_threshold_bytes(4096):
        tts.Snapshot.async_take(str(tmp_path), {"model": model}).wait()
    jsnap = jts.Snapshot(str(tmp_path))
    for name, t in model.state_dict().items():
        got = jsnap.read_object(f"0/model/{name}")
        assert np.asarray(got).tobytes() == t.contiguous().view(torch.uint8).numpy().tobytes(), name
