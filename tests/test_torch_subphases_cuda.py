"""The port's device sub-phase clocks on the card: the pinned allocation
and D2H wait of a CUDA take, the H2D copy of a restore into a CUDA
template and the pinned tile buffers of a budgeted read; and a take
loop whose third take draws the memory store's buffers from the pool.

Marked ``cuda``: each test skips, with the reason, where
``torch.cuda.is_available()`` is false.  On a machine with the card:
``python -m pytest --noconftest tests/test_torch_subphases_cuda.py -q``.
"""

import uuid

import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch import obs
from torchsnapshot_tpu_torch.storage import memory
from torchsnapshot_tpu_torch.storage.memory import reset_namespace

pytestmark = pytest.mark.cuda


@pytest.fixture
def namespace():
    ns = f"subphases-{uuid.uuid4().hex}"
    yield ns
    reset_namespace(ns)


def _counts():
    return {k: h["count"] for k, h in obs.metrics_snapshot()["histograms"].items()}


def _grew(before, after, name):
    return after.get(name, 0) > before.get(name, 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_cuda_take_restore_and_read_count_device_subphases(cuda, namespace):
    url = f"memory://{namespace}"
    leaf = torch.randn(512, 1024, generator=torch.Generator().manual_seed(4)).to(cuda)
    before = _counts()
    tts.Snapshot.async_take(url, {"m": tts.StateDict(w=leaf)}).wait()
    mid = _counts()
    for h in (obs.STAGE_PIN_ALLOC_S, obs.STAGE_D2H_WAIT_S, obs.STAGE_QUEUE_S, obs.TAKE_OFFLOAD_S):
        assert _grew(before, mid, h), h
    into = torch.zeros_like(leaf)
    tts.Snapshot(url).restore({"m": tts.StateDict(w=into)})
    torch.cuda.synchronize()
    assert torch.equal(into, leaf)
    after_restore = _counts()
    assert _grew(mid, after_restore, obs.CONSUME_H2D_S)
    out = torch.zeros(512, 1024, device=cuda)
    tts.Snapshot(url).read_object("0/m/w", obj_out=out, memory_budget_bytes=256 * 1024)
    torch.cuda.synchronize()
    assert torch.equal(out, leaf)
    after_read = _counts()
    assert _grew(after_restore, after_read, obs.READ_PIN_ALLOC_S)
    assert _grew(after_restore, after_read, obs.CONSUME_H2D_S)


def test_cuda_take_loop_draws_the_third_take_from_the_pool(cuda):
    spaces = [f"pool-{uuid.uuid4().hex}" for _ in range(2)]
    g = torch.Generator().manual_seed(5)
    state = {"m": tts.StateDict(**{
        f"w{i}": torch.randn(n, generator=g).to(cuda) for i, n in enumerate((1 << 26, 3 << 24, 1 << 22, 4097))
    })}
    memory.release_pool()
    alloc = []
    try:
        for i in range(3):
            for t in state["m"].values():
                t.add_(1)
            before = obs.metrics_snapshot()["histograms"].get(obs.WRITE_ALLOC_S, {"sum": 0.0})["sum"]
            tts.Snapshot.async_take(f"memory://{spaces[i % 2]}", state).wait()
            alloc.append(obs.metrics_snapshot()["histograms"][obs.WRITE_ALLOC_S]["sum"] - before)
            if i == 1:
                reset_namespace(spaces[0])
        assert alloc[2] < alloc[0] / 10, alloc
        into = {"m": tts.StateDict(**{k: torch.zeros_like(v) for k, v in state["m"].items()})}
        tts.Snapshot(f"memory://{spaces[0]}").restore(into)
        torch.cuda.synchronize()
        for k, v in state["m"].items():
            assert torch.equal(into["m"][k], v), k
    finally:
        for ns in spaces:
            reset_namespace(ns)
        memory.release_pool()
