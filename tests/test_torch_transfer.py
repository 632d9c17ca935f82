"""The port's copies between pinned host memory and the card
(``ops/transfer.py``) and the helpers beside them, on the CPU.

The copies themselves need the card (``tests/test_torch_cuda.py``); here:
the landing decision every CUDA destination goes through, the gauge that
counts pinned read buffers in use, and ``io_types.run_on``.
"""

import asyncio
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from torchsnapshot_tpu_torch.io_types import run_on
from torchsnapshot_tpu_torch.obs import metrics
from torchsnapshot_tpu_torch.ops import device_pack, transfer


@pytest.mark.parametrize("dst,stored,numel,want", [
    (torch.zeros(4, 6), torch.float32, 24, None),
    (torch.zeros(4, 6), torch.bfloat16, 24, None),  # K2/K6 cast it
    (torch.zeros(24, dtype=torch.int64), torch.int8, 24, None),
    (torch.zeros(6, 4), torch.float32, 24, None),  # another shape, same elements in order
    (torch.zeros(4, 6).t(), torch.float32, 24, "layout"),
    (torch.zeros(4, 5), torch.float32, 24, "layout"),
    (torch.zeros(4, 6, dtype=torch.int32), torch.float32, 24, "cast"),
    (torch.zeros(4, 6, dtype=torch.int32).t(), torch.float32, 24, "layout"),  # layout first
    (torch.zeros(24, dtype=torch.uint8), torch.bool, 24, "cast"),
], ids=["identity", "float_cast", "int_cast", "reshaped", "strided", "other_numel",
        "float_to_int", "strided_and_cast", "bool"])
def test_card_miss_decides_layout_before_cast(dst, stored, numel, want):
    assert transfer.card_miss(dst, stored, numel) == want
    # the kernels' own table is the one the decision reads
    assert device_pack.cast_supported is transfer.cast_supported
    assert (want != "cast") or not device_pack.cast_supported(stored, dst.dtype)


def test_in_use_gauge_keeps_its_high_water_mark():
    g = metrics.Gauge("in_use")
    for n in (100, 50, -100, 30):
        g.add(n)
    assert (g.value, g.max) == (80, 150)
    g.reset_max()
    assert (g.value, g.max) == (80, 80)
    g.add(-80)
    assert (g.value, g.max) == (0, 80)


def test_in_use_gauge_loses_no_update_across_threads():
    g = metrics.Gauge("in_use")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                g.add(3)
                g.add(-3)
                g.add(1)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert g.value == 8 * 2000 and 8 * 2000 <= g.max <= 8 * 2000 + 8 * 3


def test_run_on_runs_on_the_executor_or_inline():
    loop_thread = []

    async def main(executor):
        loop_thread.append(threading.get_ident())
        return await run_on(executor, lambda a, b: (a + b, threading.get_ident()), 2, 3)

    with ThreadPoolExecutor(max_workers=1) as pool:
        total, ran_on = asyncio.run(main(pool))
        assert total == 5 and ran_on != loop_thread[-1]
    total, ran_on = asyncio.run(main(None))
    assert total == 5 and ran_on == loop_thread[-1]
