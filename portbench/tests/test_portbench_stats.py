"""The yardstick's arithmetic on synthetic numbers: rates over whole
windows, the 95th percentile over all requests, spreads, rooflines and
the idle share of a device timeline."""

import statistics

import pytest

from portbench import devtrace, harness, kernels, readers, stats
from portbench.stats import Op, Window


def _window():
    w = Window(t_start=10.0)
    w.ops = [Op(10.0, 10.1, 12.0, 4_000_000_000), Op(12.5, 12.55, 14.0, 4_000_000_000),
             Op(14.0, 14.2, 15.0, 4_000_000_000, ok=False)]
    w.t_end = 16.0
    return w


def test_rate_counts_completed_ops_over_the_whole_window():
    w = _window()
    assert w.seconds == 6.0 and w.failed == 1 and len(w.done) == 2
    assert stats.rate_gbps(w) == pytest.approx(8.0 / 6.0)
    assert stats.rate_gbps(Window(0.0, 1.0)) is None


def test_mean_and_median_unblock_over_completed_takes():
    assert stats.mean_unblock_ms(_window()) == pytest.approx((100.0 + 50.0) / 2)
    w = Window(0.0, 10.0, [Op(0, h / 1e3, 1, 1) for h in (30.0, 31.0, 35.0, 900.0)])
    assert stats.median_unblock_ms(w) == pytest.approx(33.0)
    assert stats.median_unblock_ms(Window(0.0, 1.0)) is None


def test_p95_over_every_request():
    w = Window(0.0, 200.0, [Op(i, i, i + (i + 1) / 1000.0, 1) for i in range(100)])
    # latencies 1..100 ms: rank 0.95 * 99 = 94.05 → 95.05 ms
    assert stats.latency_p95_ms(w) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0 and stats.percentile([], 95) is None


def test_spread_is_the_quartile_distance_over_the_median():
    values = [9.0, 10.0, 10.0, 11.0, 12.0, 10.5]
    q1, q2, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / q2)


def test_union_busy_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.union(iv, 0, 10) == [(0, 3), (5, 6), (9, 10)]
    assert stats.busy_seconds(iv, 0, 10) == 5
    assert stats.gaps(stats.union(iv, 0, 10), 0, 10) == [(3, 5), (6, 9)]
    assert stats.gaps([], 0, 4) == [(0, 4)]


def test_roofline_share():
    assert stats.roofline_pct(3_350_000_000, 2e-3, 3.35e12) == pytest.approx(50.0)
    assert stats.roofline_pct(0, 1.0, 3.35e12) is None
    assert stats.roofline_pct(10, 0.0, 3.35e12) is None


def _events():
    us = 1e6
    return [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 100.0 * us, "dur": 10.0 * us},
        {"ph": "X", "cat": "kernel", "name": "(anon)::slab_pack_kernel(x)", "ts": 101.0 * us, "dur": 1.0 * us},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 101.5 * us, "dur": 2.5 * us},
        {"ph": "X", "cat": "kernel", "name": "other", "ts": 108.0 * us, "dur": 4.0 * us},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 104.0 * us, "dur": 1.0 * us},
    ]


def test_trace_reduction_busy_kernels_and_idle_by_span():
    # host spans on another clock: the window started at host time 0
    spans = [(devtrace.WINDOW, 0.0, 10.0), ("pb/wait", 4.0, 7.9)]
    t = devtrace.reduce(_events(), spans)
    assert t.window_s == pytest.approx(10.0)
    # device busy: [101, 104] and [108, 110] inside the window
    assert t.busy_s == pytest.approx(5.0)
    assert t.kernel_seconds("slab_pack_kernel") == pytest.approx(1.0)
    assert t.device_ops[0] == ["Memcpy DtoH", pytest.approx(2.5)]
    idle = dict(t.idle_gaps)
    # idle [100, 101] and [104, 108]: the second's midpoint lies in pb/wait
    assert idle["pb/wait"] == pytest.approx(4.0) and idle["pb/other"] == pytest.approx(1.0)
    assert devtrace.reduce(_events()[1:]) is None


def test_readers_on_a_synthetic_trace():
    t = devtrace.reduce(_events(), [(devtrace.WINDOW, 0.0, 10.0)])
    ctx = harness.Context(window=_window(), phases={"phase.stage_s": 3.0}, trace=t,
                          kernel_bytes={"slab_pack_kernel": 335_000_000}, peaks={"hbm_bytes_per_s": 3.35e12})
    assert readers.phase_ms_per_op(ctx, "phase.stage_s") == pytest.approx(1500.0)
    assert readers.phase_ms_per_op(ctx, "phase.write_s") is None
    # 335 MB at 3.35 TB/s is 0.1 ms, of 1 s of K1
    assert harness.reader("metrics", "k1_roofline")(ctx) == pytest.approx(0.01)
    assert harness.reader("metrics", "k6_roofline")(ctx) is None
    assert readers.device_idle_pct(ctx) == pytest.approx(50.0)
    ctx.trace = None
    assert readers.device_idle_pct(ctx) is None and readers.kernel_roofline(ctx, "slab_pack_kernel") is None


def test_kernel_bytes_from_call_arguments():
    import torch

    class Fake:
        def __init__(self, n, size, dev="cuda"):
            self.n, self.size, self.device = n, size, torch.device(dev)

        def numel(self):
            return self.n

        def element_size(self):
            return self.size

    k1, k2, k6 = (harness.load_reader("metrics", f"{k}_roofline").nbytes for k in ("k1", "k2", "k6"))
    assert k1([Fake(10, 2), Fake(6, 4)]) == 2 * (20 + 24)
    assert k1([Fake(10, 2, "cpu")]) == 0
    members = [(0, "bfloat16", (2, 5)), (32, "float32", (3,))]
    assert k2(Fake(64, 1), members, [Fake(10, 4), Fake(3, 4)]) == (20 + 12) + (40 + 12)
    assert k6(Fake(100, 4), 0, Fake(50, 2)) == 50 * (2 + 4)
    assert k6(Fake(100, 4, "cpu"), 0, Fake(50, 2, "cpu")) == 0


def test_byte_recorder_wraps_what_the_readers_declare(monkeypatch):
    import types

    target = types.ModuleType("portbench_fake_ops")
    target.launch = lambda n: n * 10
    monkeypatch.setitem(__import__("sys").modules, "portbench_fake_ops", target)
    declared = types.SimpleNamespace(ENTRY="portbench_fake_ops:launch", TRACE_NAME="fake_kernel",
                                     nbytes=lambda n: 3 * n)
    plain = types.SimpleNamespace(value=lambda ctx: None)
    with kernels.ByteRecorder([declared, plain]) as rec:
        assert target.launch(2) == 20 and target.launch(5) == 50
    assert rec.bytes == {"fake_kernel": 21}
    assert target.launch(1) == 10 and rec.bytes == {"fake_kernel": 21}
