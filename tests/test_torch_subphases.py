"""The port's sub-phase clocks and the spans it writes onto a torch
profiler trace's clock.

On the CPU: a take, an async take, a restore and a budgeted read into
``memory://`` count the sub-phase histograms their paths reach, within
the phase clock they split, and add no ``phase.*`` name;
``obs.merge_into`` places a main-thread span at its ``record_function``
mark, carries a span recorded on a worker thread, and names each idle
stretch of the device by the innermost span around it.  The card's
sub-phases are in ``test_torch_subphases_cuda.py``.
"""

import json
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu.obs import metrics as jmetrics
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch import obs
from torchsnapshot_tpu_torch.obs import perfetto
from torchsnapshot_tpu_torch.storage.memory import reset_namespace

SUBPHASES = (
    obs.TAKE_PLAN_S, obs.TAKE_OFFLOAD_S, obs.STAGE_QUEUE_S, obs.STAGE_PIN_ALLOC_S,
    obs.STAGE_D2H_WAIT_S, obs.WRITE_ALLOC_S, obs.WRITE_COPY_S, obs.CONSUME_H2D_S,
    obs.READ_PIN_ALLOC_S,
)
# what splits what: the sub-phases time calls inside the phase's tasks
NESTED = {
    obs.PHASE_STAGE_S: (obs.STAGE_QUEUE_S, obs.STAGE_PIN_ALLOC_S, obs.STAGE_D2H_WAIT_S),
    obs.PHASE_WRITE_S: (obs.WRITE_ALLOC_S, obs.WRITE_COPY_S),
    obs.PHASE_CONSUME_S: (obs.CONSUME_H2D_S,),
}


@pytest.fixture
def traced():
    tr = obs.get_tracer()
    with knobs.override_trace(1):
        tr.reset()
        yield tr
    tr.reset()


@pytest.fixture
def namespace():
    ns = f"subphases-{uuid.uuid4().hex}"
    yield ns
    reset_namespace(ns)


def _histograms():
    return obs.metrics_snapshot()["histograms"]


def _delta(before, after, name):
    b = before.get(name, {"count": 0, "sum": 0.0})
    a = after.get(name, {"count": 0, "sum": 0.0})
    return a["count"] - b["count"], a["sum"] - b["sum"]


def _state(device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "m": tts.StateDict(
            # host slab members of at least 256 KiB pack on a staging thread
            w=torch.randn(256, 512, generator=g).to(device),
            b=torch.randn(300, 400, generator=g).to(device),
            big=torch.randn(1024, 1024, generator=g).to(device),
            step=3,
        )
    }


def _run(op, url):
    src = _state()
    if op == "take":
        tts.Snapshot.take(url, src)
    elif op == "striped_take":
        # the 4 MiB leaf writes in 1 MiB parts into one striped buffer
        with knobs.override_stripe_min_object_size_bytes(2 << 20), \
                knobs.override_stripe_part_size_bytes(1 << 20):
            tts.Snapshot.take(url, src)
    elif op == "async_take":
        tts.Snapshot.async_take(url, src).wait()
    elif op == "restore":
        tts.Snapshot(url).restore(_state(seed=1))
    else:
        out = torch.zeros(1024, 1024)
        tts.Snapshot(url).read_object("0/m/big", obj_out=out, memory_budget_bytes=64 * 1024)
        assert torch.equal(out, src["m"]["big"])


# op → the sub-phases a CPU run of it must count
_CPU_REACHED = {
    "take": {obs.TAKE_PLAN_S, obs.STAGE_QUEUE_S, obs.WRITE_ALLOC_S, obs.WRITE_COPY_S},
    "striped_take": {obs.TAKE_PLAN_S, obs.STAGE_QUEUE_S, obs.WRITE_ALLOC_S, obs.WRITE_COPY_S},
    "async_take": {obs.TAKE_PLAN_S, obs.TAKE_OFFLOAD_S, obs.STAGE_QUEUE_S, obs.WRITE_ALLOC_S,
                   obs.WRITE_COPY_S},
    "restore": set(),
    "read_object": set(),
}


@pytest.mark.parametrize("op", sorted(_CPU_REACHED))
def test_cpu_operations_count_their_subphases_within_their_phase(namespace, op):
    url = f"memory://{namespace}"
    if op in ("restore", "read_object"):
        tts.Snapshot.take(url, _state())
    before = _histograms()
    parts_before = obs.counters().get(obs.STRIPE_PARTS_WRITTEN, 0)
    _run(op, url)
    after = _histograms()
    assert (obs.counters().get(obs.STRIPE_PARTS_WRITTEN, 0) > parts_before) == (op == "striped_take")
    counted = {h for h in SUBPHASES if _delta(before, after, h)[0] > 0}
    # nothing on the host is a device copy or a pinned buffer
    assert counted == _CPU_REACHED[op]
    for phase, parts in NESTED.items():
        if op == "striped_take" and phase == obs.PHASE_WRITE_S:
            continue  # an object's parts copy at once, inside one write's clock
        assert sum(_delta(before, after, h)[1] for h in parts) <= _delta(before, after, phase)[1]
    # the flight record's phases stay the JAX package's
    jphases = {v for k, v in vars(jmetrics).items() if k.startswith("PHASE_") and k != "PHASE_PREFIX"}
    assert {h for h in after if h.startswith(obs.PHASE_PREFIX)} <= jphases
    assert not [h for h in SUBPHASES if h.startswith(obs.PHASE_PREFIX)]


def test_subphase_spans_are_leaves_on_their_own_tracks(namespace, traced):
    tts.Snapshot.async_take(f"memory://{namespace}", _state()).wait()
    spans = traced.spans()
    leaves = [s for s in spans if s.name in ("stage/queue", "write/alloc", "write/copy")]
    assert {s.name for s in leaves} == {"stage/queue", "write/alloc", "write/copy"}
    parents = {s.parent_id for s in spans}
    assert not [s for s in leaves if s.span_id in parents]
    doc = obs.to_trace_events(spans)
    tracks = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {"stage/queue", "write/copy"} <= tracks


def _profiled_run(path):
    """A CPU profile with spans around ``record_function`` marks on the
    main thread (three: a thread descheduled between the two entries
    delays one), and a span on a worker thread that a second mark of the
    main thread (``main/probe``) falls inside."""
    from torch.profiler import ProfilerActivity, profile, record_function

    started = threading.Event()

    def worker():
        with obs.span("worker/sleep"):
            started.set()
            time.sleep(0.06)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):  # the first mark pays for set-up
            pass
        for _ in range(3):
            with obs.span("main/outer"):
                with record_function("main/mark"):
                    time.sleep(0.005)
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(worker)
            started.wait()
            time.sleep(0.02)
            with record_function("main/probe"):
                time.sleep(0.002)
            fut.result()
    prof.export_chrome_trace(path)


def _by_name(doc, name):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("name") == name]


def test_merge_into_puts_spans_on_the_profiler_clock(tmp_path, traced):
    path = str(tmp_path / "trace.json")
    _profiled_run(path)
    raw = json.load(open(path))
    assert not _by_name(raw, "worker/sleep")  # the profiler does not see the worker
    # device work everywhere but the probe: one idle stretch, inside the
    # worker's span only
    probe = _by_name(raw, "main/probe")[0]
    xs = [e for e in raw["traceEvents"] if e.get("ph") == "X"]
    lo, hi = min(e["ts"] for e in xs), max(e["ts"] + e["dur"] for e in xs)
    for a, b in ((lo, probe["ts"]), (probe["ts"] + probe["dur"], hi)):
        raw["traceEvents"].append({"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
                                   "ts": a, "dur": b - a})
    json.dump(raw, open(path, "w"))
    idle = obs.merge_into(path)
    doc = json.load(open(path))
    pairs = list(zip(_by_name(doc, "main/mark"), _by_name(doc, "main/outer")))
    assert len(pairs) == 3
    assert min(abs(o["ts"] - m["ts"]) for m, o in pairs) < 500  # µs
    assert min(abs(o["ts"] + o["dur"] - m["ts"] - m["dur"]) for m, o in pairs) < 500
    outer = pairs[0][1]
    worker = _by_name(doc, "worker/sleep")
    assert len(worker) == 1 and worker[0]["ts"] < probe["ts"] < worker[0]["ts"] + worker[0]["dur"]
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert procs[worker[0]["pid"]] == "torchsnapshot_tpu_torch" == procs[outer["pid"]]
    assert list(idle) == ["worker/sleep"]
    assert idle["worker/sleep"] == pytest.approx(probe["dur"] / 1e6, rel=1e-6)


def _synthetic_trace(path, kernels_ms):
    """A trace whose base lies 1 s before now, with kernels at
    ``kernels_ms`` (start, end; ms after now) and a CPU event over 0–200
    ms; returns the monotonic clock's now."""
    mono, wall = obs.tracer.clock_pair()
    base = wall - 10**9
    to_us = lambda ms: 1e6 + 1e3 * ms  # noqa: E731
    events = [{"ph": "X", "cat": "cpu_op", "name": "op", "pid": 5, "tid": 5, "ts": to_us(0),
               "dur": 2e5}]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7, "ts": to_us(a),
                "dur": 1e3 * (b - a)} for a, b in kernels_ms]
    json.dump({"baseTimeNanoseconds": base, "traceEvents": events}, open(path, "w"))
    return mono


def _span(name, mono, a_ms, b_ms, parent=None):
    s = obs.Span(name, parent.span_id if parent else None, {})
    s.start_ns, s.end_ns = mono + int(a_ms * 1e6), mono + int(b_ms * 1e6)
    return s


@pytest.mark.parametrize(
    "kernels_ms, expect",
    [
        # gaps: 40–60 (inner), 100–150 (outer)
        ([(0, 40), (60, 100), (150, 200)], {"inner": 0.020, "outer": 0.050}),
        # no device work: one stretch over the window, named at its midpoint
        ([], {"outer": 0.140}),
        # a gap between spans, and one inside the last
        ([(0, 150.5), (154.5, 156), (164, 200)], {"(no span)": 0.004, "after": 0.008}),
    ],
)
def test_merge_into_names_idle_stretches_by_the_innermost_span(tmp_path, kernels_ms, expect):
    path = str(tmp_path / "t.json")
    mono = _synthetic_trace(path, kernels_ms)
    outer = _span("outer", mono, 10, 150)
    spans = [outer, _span("inner", mono, 30, 70, outer), _span("after", mono, 155, 165)]
    if not kernels_ms:
        spans = spans[:1]
    idle = perfetto.merge_into(path, spans)
    assert {k: round(v, 6) for k, v in idle.items()} == expect
    doc = json.load(open(path))
    assert _by_name(doc, "outer")[0]["ts"] == pytest.approx(1e6 + 1e4, abs=50)
