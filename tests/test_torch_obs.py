"""The port's observability layer (``torchsnapshot_tpu_torch/obs``) against
the JAX package's (``torchsnapshot_tpu/obs``) on the CPU.

The same observations give equal histograms and identical OpenMetrics
text; the same span lists give the same Perfetto JSON; tracing off is the
shared no-op; and the same state, taken traced by both packages, gives the
same span tree on the main-path names, the same flight-record counters and
the same phase counts.  Inputs come from a seeded numpy generator.
"""

import collections
import json
import os
import threading

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jts
import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu import obs as jobs
from torchsnapshot_tpu.obs import metrics as jmetrics
from torchsnapshot_tpu.obs import tracer as jtracer
from torchsnapshot_tpu_torch import knobs as tknobs
from torchsnapshot_tpu_torch import obs as tobs
from torchsnapshot_tpu_torch.obs import metrics as tmetrics
from torchsnapshot_tpu_torch.obs import tracer as ttracer


@pytest.fixture
def traced():
    tr = tobs.get_tracer()
    with tknobs.override_trace(1):
        tr.reset()
        yield tr
    tr.reset()


def _observations(seed):
    rng = np.random.default_rng(seed)
    lat = np.concatenate([rng.exponential(0.05, 200), [0.0005, 60.0, 61.0, 0.0]])
    nbytes = rng.integers(0, 1 << 33, 200).astype(float)
    return lat, nbytes


def test_histograms_gauges_and_registry_match_jax():
    lat, nbytes = _observations(0)
    for bounds, values in (
        (jmetrics.LATENCY_BUCKETS_S, lat),
        (jmetrics.BYTES_BUCKETS, nbytes),
        ((1.0, 2.0, 3.0), lat * 40),
    ):
        j, t = jmetrics.Histogram("h", bounds), tmetrics.Histogram("h", bounds)
        for v in values:
            j.observe(float(v))
            t.observe(float(v))
        assert t.to_dict() == j.to_dict() and t.count == len(values)
    for bad in ((2.0, 1.0), (1.0, 1.0)):
        with pytest.raises(ValueError):
            tmetrics.Histogram("bad", bad)
    jg, tg = jmetrics.Gauge("g"), tmetrics.Gauge("g")
    for v in (3.0, 1.0):
        jg.set(v), tg.set(v)
    jg.set_max(7.0), tg.set_max(7.0)
    assert (tg.value, tg.max) == (jg.value, jg.max) == (1.0, 7.0)
    # every metric name of the JAX package is carried, with the same value
    jnames = {k: v for k, v in vars(jmetrics).items() if k.isupper() and isinstance(v, str)}
    assert {k: getattr(tmetrics, k, None) for k in jnames} == jnames
    assert tmetrics.BYTES_BUCKETS == jmetrics.BYTES_BUCKETS
    assert tmetrics.LATENCY_BUCKETS_S == jmetrics.LATENCY_BUCKETS_S


def _fill(registry, mod, seed):
    lat, nbytes = _observations(seed)
    registry.counter(mod.BYTES_WRITTEN).inc(12345)
    registry.counter("storage.fs.write_bytes").inc(7)
    registry.counter("weird name-with/chars").inc()
    registry.gauge(mod.BUDGET_BYTES_IN_USE).set(2.5)
    registry.gauge(mod.GOODPUT_OVERHEAD_FRACTION).set(0.125)
    for v in lat:
        registry.histogram(mod.PHASE_WRITE_S).observe(float(v))
    for v in nbytes:
        registry.histogram("storage.fs.write_size", mod.BYTES_BUCKETS).observe(float(v))


def test_openmetrics_text_matches_jax(tmp_path):
    from torchsnapshot_tpu.obs import export as jexport

    jr, tr = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _fill(jr, jmetrics, 1)
    _fill(tr, tmetrics, 1)
    text = tobs.export_openmetrics(tr)
    assert text == jexport.export_openmetrics(jr)
    assert "tsnp_weird_name_with_chars_total 1" in text
    # the textfile: atomic, written only when the knob names a path, {pid}
    out = tobs.write_metrics_textfile(str(tmp_path / "m.prom"), tr)
    assert open(out).read() == text
    assert tobs.maybe_write_metrics_textfile() is None
    with tknobs.override_metrics_textfile(str(tmp_path / "x.{pid}.prom")):
        got = tobs.maybe_write_metrics_textfile()
    assert got == str(tmp_path / f"x.{os.getpid()}.prom") and os.path.exists(got)
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tsnp-metrics-")]


def _span_lists(seed):
    """The same synthetic spans built with each package's ``Span``:
    overlapping stage siblings, more concurrent admissions than the slot
    cap, flows, thread-track spans, nesting and one never closed."""
    rng = np.random.default_rng(seed)
    rows = []
    t = 1_000_000
    for i in range(6):  # overlapping staging spans
        start = t + int(rng.integers(0, 5000))
        rows.append(("pipeline/staging", start, start + int(rng.integers(1000, 9000)), {"path": f"p{i}"}))
    for i in range(40):  # more open at once than the 32-slot cap
        rows.append(("pipeline/budget_admission", t + i, t + 100_000 + int(rng.integers(0, 1000)), {"i": i}))
    rows.append(("take", t - 10, t + 200_000, {"path": "/s"}))
    rows.append(("take/plan", t, t + 50, {}))
    rows.append(("storage/write", t + 20_000, t + 30_000, {"bytes": 5}))
    rows.append(("pipeline/io", t + 20_000, t + 31_000, {"bytes": 5}))
    rows.append(("offload/eager", t + 5, t + 500, {"reqs": 3}))
    rows.append(("unclosed", t + 1, 0, {}))
    take_id = 1 + [r[0] for r in rows].index("take")
    out = []
    for mod in (jtracer, ttracer):
        spans = []
        for k, (name, start, end, attrs) in enumerate(rows):
            s = mod.Span(name, take_id if name == "take/plan" else None, dict(attrs))
            s.span_id, s.start_ns, s.end_ns = k + 1, start, end
            spans.append(s)
        spans[0].flow_out = spans[-3].flow_in = 17
        out.append(spans)
    return out


def test_perfetto_trace_events_match_jax(tmp_path, traced):
    jspans, tspans = _span_lists(2)
    doc = tobs.to_trace_events(tspans)
    assert json.dumps(doc, sort_keys=True) == json.dumps(jobs.to_trace_events(jspans), sort_keys=True)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(tspans) - 1  # the unclosed span is skipped
    admission_tids = {e["tid"] for e in xs if e["name"] == "pipeline/budget_admission"}
    assert 1 < len(admission_tids) <= 32
    staging = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in xs if e["name"] == "pipeline/staging")
    for a, b in zip(staging, staging[1:]):
        assert b[0] >= a[1] or a[2] != b[2]  # overlapping siblings never share a track
    assert {e["ph"] for e in doc["traceEvents"]} >= {"M", "X", "s", "f"}
    # write_trace exports the tracer's closed spans
    with tobs.span("a"):
        with tobs.span("b"):
            pass
    n = tobs.write_trace(str(tmp_path / "t.json"))
    events = json.load(open(tmp_path / "t.json"))["traceEvents"]
    assert n == 2 and sorted(e["name"] for e in events if e["ph"] == "X") == ["a", "b"]


def test_span_is_the_shared_noop_when_tracing_is_off(monkeypatch):
    assert not ttracer.ENABLED and not tobs.tracing_enabled()
    before = len(tobs.get_tracer())
    assert tobs.span("anything", bytes=1) is ttracer.NULL_CM
    with tobs.span("nothing") as s:
        assert s is None
    assert len(tobs.get_tracer()) == before
    with tknobs.override_trace(1):
        assert ttracer.ENABLED and tobs.span("x") is not ttracer.NULL_CM
    assert not ttracer.ENABLED
    monkeypatch.setenv("TORCHSNAPSHOT_TPU_TORCH_TRACE", "1")
    assert tobs.refresh_enabled()
    monkeypatch.delenv("TORCHSNAPSHOT_TPU_TORCH_TRACE")
    assert not tobs.refresh_enabled()


def test_spans_nest_across_threads_cap_and_begin_end(traced, monkeypatch):
    def worker():
        with tobs.span("w_outer"):
            with tobs.span("w_inner"):
                pass

    with tobs.span("main_outer", a=1):
        t = threading.Thread(target=worker)
        t.start()
        t.join(30)
        with tobs.span("main_inner") as inner:
            inner.attrs["late"] = True
    with pytest.raises(RuntimeError):
        with tobs.span("boom"):
            raise RuntimeError("x")
    spans = {s.name: s for s in traced.spans()}
    assert spans["main_inner"].parent_id == spans["main_outer"].span_id
    assert spans["w_inner"].parent_id == spans["w_outer"].span_id
    assert spans["w_outer"].parent_id is None  # a fresh thread, a fresh context
    assert spans["main_inner"].attrs == {"late": True} and spans["boom"].attrs["error"]
    s = traced.begin("manual", k="v")
    traced.end(s)
    end = s.end_ns
    traced.end(s)
    assert s.end_ns == end and s.parent_id is None
    traced.reset()
    monkeypatch.setattr(ttracer, "_MAX_SPANS", 5)
    for i in range(8):
        with tobs.span(f"s{i}"):
            pass
    assert len(traced) == 5 and traced.dropped == 3


def test_log_event_fires_span_events_and_entry_points_load(traced, monkeypatch):
    from torchsnapshot_tpu_torch import event_handlers as eh

    seen = []
    tts.register_event_handler(seen.append)
    try:
        with eh.log_event(tts.Event("my_op", {"k": 1})):
            with tobs.span("child_work", bytes=7):
                pass
        with tknobs.override_trace(0):
            with eh.log_event(tts.Event("untraced")):
                with tobs.span("hidden"):
                    pass
    finally:
        tts.unregister_event_handler(seen.append)
    spans = {s.name: s for s in traced.spans()}
    assert spans["child_work"].parent_id == spans["my_op"].span_id
    assert "untraced" not in spans and "hidden" not in spans
    names = [e.name for e in seen]
    assert names.count("span/child_work") == 1 and names.count("my_op") == 1
    assert "span/my_op" not in names and "span/hidden" not in names and "untraced" in names
    # entry-point discovery under the port's own group
    got = []

    class _EP:
        name = "collector"

        def load(self):
            return got.append

    class _EPs:
        def select(self, group):
            return [_EP()] if group == "torchsnapshot_tpu_torch.event_handlers" else []

    import importlib.metadata

    monkeypatch.setattr(importlib.metadata, "entry_points", lambda: _EPs())
    monkeypatch.setattr(eh, "_entry_points_loaded", False)
    monkeypatch.setattr(eh, "_entry_point_handlers", [])
    with tobs.span("seen_by_entry_point"):
        pass
    assert [e.name for e in got] == ["span/seen_by_entry_point"]


# ------------------------------------------------- the same take, both packages

# The main-path span names compared exactly.  Left out, with the reason:
# - "topology/detect": the JAX package's topology subsystem, not ported;
# - "storage/mmap_read", "fastio/read_into": the JAX package maps small
#   metadata reads (mmap reads are not ported), the port reads them
#   through the fast-I/O engine;
# - "fastio/write_file": the same engine in both, but run on the fs
#   plugin's own thread pool, where neither package carries a parent.
_MAIN_PATH = (
    "take", "async_take", "restore", "read_object", "take/plan", "restore/load_stateful",
    "offload/eager", "pipeline/budget_admission", "pipeline/staging", "pipeline/slab_pack",
    "pipeline/io", "pipeline/consume", "storage/write", "storage/read", "obs/publish",
    "obs/write_obsrecord", "obs/exchange_and_merge", "goodput/take_begin",
    "goodput/take_unblocked", "goodput/durable_commit",
)


def _state(pkg, conv, seed):
    rng = np.random.default_rng(seed)
    arrays = {
        "w": rng.standard_normal((64, 64)).astype(np.float32),
        "b": rng.standard_normal(16).astype(np.float32),
        "big": rng.standard_normal((600, 1024)).astype(np.float32),
        "ids": rng.integers(0, 1000, 300).astype(np.int64),
    }
    return {"m": pkg.StateDict(**{k: conv(v) for k, v in arrays.items()}, step=3)}


def _run(pkg, conv, root, op):
    """Take (sync or async) a seeded state with ``pkg``, or restore one it
    took, traced; returns the (name, parent name) counts on the main-path
    names, the record's headline counters and the phase counts."""
    path = str(root / op)
    with pkg.knobs.override_slab_size_threshold_bytes(1 << 20):
        if op == "restore":
            pkg.Snapshot.take(path, _state(pkg, conv, 3))
        tracer = pkg.obs.get_tracer()
        with pkg.knobs.override_trace(1):
            tracer.reset()
            if op == "take":
                pkg.Snapshot.take(path, _state(pkg, conv, 3))
            elif op == "async_take":
                pkg.Snapshot.async_take(path, _state(pkg, conv, 3)).wait()
            else:
                pkg.Snapshot(path).restore(_state(pkg, conv, 4))
            spans = tracer.spans()
        tracer.reset()
    by_id = {s.span_id: s for s in spans}
    pairs = collections.Counter(
        (s.name, by_id[s.parent_id].name if s.parent_id in by_id else None)
        for s in spans if s.name in _MAIN_PATH
    )
    rec = (
        pkg.obs.aggregate.last_record("restore") if op == "restore"
        else pkg.obs.aggregate.read_obsrecord(path)
    )
    counters = rec["merged"]["counters"]
    headline = {k: counters.get(k, 0) for k in ("bytes_written", "bytes_staged", "slabs_packed", "bytes_read")}
    phases = {k: v["count"] for k, v in rec["per_rank"]["0"]["phases"].items()}
    return pairs, headline, phases, rec


@pytest.mark.parametrize("op", ["take", "async_take", "restore"])
def test_the_same_traced_operation_in_both_packages(tmp_path, op):
    jpairs, jhead, jphases, jrec = _run(jts, lambda a: a, tmp_path / "jax", op)
    tpairs, thead, tphases, trec = _run(tts, torch.from_numpy, tmp_path / "port", op)
    assert tpairs == jpairs
    assert thead == jhead
    assert tphases == jphases
    assert (trec["op"], trec["ranks_reported"], trec["missing_ranks"]) == (
        jrec["op"], jrec["ranks_reported"], jrec["missing_ranks"]
    )
    if op == "restore":
        assert thead["bytes_read"] > 0 and set(tphases) == {"read", "consume"}
    else:
        assert thead["bytes_written"] == thead["bytes_staged"] > 0
        assert set(tphases) == {"stage", "write"}
        # under trace the record names the slowest objects
        assert trec["slow_objects"] and all(o["seconds"] >= 0 for o in trec["slow_objects"])
