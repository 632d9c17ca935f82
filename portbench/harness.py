"""One run of one cell: find its files by name, build the state, warm
up, measure the window, judge the outputs, print the result line.

Every piece is found by the name ``BENCHMARK.json`` gives it:
``configs/<file>`` (a configuration, whose ``builder`` key names a
module of ``builders/``), ``traffic/<traffic>.json`` (a traffic mix,
whose ``loop`` key names a module of ``loops/``), ``e2e/<metric>.py``
and ``metrics/<metric>.py`` (a reader of one metric each; a kernel's
roofline reader also declares its kernel, see ``kernels.py``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MODULE_NAME = re.compile(r"^[a-z][a-z0-9_]*$")
# top-level modules that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the latter's)
FORBIDDEN = {"jax", "jaxlib", "flax", "torchsnapshot_tpu"}


@dataclass
class Context:
    """What a metric reader reads: the window, the program's histogram
    sums over it (seconds), and in a traced run the device trace and the
    bytes each declared kernel's calls needed, by its trace name."""

    window: Any
    phases: Dict[str, float] = field(default_factory=dict)
    trace: Optional[Any] = None
    kernel_bytes: Dict[str, int] = field(default_factory=dict)
    peaks: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """A metric with ``workloads`` is read in those cells; an end-to-end
    one without, in every cell; a per-layer one without, in every cell
    that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(spec: Dict[str, Any], name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    workload = next((w for w in spec["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == workload["config"])
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{workload['traffic']}.json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(name, workload, config, traffic, e2e, per_layer)


def module(package: str, name: str) -> Any:
    if not MODULE_NAME.match(name):
        raise ValueError(f"bad module name {name!r}")
    return importlib.import_module(f"portbench.{package}.{name}")


def load_reader(kind: str, metric: str) -> Any:
    """The module ``<kind>/<metric>.py`` (``kind``: e2e or metrics)."""
    path = os.path.join(HERE, kind, f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, metric: str) -> Callable[[Context], Optional[float]]:
    """``value`` of ``<kind>/<metric>.py``."""
    return load_reader(kind, metric).value


def phase_sums() -> Dict[str, float]:
    from torchsnapshot_tpu_torch.obs.metrics import metrics_snapshot

    return {k: h["sum"] for k, h in metrics_snapshot()["histograms"].items()}


def loaded_forbidden() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _host_memory_line() -> str:
    try:
        with open("/proc/meminfo") as f:
            return " ".join(next(line for line in f if line.startswith("MemAvailable")).split())
    except (OSError, StopIteration):
        return "MemAvailable unknown"


def _quartiles(values: List[float]) -> str:
    """min / quartiles / max of ``values``, for the log."""
    if len(values) < 2:
        return str([round(v, 3) for v in values])
    import statistics

    q = statistics.quantiles(values, n=4)
    return "/".join(f"{v:.1f}" for v in (min(values), *q, max(values)))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(
    cell: Cell, seed: int, seconds: float, trace: bool, device: Any, t_process: float,
    chips: int = 1,
) -> Dict[str, Any]:
    """One run; returns the result object (``correct`` False where a
    check fails or an operation failed)."""
    import torch

    from . import devtrace, kernels

    on_gpu = torch.device(device).type == "cuda"
    log(_host_memory_line())
    if on_gpu:
        log(f"device {torch.cuda.get_device_name(0)}; power: {_power_limit()}; torch {torch.__version__}")
    builder = module("builders", cell.config["builder"])
    state = builder.build(cell.config, seed, device)
    annotate = devtrace.Spans(trace)
    loop = module("loops", cell.traffic["loop"]).Loop(state, cell.traffic, device, annotate)
    try:
        loop.setup()
        if on_gpu:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_process
        log(f"state {state.nbytes} bytes in {len(state.specs)} leaves; set-up {setup_s:.3f} s; {_host_memory_line()}")
        ctx = Context(window=None, peaks=load_json(os.path.join(HERE, "peaks.json")))
        chosen = cell.per_layer if trace else cell.end_to_end
        kind = "metrics" if trace else "e2e"
        readers = {m["name"]: load_reader(kind, m["name"]) for m in chosen if m["name"] != "setup_s"}
        before = phase_sums()
        trace_path = os.path.join(ROOT, "build", "portbench", f"{cell.name}.trace.json")
        if trace:
            os.makedirs(os.path.dirname(trace_path), exist_ok=True)
            with kernels.ByteRecorder(readers.values()) as rec, devtrace.profiled(trace_path):
                with annotate(devtrace.WINDOW):
                    window = loop.run(seconds)
            ctx.kernel_bytes = dict(rec.bytes)
        else:
            window = loop.run(seconds)
        after = phase_sums()
        ctx.window = window
        ctx.phases = {k: v - before.get(k, 0.0) for k, v in after.items()}
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        if trace:
            ctx.trace = devtrace.load(trace_path, annotate.spans)
        checks = loop.verify()
    finally:
        loop.close()
        state.close()
    from .reference.check import passed

    metrics: Dict[str, Dict[str, Any]] = {}
    missing = []
    for m in chosen:
        value = setup_s if m["name"] == "setup_s" else readers[m["name"]].value(ctx)
        if value is None:
            missing.append(m["name"])
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if missing:
        log(f"no reading for {missing}")
    dev: Dict[str, Any] = {
        "platform": "gpu" if on_gpu else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
        "count": chips,
        "memory_peak_bytes": int(peak),
    }
    result: Dict[str, Any] = {
        "correct": bool(passed(checks) and window.failed == 0 and window.done),
        "attempted": len(window.ops),
        "failed": window.failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops, "idle_gaps": ctx.trace.idle_gaps}
    result["checks"] = checks
    log(f"op ms: {_quartiles([1e3 * (o.t_end - o.t_start) for o in window.ops])}; "
        f"held ms: {_quartiles([1e3 * (o.t_unblock - o.t_start) for o in window.ops])}")
    if len(window.ops) <= 64:
        log("each op ms (held): " + " ".join(
            f"{1e3 * (o.t_end - o.t_start):.0f}({1e3 * (o.t_unblock - o.t_start):.0f})" for o in window.ops))
    log(
        f"window {window.seconds:.3f} s, {len(window.ops)} ops, {window.failed} failed; "
        f"program phases (s): " + json.dumps({k: round(v, 6) for k, v in ctx.phases.items() if v})
    )
    return result


def parse_args(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, t_process: Optional[float] = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse_args(argv)
    cell = resolve(load_spec(), args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      t_process, chips)
    bad = loaded_forbidden()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
