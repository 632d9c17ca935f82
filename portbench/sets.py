"""Runs of cells one after another, one process each, with a summary of
each metric's median and spread (the distance between the quartiles
of ``statistics.quantiles(values, n=4)`` as a share of the median):
what the bounds in ``BENCHMARK.json`` are set from.

    python3 portbench/sets.py --workload <cell>[,<cell>...] --seeds 1,2,3 \\
        --seconds 30 --trace 0 [--out results.jsonl]

Each run's result line and the end of its standard error are appended
to ``--out``; runs of a cell follow each other on the same device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": p.returncode, "wall_s": wall,
            "result": result, "stderr_tail": p.stderr[-3000:]}


def summary(records: list) -> dict:
    out: dict = {}
    for r in records:
        if not r["result"]:
            continue
        for name, m in r["result"]["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    table = {}
    for name, values in out.items():
        row = {"n": len(values), "median": statistics.median(values), "values": values}
        if len(values) >= 2:
            q1, q2, q3 = statistics.quantiles(values, n=4)
            row["spread"] = (q3 - q1) / q2 if q2 else None
        table[name] = row
    return table


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    for workload in args.workload.split(","):
        records = []
        for seed in seeds:
            r = run_once(workload, seed, args.seconds, args.trace)
            records.append(r)
            res = r["result"] or {}
            print(json.dumps({"workload": workload, "seed": seed, "rc": r["rc"], "wall_s": round(r["wall_s"], 3),
                              "correct": res.get("correct"), "attempted": res.get("attempted"),
                              "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                              "peak": res.get("device", {}).get("memory_peak_bytes"),
                              "busy_s": res.get("device", {}).get("busy_s"),
                              "window_s": res.get("device", {}).get("window_s")}), flush=True)
            if r["rc"] != 0 or not res.get("correct"):
                print(r["stderr_tail"], flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
        print(json.dumps({"workload": workload, "summary": summary(records)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
