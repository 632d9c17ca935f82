"""The control of ``correct``: the plain reference put in the program's
place, computed one precision below the configuration's (float8 e4m3
for bfloat16 and float16, bfloat16 for float32), judged by the same
comparisons a run uses.  Every number it gives has to fail its limit.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

- a take cell: the plain writer stores every leaf at the lower
  precision, and the plain reader judges the stored snapshot;
- a restore cell: every destination holds the leaf at the lower
  precision;
- a read cell: every read leaf in every template dtype.

It runs at the cell's own size on the device; the benchmark's runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOWER = {"bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn", "float32": "bfloat16", "float64": "float32"}


def lowered(t, dtype_name: str):
    import torch

    return t.to(getattr(torch, LOWER[dtype_name])).to(t.dtype)


def control_checks(cell, state, device: Any) -> Dict[str, Dict[str, float]]:
    """The checks of the reference at the lower precision, in the place
    of the cell's traffic's output."""
    import torch

    from portbench.reference import writer
    from portbench.reference.check import check_snapshot, check_tensors

    loop = cell.traffic["loop"]
    seed, version = state.seed, 0
    if loop == "take":
        arrays = {
            s.path: lowered(s.expected(device, seed, version), str(s.dtype).split(".")[-1])
            for s in state.specs
        }
        objects = writer.write(arrays, state.primitives(version))
        del arrays
        return check_snapshot(objects, state.specs, state.primitives(version), seed, version, device)
    if loop == "restore":
        pairs = [
            (lowered(s.expected(device, seed, version), str(s.dtype).split(".")[-1]), s)
            for s in state.specs
        ]
        return check_tensors(pairs, seed, version, device)
    if loop == "read":
        pairs = []
        for i in state.read_leaves:
            s = state.specs[i]
            low = lowered(s.expected(device, seed, version), str(s.dtype).split(".")[-1])
            for name in cell.traffic["template_dtypes"]:
                pairs.append((low.to(getattr(torch, name)), s))
        return check_tensors(pairs, seed, version, device)
    raise ValueError(f"no control for loop {loop!r}")


def main() -> int:
    sys.path[:1] = [ROOT]
    from portbench import harness
    from portbench.reference.check import passed

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args()
    import torch

    cell = harness.resolve(harness.load_spec(), args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        state = harness.module("builders", cell.config["builder"]).build(cell.config, seed, device)
        try:
            checks = control_checks(cell, state, device)
        finally:
            state.close()
            del state
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, "control_passed": passed(checks),
                          "checks": checks, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
