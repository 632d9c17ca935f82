#!/usr/bin/env python3
"""Same-call A/B of chip_smoke.py's many_ranks path on one NVIDIA GPU.

    python3 chip_ab_many_ranks.py LAYERS LABEL=TREE [LABEL=TREE ...]

Each TREE is the root of a checkout (``git archive <commit>`` unpacked
somewhere, or ``.`` for this one).  For each tree the path's two ranks
run as two processes on the one card, as chip_smoke.py runs them: that
tree's ``many_ranks_child`` (a world-2 sync take of the replicated model
and AdamW state plus per-rank state, a world-2 restore, an async_take and
a take in which rank 1's storage fails), with the model cut to LAYERS
layers in every tree.  The trees run in the order given, then reversed
(old, new, new, old for two), so that a drift of the machine falls on
both.  Before the timed runs each tree builds its kernels and its native
fast-I/O library once, outside any timing.

Around each rank's operations a timer counts the calls and seconds of the
coordination work a take and a restore do besides moving bytes:
``detect_topology`` (the topology exchange), ``LivenessSession.start`` /
``stop`` (the heartbeat), ``LivenessMonitor.check`` (the death checks of
every wait), ``Coordinator.all_gather_object`` and
``Coordinator.barrier``, where the tree has them.  Prints the card, one
line per rank and run (the child's own seconds, the pair's wall seconds
from spawn to exit, and the timers), and the median of each metric per
tree.
"""

import functools
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

TIMED = (
    ("take_s", "take"), ("restore_s", "restore"), ("async_unblock_s", "async unblock"),
    ("async_commit_s", "async commit"), ("failure_s", "failed take"),
)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown card"


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def install_timers(timers):
    """Wrap the coordination calls named in the module docstring; each
    wrapper adds its call's seconds to ``timers[name]``."""
    import importlib

    def wrap(owner, attr, name):
        fn = getattr(owner, attr, None)
        if fn is None:
            return

        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                c = timers.setdefault(name, [0, 0.0])
                c[0] += 1
                c[1] += time.perf_counter() - t0

        setattr(owner, attr, timed)

    coordination = importlib.import_module("torchsnapshot_tpu_torch.coordination")
    wrap(coordination.Coordinator, "all_gather_object", "all_gather_object")
    wrap(coordination.Coordinator, "barrier", "barrier")
    topology = importlib.import_module("torchsnapshot_tpu_torch.topology")
    wrap(topology, "detect_topology", "detect_topology")
    liveness = importlib.import_module("torchsnapshot_tpu_torch.resilience.liveness")
    for cls, attr in (("LivenessSession", "start"), ("LivenessSession", "stop"), ("LivenessMonitor", "check")):
        if hasattr(liveness, cls):
            wrap(getattr(liveness, cls), attr, f"{cls}.{attr}")


def child(tree, layers, rank, world, port, root):
    """One rank: the tree's many_ranks_child at ``layers`` layers, with
    the timers around it; prints the timers as one JSON line."""
    sys.path.insert(0, tree)
    import chip_smoke

    chip_smoke.N_LAYERS = chip_smoke.MANY_RANKS_LAYERS = layers
    timers = {}
    install_timers(timers)
    rc = chip_smoke.many_ranks_child(rank, world, port, root)
    print("ab timers " + json.dumps({k: [v[0], round(v[1], 6)] for k, v in sorted(timers.items())}), flush=True)
    return rc


def warm(tree):
    """Build the tree's kernels and fast-I/O library (cached under the
    tree's build directory), so no timed run compiles."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from torchsnapshot_tpu_torch.ops import kernels; kernels.build_all(); "
            "from torchsnapshot_tpu_torch import _csrc; assert _csrc.enabled_lib() is not None")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code, tree], check=True, cwd=tree, timeout=900)
    return time.perf_counter() - t0


def run_pair(label, tree, layers, work):
    root = os.path.join(work, f"{label}_{time.monotonic_ns()}")
    os.makedirs(root)
    port = free_port()
    logs = [open(os.path.join(root, f"rank{r}.log"), "w+") for r in range(2)]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", tree, str(layers), str(r), "2",
                          str(port), root], stdout=logs[r], stderr=subprocess.STDOUT, text=True, cwd=tree)
        for r in range(2)
    ]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    rows = []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        res = timers = None
        for line in text.splitlines():
            if line.startswith("many_ranks result "):
                res = json.loads(line[len("many_ranks result "):])
            elif line.startswith("ab timers "):
                timers = json.loads(line[len("ab timers "):])
        if p.returncode != 0 or res is None or timers is None:
            print(text[-4000:])
            raise RuntimeError(f"{label} rank {r} exited {p.returncode}")
        rows.append({"rank": r, "wall_s": wall, "timers": timers, **{k: res[k] for k, _ in TIMED}})
    subprocess.run(["rm", "-rf", root], check=False)
    return rows


def main():
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_many_ranks: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    layers = int(sys.argv[1])
    trees = [a.split("=", 1) for a in sys.argv[2:]]
    trees = [(label, os.path.abspath(path)) for label, path in trees]
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; {layers} layer(s)")
    for label, tree in trees:
        print(f"{label}: kernels and fast-I/O library built in {warm(tree):.1f} s", flush=True)
    order = trees + trees[::-1]
    summary = {}
    with tempfile.TemporaryDirectory(prefix="chip_ab_many_ranks_") as work:
        for i, (label, tree) in enumerate(order):
            for row in run_pair(label, tree, layers, work):
                print(f"run {i} {label} rank {row['rank']} ({card}): "
                      + ", ".join(f"{name} {row[k]:.4f} s" for k, name in TIMED)
                      + f"; pair wall {row['wall_s']:.2f} s; timers (calls, s) {json.dumps(row['timers'])}",
                      flush=True)
                s = summary.setdefault(label, {})
                for k, _ in TIMED:
                    s.setdefault(k, []).append(row[k])
                s.setdefault("wall_s", []).append(row["wall_s"])
                for name, (_, sec) in row["timers"].items():
                    s.setdefault(name, []).append(sec)
    for label, s in summary.items():
        print(f"{label} medians over runs and ranks ({card}): "
              + json.dumps({k: round(statistics.median(v), 4) for k, v in s.items()}))
    print(card)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 8 and sys.argv[1] == "--child":
        sys.exit(child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6]),
                       sys.argv[7]))
    sys.exit(main())
