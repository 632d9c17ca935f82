"""Concurrent budgeted reads of single objects out of one snapshot.

Set-up takes the state once into ``memory://``.  ``readers`` threads
then run a closed loop each over decks of every (read leaf, template
dtype) pair, each deck shuffled from the seed, so each leaf is drawn
uniformly and every seed sends the same mix in another order.  The
template, a fresh CUDA tensor, is filled with a marker before the read;
the read is ``read_object(path, obj_out=template,
memory_budget_bytes=...)`` timed from its issue to
``torch.cuda.synchronize()``.  A sample of the reads drawn from the
seed, with the first read of each largest leaf in each dtype, is kept
(a device copy made after its timing ends) and judged once the window
has closed.
"""

from __future__ import annotations

import math
import random
import sys
import threading
import time
import traceback
from typing import Any, Dict, List

import torch

from ..reference.check import check_tensors
from ..reference.fill import leaf_seed
from ..stats import Op, Window
from . import synchronize

NAMESPACE = "portbench-read"


class Loop:
    def __init__(self, state, traffic: Dict[str, Any], device: Any, annotate) -> None:
        from torchsnapshot_tpu_torch.storage import memory

        self.memory = memory
        self.state = state
        self.traffic = traffic
        self.device = device
        self.annotate = annotate
        self.snapshot = None
        self.budget = int(traffic["memory_budget_bytes"])
        self.dtypes = [getattr(torch, d) for d in traffic["template_dtypes"]]
        self.leaves = [state.specs[i] for i in state.read_leaves]
        sizes = [s.dtype.itemsize * math.prod(s.shape) for s in self.leaves]
        self.largest = {i for i, n in enumerate(sizes) if n == max(sizes)}
        self.kept: List[tuple] = []
        self.kept_bytes = 0
        self.first_largest: set = set()
        self.lock = threading.Lock()

    def _read(self, leaf: int, dtype: torch.dtype, keep: bool, ops: List[Op]) -> None:
        spec = self.leaves[leaf]
        template = torch.empty(spec.shape, dtype=dtype, device=self.device)
        template.fill_(float(self.traffic["marker"]))
        synchronize(self.device)
        ok = True
        with self.annotate("pb/read_object"):
            t0 = time.perf_counter()
            try:
                self.snapshot.read_object(
                    spec.path, obj_out=template, memory_budget_bytes=self.budget
                )
                synchronize(self.device)
            except Exception:  # noqa: BLE001 — counted as failed, reported
                traceback.print_exc(file=sys.stderr)
                ok = False
            t1 = time.perf_counter()
        # the bytes the read fetched from the snapshot
        ops.append(Op(t0, t1, t1, template.numel() * spec.dtype.itemsize, ok))
        nbytes = template.numel() * template.element_size()
        with self.lock:
            if leaf in self.largest and (leaf, dtype) not in self.first_largest:
                self.first_largest.add((leaf, dtype))
                keep = True
            keep = keep and self.kept_bytes + nbytes <= int(self.traffic["kept_bytes_max"])
            if keep:
                self.kept_bytes += nbytes
        if keep:
            with self.annotate("pb/keep_sample"):
                self.kept.append((template.clone() if ok else None, spec))

    def setup(self) -> None:
        import torchsnapshot_tpu_torch as tts

        self.snapshot = tts.Snapshot.take(f"memory://{NAMESPACE}", self.state.app_state)
        # every leaf in every template dtype once: each shape the window uses
        warm: List[Op] = []
        for leaf in range(len(self.leaves)):
            for dtype in self.dtypes:
                self._read(leaf, dtype, False, warm)
        if not all(o.ok for o in warm):
            raise RuntimeError("a warm-up read failed")
        self.kept, self.kept_bytes, self.first_largest = [], 0, set()

    def _reader(self, r: int, deadline: float, ops: List[Op], errors: List[BaseException]) -> None:
        rng = random.Random(leaf_seed(self.state.seed, -1, r))
        sampled = set(rng.sample(range(int(self.traffic["sample_span"])), int(self.traffic["samples_per_reader"])))
        # every (leaf, dtype) once a deck, each deck in an order drawn
        # from the seed: each seed sends the same mix, in another order
        deck = [(leaf, dtype) for leaf in range(len(self.leaves)) for dtype in self.dtypes]
        try:
            n = 0
            while time.perf_counter() < deadline:
                if n % len(deck) == 0:
                    rng.shuffle(deck)
                leaf, dtype = deck[n % len(deck)]
                self._read(leaf, dtype, n in sampled, ops)
                n += 1
        except BaseException as e:  # noqa: BLE001 — re-raised by run()
            errors.append(e)

    def run(self, seconds: float) -> Window:
        window = Window(time.perf_counter())
        deadline = window.t_start + seconds
        per_reader: List[List[Op]] = [[] for _ in range(int(self.traffic["readers"]))]
        errors: List[BaseException] = []
        threads = [
            threading.Thread(target=self._reader, args=(r, deadline, ops, errors), name=f"portbench-reader-{r}")
            for r, ops in enumerate(per_reader)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        window.ops = sorted((o for ops in per_reader for o in ops), key=lambda o: o.t_start)
        window.t_end = max(o.t_end for o in window.ops)
        return window

    def verify(self) -> Dict[str, Dict[str, float]]:
        return check_tensors(self.kept, self.state.seed, 0, self.device)

    def close(self) -> None:
        self.kept = []
        self.memory.reset_namespace(NAMESPACE)
