"""Back-to-back restores from ``memory://``.

Set-up takes the state once; each restore of the window goes into the
same preallocated model and optimizer, which the benchmark zeroes on the
device before it, and ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import sys
import time
import traceback
from typing import Any, Dict

from ..reference.check import check_tensors
from ..stats import Op, Window
from . import synchronize

NAMESPACE = "portbench-restore"


class Loop:
    def __init__(self, state, traffic: Dict[str, Any], device: Any, annotate) -> None:
        from torchsnapshot_tpu_torch.storage import memory

        self.memory = memory
        self.state = state
        self.traffic = traffic
        self.device = device
        self.annotate = annotate
        self.snapshot = None

    def _restore(self) -> Op:
        with self.annotate("pb/zero"):
            self.state.zero()
        ok = True
        with self.annotate("pb/restore"):
            t0 = time.perf_counter()
            try:
                self.snapshot.restore(self.state.app_state)
                synchronize(self.device)
            except Exception:  # noqa: BLE001 — counted as failed, reported
                traceback.print_exc(file=sys.stderr)
                ok = False
            t1 = time.perf_counter()
        return Op(t0, t1, t1, self.state.nbytes, ok)

    def setup(self) -> None:
        import torchsnapshot_tpu_torch as tts

        self.snapshot = tts.Snapshot.take(f"memory://{NAMESPACE}", self.state.app_state)
        for _ in range(int(self.traffic["warmup_ops"])):
            if not self._restore().ok:
                raise RuntimeError("a warm-up restore failed")

    def run(self, seconds: float) -> Window:
        window = Window(time.perf_counter())
        while True:
            window.ops.append(self._restore())
            window.t_end = window.ops[-1].t_end
            if window.t_end - window.t_start >= seconds:
                return window

    def verify(self) -> Dict[str, Dict[str, float]]:
        checks = check_tensors(
            list(zip(self.state.tensors, self.state.specs)), self.state.seed, 0, self.device
        )
        # the progress counter, restored as a primitive
        step_ok = self.state.progress["step"] == 0
        checks["mismatched_elements"]["value"] += 0 if step_ok else 1
        return checks

    def close(self) -> None:
        self.memory.reset_namespace(NAMESPACE)
