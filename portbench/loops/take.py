"""A closed loop of checkpoints into ``memory://``.

Each iteration calls ``Snapshot.async_take``; as soon as it returns,
draws every leaf anew from the seed and the next version on the same
stream (the stand-in for the next optimizer step, so a take that stages
from the live tensors after returning stores the wrong version); waits
for the commit; then deletes the previous snapshot, so at most one
committed and one in-flight snapshot are held.
"""

from __future__ import annotations

import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from ..reference.check import check_snapshot
from ..stats import Op, Window


class Loop:
    def __init__(self, state, traffic: Dict[str, Any], device: Any, annotate) -> None:
        from torchsnapshot_tpu_torch.storage import memory

        self.memory = memory
        self.state = state
        self.traffic = traffic
        self.device = device
        self.annotate = annotate
        self.namespaces = ("portbench-take-a", "portbench-take-b")
        self.count = 0
        # (namespace, version) of the last committed take
        self.committed: Optional[Tuple[str, int]] = None

    def _take(self) -> Op:
        import torchsnapshot_tpu_torch as tts

        ns = self.namespaces[self.count % 2]
        self.count += 1
        version = self.state.version
        ok = True
        with self.annotate("pb/async_take"):
            t0 = time.perf_counter()
            try:
                pending = tts.Snapshot.async_take(f"memory://{ns}", self.state.app_state)
            except Exception:  # noqa: BLE001 — counted as failed, reported
                traceback.print_exc(file=sys.stderr)
                pending, ok = None, False
            t1 = time.perf_counter()
        with self.annotate("pb/next_step"):
            self.state.refill(version + 1)
        with self.annotate("pb/wait"):
            try:
                if pending is not None:
                    pending.wait()
            except Exception:  # noqa: BLE001 — counted as failed, reported
                traceback.print_exc(file=sys.stderr)
                ok = False
            t2 = time.perf_counter()
        if ok:
            if self.committed is not None:
                self.memory.reset_namespace(self.committed[0])
            self.committed = (ns, version)
        else:
            self.memory.reset_namespace(ns)
        return Op(t0, t1, t2, self.state.nbytes, ok)

    def setup(self) -> None:
        for _ in range(int(self.traffic["warmup_ops"])):
            if not self._take().ok:
                raise RuntimeError("a warm-up take failed")

    def run(self, seconds: float) -> Window:
        window = Window(time.perf_counter())
        while True:
            window.ops.append(self._take())
            window.t_end = window.ops[-1].t_end
            if window.t_end - window.t_start >= seconds:
                return window

    def verify(self) -> Dict[str, Dict[str, float]]:
        ns, version = self.committed if self.committed is not None else (self.namespaces[0], 0)
        objects = self.memory._NAMESPACES.get(ns, {})
        return check_snapshot(
            objects, self.state.specs, self.state.primitives(version), self.state.seed, version,
            self.device,
        )

    def close(self) -> None:
        for ns in self.namespaces:
            self.memory.reset_namespace(ns)
