"""A benchmark state: the program's stateful objects, the leaves the
harness fills from the seed, and the ledger of which version they hold."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .reference import fill
from .reference.check import LeafSpec

PROGRESS_PATH = "0/progress/step"


class BenchState:
    """``app_state`` goes to the program; ``tensors[i]`` is the storage of
    the leaf ``specs[i]`` (a DTensor's local tensor), filled in place.
    ``progress`` is a ``StateDict`` whose ``step`` follows the version."""

    def __init__(
        self, app_state: Dict[str, Any], progress: Any, specs: Sequence[LeafSpec],
        tensors: Sequence[torch.Tensor], read_leaves: Sequence[int], seed: int,
        close: Optional[Callable[[], None]] = None,
    ) -> None:
        self.app_state = app_state
        self.progress = progress
        self.specs = list(specs)
        self.tensors = list(tensors)
        self.read_leaves = list(read_leaves)
        self.seed = seed
        self.version = -1
        self._close = close
        # bytes counted by the benchmark: every leaf it handed over
        self.nbytes = sum(t.numel() * t.element_size() for t in self.tensors)

    def refill(self, version: int) -> None:
        """Every leaf drawn anew for ``version``, on the current stream."""
        for t, s in zip(self.tensors, self.specs):
            fill.fill_(t, self.seed, version, s.index, s.kind)
        self.progress["step"] = version
        self.version = version

    def zero(self) -> None:
        with torch.no_grad():
            for t in self.tensors:
                t.zero_()
        self.progress["step"] = -1

    def primitives(self, version: int) -> Dict[str, int]:
        return {PROGRESS_PATH: version}

    def close(self) -> None:
        if self._close is not None:
            self._close()
            self._close = None


def leaf_specs(named: Sequence[tuple]) -> List[LeafSpec]:
    """``(path, tensor, kind)`` → specs numbered in order."""
    return [
        LeafSpec(path, tuple(t.shape), t.dtype, i, kind) for i, (path, t, kind) in enumerate(named)
    ]
