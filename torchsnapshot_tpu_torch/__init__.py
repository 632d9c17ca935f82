"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

Takes, restores and reads snapshots of PyTorch state (``nn.Module``,
``Optimizer``, nested tensors, RNG streams) in the same on-disk format
as the JAX package, so a snapshot written by either package restores in
the other.  On the GPU, small tensors coalesce into slabs that are
packed and unpacked on the device by hand-written CUDA kernels
(``csrc/``).  Many ranks of one host take and restore together over a
``torch.distributed`` store (``TorchStoreCoordinator``) or a shared
directory (``FileCoordinator``), and ``DTensor`` state is stored as
sharded entries that restore into any layout at any world size.  It imports ``torch`` and ``numpy``,
never ``jax`` and nothing of ``torchsnapshot_tpu``.

Entry points place new tensors on ``cuda`` unless the caller asks for
the CPU.
"""

from . import knobs, obs  # noqa: F401
from .coordination import (  # noqa: F401
    Coordinator,
    FileCoordinator,
    LocalCoordinator,
    TorchStoreCoordinator,
    get_default_coordinator,
)
from .event import Event  # noqa: F401
from .event_handlers import register_event_handler, unregister_event_handler  # noqa: F401
from .snapshot import DegradedSnapshotError, EncodedPayloadError, Snapshot  # noqa: F401
from .resilience.abort import SnapshotAbortedError  # noqa: F401
from .stateful import PyTreeState, Replicated, RNGState, StateDict, Stateful  # noqa: F401

__all__ = [
    "Snapshot",
    "Coordinator",
    "FileCoordinator",
    "LocalCoordinator",
    "TorchStoreCoordinator",
    "get_default_coordinator",
    "SnapshotAbortedError",
    "DegradedSnapshotError",
    "EncodedPayloadError",
    "Replicated",
    "PyTreeState",
    "RNGState",
    "StateDict",
    "Stateful",
    "Event",
    "register_event_handler",
    "unregister_event_handler",
    "knobs",
    "obs",
]
