"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

Takes, restores and reads snapshots of PyTorch state (``nn.Module``,
``Optimizer``, nested tensors, RNG streams) in the same on-disk format
as the JAX package, so a snapshot written by either package restores in
the other.  On the GPU, small tensors coalesce into slabs that are
packed and unpacked on the device by hand-written CUDA kernels
(``csrc/``).  Many ranks of one host take and restore together over a
``torch.distributed`` store (``TorchStoreCoordinator``) or a shared
directory (``FileCoordinator``), and ``DTensor`` state is stored as
sharded entries that restore into any layout at any world size.
``SnapshotManager`` keeps step-numbered snapshots under one root with
resume, incremental saves and bounded retention, also over a fast local
tier in front of a durable one (``TierConfig``, write-back promotion);
``ContinuousCheckpointer`` mirrors the changed chunks of the state to a
peer host after every step, and ``recover_state`` brings a restarted
job back from the freshest mirror; ``Publisher`` and ``Subscriber``
push a training job's weights to serving processes, which hot-swap the
changed chunks; ``verify_snapshot``
audits a snapshot, and ``python -m torchsnapshot_tpu_torch`` does both
from a shell.  It imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``torchsnapshot_tpu``.

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
from .snapshot import DegradedSnapshotError, PendingSnapshot, Snapshot  # noqa: F401
from .manager import SnapshotManager, delete_snapshot  # noqa: F401
from .tier import TierConfig, drain_promotions  # noqa: F401
from .verify import VerifyResult, verify_snapshot  # noqa: F401
from .resilience.abort import SnapshotAbortedError  # noqa: F401
from .continuous import ContinuousCheckpointer, recover_state  # noqa: F401
from .publish import LiveWeights, Publisher, Subscriber  # noqa: F401
from .stateful import PyTreeState, Replicated, RNGState, StateDict, Stateful  # noqa: F401

__all__ = [
    "Snapshot",
    "PendingSnapshot",
    "SnapshotManager",
    "delete_snapshot",
    "TierConfig",
    "drain_promotions",
    "ContinuousCheckpointer",
    "recover_state",
    "Publisher",
    "Subscriber",
    "LiveWeights",
    "verify_snapshot",
    "VerifyResult",
    "Coordinator",
    "FileCoordinator",
    "LocalCoordinator",
    "TorchStoreCoordinator",
    "get_default_coordinator",
    "SnapshotAbortedError",
    "DegradedSnapshotError",
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
