"""Topology: the rank → host → slice model (``model.py``).

Counterpart of the model half of ``torchsnapshot_tpu/topology``; the
fan-out restore (``fanout.py``) is ROADMAP queue A item 5.
"""

from .model import (  # noqa: F401
    Topology,
    current_topology_info,
    detect_topology,
    replica_candidate_order,
)

__all__ = [
    "Topology",
    "detect_topology",
    "current_topology_info",
    "replica_candidate_order",
]
