"""Topology: the rank → host → slice model and the fan-out restore.

Counterpart of ``torchsnapshot_tpu/topology``:

- ``model.py``: the ``Topology`` descriptor and ``detect_topology``
  (an explicit spec, or per-process hints exchanged once per operation
  over the coordination KV);
- ``fanout.py``: read once per slice: a designated reader of each slice
  reads each replicated object from the durable tier and hands the bytes
  to its siblings over the payload transport (``transport/``), with
  re-election and staggered direct reads when a reader dies.

The write side is in ``partitioner.py`` and ``preparers/sharded.py``,
which spread replicated and sharded-replica writers over slices and
hosts by the same ``Topology``.
"""

from .fanout import (  # noqa: F401
    FanoutReadPlugin,
    fanout_enabled,
    fanout_world_uniform,
    fetch_published,
    ordered_shared_locations,
    publish_object,
    shared_read_locations,
)
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
    "FanoutReadPlugin",
    "fanout_enabled",
    "fanout_world_uniform",
    "shared_read_locations",
    "ordered_shared_locations",
    "publish_object",
    "fetch_published",
]
