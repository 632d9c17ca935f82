"""Live-weight publication: delta subscribers that hot-swap a serving
fleet's weights without a cold restart.

Counterpart of ``torchsnapshot_tpu/publish``, in its on-disk format (a
root written by either package is followed by the other's subscribers).
On the training side a ``Publisher`` turns each durable commit (a
continuous-loop promotion, a committed snapshot, or the live state
itself) into a small self-verifying record of content-keyed chunk refs,
committed marker-last and announced over the coordination KV.  On the
serving side a ``Subscriber`` watches the announce key with a durable
poll behind it, plans the chunk delta against the step it holds, fetches
only the changed chunks (verified) and applies them behind a generation
counter: a request under ``LiveWeights.pinned()`` never sees a torn mix
of steps.  Leaves land where the live leaves are, on the card for a
serving model.  Knobs: PUBLISH_POLL_S, PUBLISH_ANNOUNCE, PUBLISH_RETAIN.
"""

from .announce import ns_for_root
from .apply import LiveWeights, TemplateMismatchError
from .delta import DeltaPlan, FetchItem, leaf_window, plan_delta
from .publisher import Publisher
from .record import PublishStore, build_record, make_ref, root_rollup
from .subscriber import FollowHandle, Subscriber

__all__ = [
    "DeltaPlan",
    "FetchItem",
    "FollowHandle",
    "LiveWeights",
    "PublishStore",
    "Publisher",
    "Subscriber",
    "TemplateMismatchError",
    "build_record",
    "leaf_window",
    "make_ref",
    "ns_for_root",
    "plan_delta",
    "root_rollup",
]
