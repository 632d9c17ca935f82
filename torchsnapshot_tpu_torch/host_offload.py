"""The unblock point of ``async_take``: make every pending write request
independent of the training state before control returns.

Counterpart of ``torchsnapshot_tpu/host_offload.py``'s
``eager_offload_write_reqs``.  The JAX package's async safety rests on
immutable ``jax.Array``s: it dispatches one batched device→pinned-host
transfer and returns without waiting, and an array skipped by its
pinned budget may stage lazily from the device array.  torch tensors are
changed in place by the next ``optimizer.step()`` — parameters, AdamW's
``exp_avg``/``exp_avg_sq`` on the device and its ``step`` counter on the
host — so here every source is copied before ``async_take`` returns:

- **CUDA tensors** get a copy ON THE DEVICE, enqueued on the caller's
  current stream: a slab of small tensors is packed by K1 (the slab is
  the copy), a tensor outside a slab is cloned.  The copies run after
  the work the caller queued before ``async_take`` (which produced the
  state) and before any work it queues on that stream afterwards (the
  next step, which writes the state in place), so the host never waits
  for them: the unblock point is the copies' enqueue.  Staging later
  copies each to pinned host memory on a side stream that waits on an
  event recorded after the copy, so it never waits for the next step.
  The caller must run its next step on the same stream (or on one that
  waits on it), as a training loop does.  A device copy is freed once
  staged.  HBM, not pinned host memory, holds the copies: for the
  repo's 2-layer full-width state (4.0 GB) on an H100 80GB HBM3,
  enqueueing all of it as device copies takes 15–18 ms of host time,
  where allocating that much pinned memory alone takes 0.58–0.85 s
  (``chip_smoke.py``).
- **Budget and memory pool.** The device copies live beside the
  caller's next step, so they take only memory that step does not need,
  and they are allocated in a ``torch.cuda.MemPool`` of their own, so
  they never split the blocks the step's allocations reuse from the
  caching allocator's cache.  The budget is what the allocator can hold
  (the device's free memory plus its reserved segments), less its
  high-water mark of reserved memory (``max_memory_reserved``: the
  step's footprint, fragmentation and state included, once a step has
  run; a loop that resets the peak each step gives exactly its step's),
  less the device copies of earlier takes not staged yet, less 1/16 of
  the card.  Largest first, copies that fit go on the device.  Unlike
  the JAX package's lazy staging past its pinned budget, a tensor past
  this budget is NOT safe to stage later: it is copied to pinned host
  memory before this returns (blocking).  A take's pool is dropped once
  its last copy is staged; the allocator returns its segments to the
  device at its next ``empty_cache`` or out-of-memory retry.
- **Host tensors and numpy arrays** (``defensive_copy`` stagers) are
  copied on the host now.  Objects were serialized and primitives
  inlined at planning, so they are independent already.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional

import torch

from . import obs
from .batcher import BatchedBufferStager
from .io_types import WriteReq
from .preparers.array import CudaTensorBufferStager, HostArrayBufferStager

# the last eager_offload_write_reqs breakdown: which copies engaged
LAST_OFFLOAD_STATS: Dict[str, int] = {}

# the share of the card held back from device copies, for the step's
# variation around its measured peak (5 GB of an 80 GB card)
HEADROOM_FRACTION = 1 / 16

# bytes of device copies that async takes made and have not staged yet
_LIVE_COPY_BYTES: Dict[torch.device, int] = {}
_LIVE_LOCK = threading.Lock()


def _device_of(stager: Any) -> Optional[torch.device]:
    if isinstance(stager, CudaTensorBufferStager) and stager.tensor is not None:
        return stager.tensor.device
    if isinstance(stager, BatchedBufferStager) and stager.on_device and stager.stagers:
        return stager.stagers[0][0].tensor.device
    return None


def copy_budget_bytes(capacity: int, peak: int, live_copies: int, total: int) -> int:
    """Device-copy bytes that fit beside the next step: ``capacity`` (what
    the allocator can hold) less the step's reserved ``peak``, the
    ``live_copies`` of earlier takes and ``HEADROOM_FRACTION`` of the
    card's ``total``."""
    return max(0, capacity - peak - live_copies - int(total * HEADROOM_FRACTION))


def device_copy_budget_bytes(device: torch.device) -> int:
    free, total = torch.cuda.mem_get_info(device)
    with _LIVE_LOCK:
        live = _LIVE_COPY_BYTES.get(device, 0)
    return copy_budget_bytes(
        free + torch.cuda.memory_reserved(device),
        torch.cuda.max_memory_reserved(device), live, total,
    )


def _track_live_copy(stager: Any, device: torch.device, nbytes: int, pool: Any) -> None:
    """Count the device copy ``stager`` now holds until it is freed (its
    stager drops it once staged), and keep its ``pool`` alive as long."""
    copy = stager.packed.tensor if isinstance(stager, BatchedBufferStager) else stager.tensor
    with _LIVE_LOCK:
        _LIVE_COPY_BYTES[device] = _LIVE_COPY_BYTES.get(device, 0) + nbytes
    weakref.finalize(copy, _release_live_copy, device, nbytes, pool)


def _release_live_copy(device: torch.device, nbytes: int, pool: Any) -> None:
    with _LIVE_LOCK:
        _LIVE_COPY_BYTES[device] -= nbytes


def eager_offload_write_reqs(write_reqs: List[WriteReq]) -> int:
    """Copy every source of ``write_reqs`` that the caller may mutate
    after ``async_take`` returns (see the module docstring).  Returns the
    bytes copied."""
    with obs.span("offload/eager", reqs=len(write_reqs)) as sp:
        stats = {"device_copy_bytes": 0, "blocking_host_bytes": 0, "host_copy_bytes": 0}
        budgets: Dict[torch.device, int] = {}
        pools: Dict[torch.device, Any] = {}
        # largest first: the budget goes to the copies that would block
        # the caller longest
        for wr in sorted(
            write_reqs, key=lambda r: r.buffer_stager.get_staging_cost_bytes(), reverse=True
        ):
            st = wr.buffer_stager
            device = _device_of(st)
            if device is None:
                if isinstance(st, (HostArrayBufferStager, BatchedBufferStager)):
                    stats["host_copy_bytes"] += st.offload(on_device=False)
                continue
            if device not in budgets:
                budgets[device] = device_copy_budget_bytes(device)
            cost = st.get_staging_cost_bytes()
            if cost > budgets[device]:
                stats["blocking_host_bytes"] += st.offload(on_device=False)
                continue
            if device not in pools:
                with torch.cuda.device(device):
                    pools[device] = torch.cuda.MemPool()
            with torch.cuda.use_mem_pool(pools[device], device):
                stats["device_copy_bytes"] += st.offload(on_device=True)
            budgets[device] -= cost
            _track_live_copy(st, device, cost, pools[device])
        moved = sum(stats.values())
        if sp is not None:
            sp.attrs["bytes"] = moved
    obs.counter(obs.BYTES_OFFLOADED).inc(moved)
    LAST_OFFLOAD_STATS.clear()
    LAST_OFFLOAD_STATS.update(stats)
    return moved
