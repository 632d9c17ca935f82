"""Every copy between pinned host memory and the card, in one place.

The take stages device bytes into pinned memory (``to_host``); restores
and budgeted reads offer the storage pinned read buffers
(``PinnedLease``) and land them on the card (``to_device``), after
``card_miss`` decided at plan time that the destination can take the
card path at all.  The clocks and counters of these copies are taken
here and nowhere else:

- ``stage.pin_alloc_s`` / ``stage/pin_alloc`` and ``stage.d2h_wait_s`` /
  ``stage/d2h_wait``: a take's pinned allocation and its wait on the
  device-to-host copy;
- ``read.pin_alloc_s`` / ``read/pin_alloc``: a pinned read buffer's
  allocation, and the gauge ``read.pinned_in_use_bytes`` of the read
  buffers handed out (its ``max`` is the pinned high-water mark);
- ``consume.h2d_s`` / ``consume/h2d`` and ``read.pinned_bytes``: the
  host-to-device copy, and the bytes it took from a pinned read buffer.

Streams stay each caller's: a take copies on a side stream drawn from
torch's pool that waits on the producer; a landing copies on the stream
it is given.  Every copy here is waited for on an event recorded after
it (and after the kernel that follows it, when there is one) before its
host buffer may be reused.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import obs

# element codes of csrc/element_cast.cuh (0 = raw bytes, identity), the
# casts K2 and K6 make on the card
ELEMENT_CODES = {
    torch.float16: 1, torch.bfloat16: 2, torch.float32: 3, torch.float64: 4,
    torch.int8: 5, torch.int16: 6, torch.int32: 7, torch.int64: 8,
    torch.uint8: 9, torch.uint16: 10, torch.uint32: 11, torch.uint64: 12,
}
_FLOAT_CODES = (1, 2, 3, 4)


def cast_supported(src: torch.dtype, dst: torch.dtype) -> bool:
    """Whether K2 and K6 take the stored → template dtype pair: identity
    for every dtype, float↔float among f16/bf16/f32/f64, int↔int."""
    if src == dst:
        return True
    a, b = ELEMENT_CODES.get(src), ELEMENT_CODES.get(dst)
    if a is None or b is None:
        return False
    return (a in _FLOAT_CODES) == (b in _FLOAT_CODES)


def card_miss(dst: torch.Tensor, stored: torch.dtype, numel: int) -> Optional[str]:
    """Why the CUDA tensor ``dst`` cannot take a payload of ``numel``
    elements of ``stored`` on the card path (a pinned copy into place,
    cast by K2 or K6): ``"layout"`` when it is not a contiguous tensor of
    that many elements, ``"cast"`` when neither kernel makes the cast;
    None when it can.  Decided before any read or launch."""
    if not dst.is_contiguous() or dst.numel() != numel:
        return "layout"
    if not cast_supported(stored, dst.dtype):
        return "cast"
    return None


def side_stream(device: torch.device, after: Any = None) -> torch.cuda.Stream:
    """A side stream of ``device`` that waits on ``after`` (a stream or an
    event; None: the device's current stream).  ``torch.cuda.Stream``
    creates no CUDA stream: it draws one from torch's per-device pool."""
    stream = torch.cuda.Stream(device=device)
    if after is None:
        after = torch.cuda.current_stream(device)
    if isinstance(after, torch.cuda.Event):
        stream.wait_event(after)
    else:
        stream.wait_stream(after)
    return stream


def to_host(device: torch.device, after: Any, produce: Callable[[], torch.Tensor]) -> np.ndarray:
    """The uint8 device bytes ``produce()`` returns (a tensor's own bytes,
    or K1's slab), in pinned host memory: ``produce`` runs on a
    ``side_stream`` that waits on ``after``, so it reads its inputs as the
    work before that point left them.  Blocks until the copy is done, so
    the inputs may be freed when this returns."""
    stream = side_stream(device, after)
    with torch.cuda.stream(stream):
        src = produce()
        with obs.clocked(obs.STAGE_PIN_ALLOC_S, "stage/pin_alloc"):
            host = torch.empty(src.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    with obs.clocked(obs.STAGE_D2H_WAIT_S, "stage/d2h_wait"):
        done.synchronize()
    return host.numpy()


class PinnedLease:
    """One read's pinned buffer, from torch's caching host allocator.

    ``offer`` allocates it when the read starts and returns the numpy view
    the storage may fill; ``claim`` returns its pinned tensor when the
    storage handed that very view back (else None: the bytes are in a
    buffer of the storage's own); ``release`` gives it back once its
    copies are done, and may be called any number of times (from a
    ``finally``).  Counted in ``read.pinned_in_use_bytes`` while held."""

    __slots__ = ("_view", "_pinned")

    def __init__(self) -> None:
        self._view: Optional[np.ndarray] = None
        self._pinned: Optional[torch.Tensor] = None

    def offer(self, nbytes: int) -> np.ndarray:
        self.release()
        with obs.clocked(obs.READ_PIN_ALLOC_S, "read/pin_alloc"):
            pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        obs.gauge(obs.READ_PINNED_IN_USE).add(nbytes)
        self._view, self._pinned = pinned.numpy(), pinned
        return self._view

    def claim(self, buf: Any) -> Optional[torch.Tensor]:
        if self._view is None or buf is not self._view:
            return None
        return self._pinned

    def release(self) -> None:
        pinned, self._view, self._pinned = self._pinned, None, None
        if pinned is not None:
            obs.gauge(obs.READ_PINNED_IN_USE).add(-pinned.numel())


def to_device(
    dst: torch.Tensor,
    src: torch.Tensor,
    stream: Any,
    then: Optional[Callable[[], Any]] = None,
    pinned: bool = False,
) -> None:
    """Copy the host tensor ``src`` into the CUDA tensor ``dst`` (cast to
    its dtype) on ``stream``, run ``then`` after it on the same stream (a
    kernel that consumes ``dst``), and wait for both on one event.
    ``pinned``: ``src`` is a claimed ``PinnedLease`` buffer, copied by one
    asynchronous DMA and counted in ``read.pinned_bytes``; any other
    source is copied synchronously."""
    with torch.no_grad(), torch.cuda.stream(stream):
        with obs.clocked(obs.CONSUME_H2D_S, "consume/h2d"):
            dst.copy_(src, non_blocking=pinned)
        if then is not None:
            then()
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    if pinned:
        obs.counter(obs.READ_PINNED_BYTES).inc(src.numel() * src.element_size())


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small host tensor (a kernel's descriptor table) on the card,
    copied from pinned memory on the current stream without blocking the
    host: the caching host allocator does not reuse the pinned block
    before the copy has run."""
    return host.pin_memory().to(device, non_blocking=True)
