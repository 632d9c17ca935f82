"""Live-weight applier: staged delta apply behind a generation counter
and an atomic swap barrier.

Counterpart of ``torchsnapshot_tpu/publish/apply.py``.  ``LiveWeights``
wraps a serving process's ``app_state``; an apply has two halves:

1. **Stage** (no lock, nothing mutated): for every leaf the plan
   touched, the leaf's new bytes are the live leaf's bytes as the basis
   with the fetched chunks laid over them at their offsets, decoded into
   a fresh value.  A failure here leaves the live state bitwise as it
   was; the next poll stages again from the last complete generation.
2. **Swap** (under the generation lock): every staged leaf goes into the
   app state and the generation advances.  Requests bracketed by
   ``pinned()`` hold the same lock, so one sees the old generation or the
   new one for every leaf, never a mix.

A chunk the plan skipped is the same bytes in the held and the new
record (same key at the same offset), so the live leaf already holds it.

Differences from the reference, on purpose:
- a decoded array leaf lands on the LIVE leaf's device and dtype: the
  card for a serving model (a live numpy array stays numpy; a leaf with
  no tensor to follow lands on ``device``, the card unless the caller
  names another).  An ``nn.Module``'s ``load_state_dict`` copies into
  its existing parameters, so code holding those parameters sees the
  swap; a ``StateDict`` value is replaced, as in the reference;
- staging runs on the caller's thread and current stream, off the lock;
  the swap synchronises every card it writes to before its copies (work
  a request queued on any stream is done before its inputs change) and
  again after them (the copies are done before the lock opens), so a
  request under ``pinned()`` sees one generation on an asynchronous
  device too;
- the staging basis of a card-resident leaf is a device-to-host copy of
  the whole leaf (``encode_leaf``); ``basis_copies``, ``basis_bytes`` and
  ``basis_s`` count and time those copies.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..continuous.store import decode_leaf, encode_leaf
from ..flatten import flatten, inflate
from ..resilience.failpoints import failpoint
from ..serialization import string_to_dtype
from .delta import DeltaPlan


class TemplateMismatchError(RuntimeError):
    """The publication record and the live app state disagree on the leaf
    set (strict mode), or a live leaf does not match its held record."""


class LiveWeights:
    """One serving process's swappable view of ``app_state``.  All
    mutation goes through ``apply``; requests bracket their work with
    ``pinned()``."""

    def __init__(self, app_state: Dict[str, Any], device: Any = "cuda") -> None:
        self._app_state = app_state
        self._device = device
        self._lock = threading.RLock()
        self._generation = 0
        self._step: Optional[int] = None
        self.basis_copies = 0
        self.basis_bytes = 0
        self.basis_s = 0.0

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def step(self) -> Optional[int]:
        with self._lock:
            return self._step

    @contextlib.contextmanager
    def pinned(self) -> Iterator[Tuple[Optional[int], int]]:
        """Hold the swap barrier for a request: yields ``(step,
        generation)``; no apply commits while it is held."""
        with self._lock:
            yield (self._step, self._generation)

    def current_leaves(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(manifest, flattened)`` of the live state: the apply basis
        and the subscriber's template."""
        with self._lock:
            state_tree = {
                k: (v.state_dict() if hasattr(v, "state_dict") else v)
                for k, v in self._app_state.items()
            }
        return flatten(state_tree)

    def apply(
        self,
        record: Dict[str, Any],
        plan: DeltaPlan,
        fetched: Dict[Tuple[str, int], Any],
        strict: bool = True,
    ) -> int:
        """Stage and swap one published step (see the module docstring);
        returns the new generation.  ``fetched`` maps ``(leaf, leaf_off)``
        to the verified bytes of every fetch in ``plan``."""
        with obs.span("publish/apply", step=record["step"], fetched=len(fetched)):
            staged = self._stage(record, plan, fetched, strict)
            # a subscriber dying here (staged, not swapped) must leave the
            # live state at its last complete generation
            failpoint("publish.subscriber.apply", step=record["step"])
            with self._lock:
                self._load(staged)
                self._generation += 1
                self._step = int(record["step"])
                obs.gauge(obs.PUBLISH_GENERATION).set(self._generation)
                return self._generation

    def _stage(
        self,
        record: Dict[str, Any],
        plan: DeltaPlan,
        fetched: Dict[Tuple[str, int], Any],
        strict: bool,
    ) -> Dict[str, Any]:
        _manifest, flattened = self.current_leaves()
        rec_leaves: Dict[str, Any] = record["leaves"]
        missing = [p for p in flattened if p not in rec_leaves]
        extra = [p for p in rec_leaves if p not in flattened]
        if (missing or extra) and strict:
            raise TemplateMismatchError(
                f"publication record and live template disagree: record lacks "
                f"{len(missing)} template leaves (e.g. {missing[:3]}), template lacks "
                f"{len(extra)} record leaves (e.g. {extra[:3]}); pass strict=False to "
                f"apply the intersection"
            )
        if extra:
            obs.counter(obs.PUBLISH_LEAVES_SKIPPED).inc(len(extra))
        touched = {item.leaf for item in plan.fetches}
        touched.update(p for p in plan.full_leaves if p in flattened)
        by_leaf: Dict[str, List] = {}
        for item in plan.fetches:
            by_leaf.setdefault(item.leaf, []).append(item)
        staged: Dict[str, Any] = {}
        for path in sorted(touched):
            if path not in flattened:
                continue  # counted above (non-strict extra)
            leaf_doc = rec_leaves[path]
            win_lo, win_hi = plan.windows.get(path, (0, int(leaf_doc["size"])))
            buf = bytearray(win_hi - win_lo)
            if path not in plan.full_leaves:
                # the delta basis: the live bytes hold every skipped chunk
                t0 = time.monotonic()
                _rec, view = encode_leaf(flattened[path])
                if isinstance(flattened[path], torch.Tensor) and flattened[path].device.type != "cpu":
                    self.basis_copies += 1
                    self.basis_bytes += view.nbytes
                    self.basis_s += time.monotonic() - t0
                if view.nbytes != len(buf):
                    raise TemplateMismatchError(
                        f"live leaf {path!r} holds {view.nbytes} bytes but the plan window "
                        f"is {len(buf)} — the held generation does not match its record"
                    )
                buf[:] = view
            for item in by_leaf.get(path, ()):
                data = fetched[(item.leaf, item.leaf_off)]
                # window-relative placement, edges sliced (chunks are
                # fetched whole so their keys verify)
                dst_lo = max(item.leaf_off, win_lo) - win_lo
                src_lo = max(win_lo - item.leaf_off, 0)
                src_hi = min(item.leaf_off + item.nbytes, win_hi) - item.leaf_off
                buf[dst_lo : dst_lo + (src_hi - src_lo)] = memoryview(data)[src_lo:src_hi]
            staged[path] = self._decode_window(leaf_doc, buf, flattened[path])
        return staged

    def _decode_window(self, leaf_doc: Dict[str, Any], buf: bytearray, live: Any) -> Any:
        """A (possibly window-narrowed) leaf's bytes → a fresh value shaped
        like the live leaf, where the live leaf is."""
        if leaf_doc.get("kind") == "prim":
            # the value is inlined in the record: no bytes at all
            from ..manifest import PrimitiveEntry

            return PrimitiveEntry(
                type=str(leaf_doc["ptype"]), readable=str(leaf_doc["v"]), replicated=True
            ).get_value()
        if leaf_doc.get("kind") != "array":
            return decode_leaf(leaf_doc, bytes(buf))
        dtype = string_to_dtype(str(leaf_doc["dtype"]))
        rest = [int(d) for d in leaf_doc["shape"][1:]]
        u8 = torch.frombuffer(buf, dtype=torch.uint8) if len(buf) else torch.empty(0, dtype=torch.uint8)
        t = u8.view(dtype).reshape([-1] + rest)
        if not leaf_doc["shape"]:
            t = t.reshape(())
        if isinstance(live, torch.Tensor):
            return t.to(device=live.device, dtype=live.dtype)
        if isinstance(live, (np.ndarray, np.generic)):
            return np.asarray(t.numpy(), dtype=live.dtype)
        return t.to(self._device)

    def _load(self, staged: Dict[str, Any]) -> None:
        if not staged:
            return
        manifest, flattened = self.current_leaves()
        merged = {p: staged.get(p, flattened[p]) for p in flattened}
        inflated = inflate(manifest, merged)
        cards = {
            v.device
            for v in list(staged.values()) + list(flattened.values())
            if isinstance(v, torch.Tensor) and v.device.type == "cuda"
        }
        for d in cards:
            torch.cuda.synchronize(d)
        for k, stateful in self._app_state.items():
            if hasattr(stateful, "load_state_dict"):
                stateful.load_state_dict(inflated[k])
            else:
                self._app_state[k] = inflated[k]
        for d in cards:
            torch.cuda.synchronize(d)
