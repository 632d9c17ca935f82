"""Recovery: restore a rank's state from the freshest reachable continuous
store, in seconds.

Counterpart of ``torchsnapshot_tpu/continuous/recover.py``.  Every
source's HEAD is probed first (one small verified read each), then full
restores are tried newest step first, the ladder position (local, peers,
durable) breaking ties only: a target may lag (a failed replication
leaves a store at its older complete step), so "local before peer" as a
blind order could lose more than the loop's one-step bound.  Any failure
of a source (an unreachable root, a corrupt chunk, whose content key
fails closed) moves on to the next one; with no usable source the caller
gets None, a cold start.  A template that the store does not cover
(``TemplateMismatchError``) is raised instead: it would fail every
source alike.

Tensors land on ``device`` (the card unless the caller names another),
except where the template holds that leaf as a tensor on another device
(an optimizer's CPU ``step``), which keeps its place.  The seconds of
each successful recovery go to the ``continuous.restore_s`` histogram,
the source to ``continuous.restores_from_{local,peer,durable}``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import obs
from ..flatten import flatten, inflate
from .store import ContinuousStore

logger = logging.getLogger(__name__)


class TemplateMismatchError(KeyError):
    """The store's leaves do not cover the template (strict mode).  Never
    a reason to try the next source: every source mismatches alike."""


def _apply_leaves(app_state: Dict[str, Any], leaves: Dict[str, Any], strict: bool) -> None:
    """Load recovered leaves into the app-state template: the structure
    from the template, the values from the store."""
    state_tree = {
        k: (v.state_dict() if hasattr(v, "state_dict") else v) for k, v in app_state.items()
    }
    manifest, flattened = flatten(state_tree)
    missing = [p for p in flattened if p not in leaves]
    extra = [p for p in leaves if p not in flattened]
    if missing and strict:
        raise TemplateMismatchError(
            f"continuous store is missing {len(missing)} leaves the template expects "
            f"(e.g. {missing[:3]}); pass strict=False to keep template values for them"
        )
    if extra:
        logger.warning(
            "continuous store carries %d leaves the template does not (e.g. %s); ignoring them",
            len(extra), extra[:3],
        )
    merged = {}
    for p, tmpl in flattened.items():
        value = leaves.get(p, tmpl)
        if (
            isinstance(value, torch.Tensor)
            and isinstance(tmpl, torch.Tensor)
            and value.device != tmpl.device
        ):
            value = value.to(tmpl.device)
        merged[p] = value
    inflated = inflate(manifest, merged)
    for k, stateful in app_state.items():
        if hasattr(stateful, "load_state_dict"):
            stateful.load_state_dict(inflated[k])
        else:
            app_state[k] = inflated[k]


def recover_state(
    app_state: Dict[str, Any],
    local: Optional[str] = None,
    peers: Sequence[str] = (),
    durable: Optional[str] = None,
    strict: bool = True,
    device: Any = "cuda",
) -> Optional[Dict[str, Any]]:
    """Restore ``app_state`` from the freshest reachable continuous store
    (see the module docstring).  ``local``, ``peers`` and ``durable`` are
    STORE roots (rank-namespaced already; ``restore_latest`` builds
    them).  Returns ``{"step", "source", "root", "seconds"}``, or None
    when no source holds a complete step."""
    sources: List[Tuple[str, str]] = []
    if local:
        sources.append((local, "local"))
    sources.extend((p, "peer") for p in peers)
    if durable:
        sources.append((durable, "durable"))
    m_by_source = {
        "local": obs.CONTINUOUS_RESTORES_FROM_LOCAL,
        "peer": obs.CONTINUOUS_RESTORES_FROM_PEER,
        "durable": obs.CONTINUOUS_RESTORES_FROM_DURABLE,
    }
    with obs.span("continuous/recover", sources=len(sources)):
        # phase 1: every source's HEAD, so the restore goes newest first
        candidates: List[Tuple[int, int, str, str, Dict[str, Any]]] = []
        for idx, (root, kind) in enumerate(sources):
            store = ContinuousStore(root)
            try:
                head = store.read_head()
            except Exception as e:  # noqa: BLE001 — an unusable source
                logger.warning(
                    "continuous recovery: HEAD probe of %s store %r failed (%r); skipping it",
                    kind, root, e,
                )
                continue
            finally:
                store.sync_close()
            if head is None:
                logger.info("continuous recovery: %s store %r has no complete step", kind, root)
                continue
            candidates.append((int(head["step"]), idx, root, kind, head))
        candidates.sort(key=lambda c: (-c[0], c[1]))
        # phase 2: the newest candidate that reads whole
        for _step_hint, _idx, root, kind, head in candidates:
            t0 = time.monotonic()
            store = ContinuousStore(root)
            try:
                step, leaves = store.read_state(head, device=device)
                _apply_leaves(app_state, leaves, strict=strict)
            except TemplateMismatchError:
                raise
            except Exception as e:  # noqa: BLE001 — the ladder's next candidate
                logger.warning(
                    "continuous recovery from %s store %r failed (%r); trying the next "
                    "candidate", kind, root, e,
                )
                continue
            finally:
                store.sync_close()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()  # the seconds include the copies to the card
            seconds = time.monotonic() - t0
            obs.counter(m_by_source[kind]).inc()
            obs.histogram(obs.CONTINUOUS_RESTORE_S).observe(seconds)
            logger.info(
                "continuous recovery: step %d from %s store %r in %.3f s", step, kind, root, seconds
            )
            return {"step": step, "source": kind, "root": root, "seconds": seconds}
    return None
