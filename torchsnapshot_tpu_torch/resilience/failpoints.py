"""Deterministic, seeded fault injection: the ``failpoint`` registry.

Counterpart of ``torchsnapshot_tpu/resilience/failpoints.py``.
Instrumented sites call ``failpoint("site.name")``; when armed, a
matching spec raises its error there.  Disarmed, the call is one check
of a module global.

Spec grammar (the ``TORCHSNAPSHOT_TPU_TORCH_FAILPOINTS`` knob, or
``knobs.override_failpoints`` in tests)::

    site=error[:probability[:count]][,site=error...]

- **site**: a site name or an ``fnmatch`` glob over them
  (``storage.fs.*``);
- **error**: ``io``, ``enospc``, ``eintr``, ``eagain``, ``fnf``,
  ``conn``, ``timeout``, ``slowdown``, ``http500``, ``runtime``;
  ``delay<ms>`` sleeps at the site instead; ``hang`` parks the thread
  until ``release_hangs()``;
- **probability**: the chance to fire per evaluation, in (0, 1];
  default 1;
- **count**: fires before the spec disarms itself; default unlimited.

Every spec draws from its own ``random.Random``, seeded from
``FAILPOINT_SEED`` and the spec's text, so a schedule replays the same
whatever other sites do; fire counts are taken under a lock.

Unlike the JAX package's, a ``hang`` here waits at most
``HANG_DEADLINE_S`` seconds and then raises ``TimeoutError``: no wait
this package can cause is without a deadline.  A test or script that
arms one still calls ``release_hangs()`` in a ``finally``.

Sites of the port: ``storage.fs.{write,read}``, ``storage.fs.write.sync``,
``storage.fs.part.write``, ``storage.memory.{write,read}``,
``storage.memory.part.write``, ``storage.s3.{write,read,part.create,
part.write,part.complete}``, ``storage.gcs.{write,read,delete}``,
``storage.gcs.part.write``, ``scheduler.{stage,write,read}``,
``scheduler.stage.part``, ``scheduler.codec.encode``.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import fnmatch
import logging
import random
import re as _re
import threading
import time
import zlib
from typing import List, Optional

from .. import knobs, obs

logger = logging.getLogger(__name__)

# the longest a ``hang`` failpoint parks a thread before it raises
HANG_DEADLINE_S = 300.0

_LOCK = threading.Lock()
# None: disarmed (the one check in failpoint()); else the armed specs
_ARMED: Optional[List["_Armed"]] = None


class InjectedClientError(Exception):
    """An S3-client-shaped injected failure: ``response["Error"]["Code"]``
    and an HTTP status, so the plugins' classifiers run on it unchanged."""

    def __init__(self, code: str, status: int, site: str) -> None:
        super().__init__(f"injected {code} at {site}")
        self.response = {
            "Error": {"Code": code},
            "ResponseMetadata": {"HTTPStatusCode": status},
        }


def _oserror(code: int, site: str) -> OSError:
    # OSError(errno, ...) picks the subclass a real syscall would raise
    return OSError(code, f"injected {_errno.errorcode.get(code, code)}", site)


_ERROR_KINDS = {
    "io": lambda s: _oserror(_errno.EIO, s),
    "enospc": lambda s: _oserror(_errno.ENOSPC, s),
    "eintr": lambda s: _oserror(_errno.EINTR, s),
    "eagain": lambda s: _oserror(_errno.EAGAIN, s),
    "fnf": lambda s: _oserror(_errno.ENOENT, s),
    "conn": lambda s: ConnectionError(f"injected connection error at {s}"),
    "timeout": lambda s: TimeoutError(f"injected timeout at {s}"),
    "slowdown": lambda s: InjectedClientError("SlowDown", 503, s),
    "http500": lambda s: InjectedClientError("InternalError", 500, s),
    "runtime": lambda s: RuntimeError(f"injected failure at {s}"),
}

_DELAY_RE = _re.compile(r"delay(\d+)$")


def _delay_ms(kind: str) -> Optional[int]:
    m = _DELAY_RE.fullmatch(kind)
    return int(m.group(1)) if m else None


# a ``hang`` parks on this event; release_hangs() sets it
_HANG_RELEASE = threading.Event()


def release_hangs() -> None:
    """Release every thread parked at a ``hang`` failpoint.  The event is
    swapped under the lock the parkers read it under, so a thread
    parks either on the old event (set below) or on the new one."""
    global _HANG_RELEASE
    with _LOCK:
        old = _HANG_RELEASE
        _HANG_RELEASE = threading.Event()
    old.set()


@dataclasses.dataclass
class _Armed:
    pattern: str
    kind: str
    probability: float
    remaining: Optional[int]  # None: unlimited
    rng: random.Random

    def matches(self, site: str) -> bool:
        return site == self.pattern or fnmatch.fnmatchcase(site, self.pattern)


def parse_failpoints(spec: str, seed: int = 0) -> List[_Armed]:
    """The armed specs of ``spec``; ``ValueError`` on a malformed one."""
    armed: List[_Armed] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        if "=" not in raw:
            raise ValueError(f"failpoint spec {raw!r} is not site=error[:prob[:count]]")
        site, _, rhs = raw.partition("=")
        parts = rhs.split(":")
        kind = parts[0].strip().lower()
        if kind not in _ERROR_KINDS and kind != "hang" and _delay_ms(kind) is None:
            raise ValueError(
                f"failpoint spec {raw!r}: unknown error kind {kind!r} "
                f"(known: {sorted(_ERROR_KINDS)}, hang, or delay<ms>)"
            )
        probability = 1.0
        if len(parts) > 1 and parts[1].strip():
            probability = float(parts[1])
            if not 0.0 < probability <= 1.0:
                raise ValueError(
                    f"failpoint spec {raw!r}: probability must be in (0, 1], got {probability}"
                )
        remaining: Optional[int] = None
        if len(parts) > 2 and parts[2].strip() not in ("", "*"):
            remaining = int(parts[2])
            if remaining < 0:
                raise ValueError(f"failpoint spec {raw!r}: count must be >= 0")
        if len(parts) > 3:
            raise ValueError(f"failpoint spec {raw!r}: too many fields")
        armed.append(_Armed(
            pattern=site.strip(), kind=kind, probability=probability, remaining=remaining,
            rng=random.Random(seed ^ zlib.crc32(raw.encode())),
        ))
    return armed


def refresh_from_knobs(strict: bool = False) -> None:
    """Re-arm from the FAILPOINTS knob.  ``strict`` raises on a malformed
    spec; otherwise it is logged and the registry stays disarmed (a
    mistyped variable must not break the import)."""
    global _ARMED
    spec = knobs.get_failpoints()
    if not spec:
        _ARMED = None
        return
    try:
        armed = parse_failpoints(spec, seed=knobs.get_failpoint_seed())
    except ValueError:
        if strict:
            raise
        logger.warning(
            "ignoring malformed TORCHSNAPSHOT_TPU_TORCH_FAILPOINTS=%r", spec, exc_info=True
        )
        _ARMED = None
        return
    _ARMED = armed or None


def active() -> bool:
    return _ARMED is not None


def failpoint(site: str, **attrs) -> None:
    """Evaluate the armed specs at ``site``: raise, sleep or park as the
    first firing spec says."""
    armed = _ARMED
    if armed is None:
        return
    for fp in armed:
        if not fp.matches(site):
            continue
        with _LOCK:
            if fp.remaining == 0:
                continue
            if fp.probability < 1.0 and fp.rng.random() >= fp.probability:
                continue
            if fp.remaining is not None:
                fp.remaining -= 1
        obs.counter(obs.RESILIENCE_FAILPOINTS_FIRED).inc()
        if fp.kind == "hang":
            with _LOCK:
                ev = _HANG_RELEASE
            logger.info(
                "failpoint %s hanging at %s (%s) until release_hangs()", fp.pattern, site, attrs
            )
            if not ev.wait(HANG_DEADLINE_S):
                raise TimeoutError(
                    f"hang failpoint {fp.pattern} at {site} was not released "
                    f"within {HANG_DEADLINE_S} s"
                )
            continue
        ms = _delay_ms(fp.kind)
        if ms is not None:
            logger.info("failpoint %s delayed %s by %dms (%s)", fp.pattern, site, ms, attrs)
            time.sleep(ms / 1000.0)
            continue
        exc = _ERROR_KINDS[fp.kind](site)
        logger.info("failpoint %s fired at %s (%s): %r", fp.pattern, site, attrs, exc)
        raise exc


def fired_count() -> int:
    """Fires since the process started (the counter's value)."""
    return obs.counter(obs.RESILIENCE_FAILPOINTS_FIRED).value


refresh_from_knobs(strict=False)
