"""The shared retry and backoff policy for storage transients.

Counterpart of ``torchsnapshot_tpu/resilience/retry.py``:

- ``SharedProgress`` is the shared-deadline window: every operation on
  a plugin shares one clock, refreshed whenever any of them completes,
  so an operation gives up only when the whole pipeline has made no
  progress for the window (``RETRY_PROGRESS_WINDOW_S``) or it ran out of
  attempts (``RETRY_MAX_ATTEMPTS``).
- ``retry_call`` runs an operation, classifies each failure, backs off
  exponentially with a deterministic jitter (capped at
  ``RETRY_BACKOFF_CAP_S``) on transients, and feeds the backend's
  circuit breaker.

A classifier's verdicts: ``transient`` (retry), ``missing`` (raise
``FileNotFoundError`` chaining the original), ``fatal`` (re-raise, a
breaker failure), ``raise`` (re-raise, not a breaker failure) and
``success_none`` (swallow, return None).  Every backoff sleeps for a
bounded time, so a retried operation ends within its attempts.
"""

from __future__ import annotations

import asyncio
import errno as _errno
import logging
import random
import time
import zlib
from typing import Any, Callable, Optional

from .. import knobs, obs

logger = logging.getLogger(__name__)

TRANSIENT = "transient"
MISSING = "missing"
FATAL = "fatal"
RAISE = "raise"
SUCCESS_NONE = "success_none"

_VERDICTS = frozenset((TRANSIENT, MISSING, FATAL, RAISE, SUCCESS_NONE))


class SharedProgress:
    """One retry window shared by a plugin's operations: any completion
    anywhere refreshes the clock."""

    def __init__(
        self,
        window_s: Optional[float] = None,
        max_attempts: Optional[int] = None,
        label: str = "",
    ) -> None:
        self.window_s = knobs.get_retry_progress_window_s() if window_s is None else window_s
        self.max_attempts = (
            knobs.get_retry_max_attempts() if max_attempts is None else max_attempts
        )
        self.last_progress = time.monotonic()
        # a private stream seeded by the label: jitter never touches the
        # global random state, and the same label replays the same delays
        self._rng = random.Random(0x5EED ^ zlib.crc32(label.encode()))

    def record_progress(self) -> None:
        self.last_progress = time.monotonic()

    def should_retry(self, attempt: int, started: Optional[float] = None) -> bool:
        """``started``: when the current operation began.  Idle time
        before it is not its stall, so the window is measured from the
        later of the last progress and ``started``."""
        if attempt >= self.max_attempts:
            return False
        anchor = self.last_progress
        if started is not None and started > anchor:
            anchor = started
        return (time.monotonic() - anchor) < self.window_s

    def backoff_delay(self, attempt: int) -> float:
        cap = knobs.get_retry_backoff_cap_s()
        return min(2**attempt, cap) * (0.5 + self._rng.random())

    async def backoff(self, attempt: int) -> None:
        delay = self.backoff_delay(attempt)
        obs.histogram(obs.RESILIENCE_BACKOFF_DELAY_S).observe(delay)
        await asyncio.sleep(delay)


def lazy_shared_progress(obj: Any, label: str) -> SharedProgress:
    """Get or create ``obj._progress``, one ``SharedProgress`` per plugin
    instance (through ``__dict__``, so plugins made with ``__new__`` in
    tests work too)."""
    p = obj.__dict__.get("_progress")
    if p is None:
        p = obj.__dict__["_progress"] = SharedProgress(label=label)
    return p


async def retry_call(
    fn: Callable[[], Any],
    *,
    op_name: str,
    backend: str,
    classify: Callable[[BaseException], str],
    progress: SharedProgress,
    executor: Any = None,
    breaker: Any = None,
) -> Any:
    """Run ``fn`` under the shared policy: on ``executor`` when given,
    else called here (and awaited when it returns a coroutine).
    ``breaker``: a ``CircuitBreaker`` checked before the first attempt
    (open: fail fast) and fed the operation's final outcome."""
    if breaker is not None:
        breaker.check(op_name)
    try:
        return await _retry_loop(fn, op_name, backend, classify, progress, executor, breaker)
    except BaseException:
        # whatever escapes must not leave a half-open probe slot claimed
        if breaker is not None:
            breaker.release_probe()
        raise


async def _retry_loop(fn, op_name, backend, classify, progress, executor, breaker) -> Any:
    loop = asyncio.get_running_loop() if executor is not None else None
    attempt = 0
    started = time.monotonic()
    # the last backoff span gets the chain's final verdict
    last_backoff_span = None

    def _stamp_final(verdict: str) -> None:
        if last_backoff_span is not None:
            last_backoff_span.attrs["final_verdict"] = verdict

    while True:
        try:
            if executor is not None:
                result = await loop.run_in_executor(executor, fn)
            else:
                result = fn()
                if asyncio.iscoroutine(result):
                    result = await result
            progress.record_progress()
            if breaker is not None:
                breaker.record_success()
            _stamp_final("success")
            return result
        except FileNotFoundError:
            # missing is an answer, not a backend failure
            if breaker is not None:
                breaker.release_probe()
            raise
        # Exception, not BaseException: cancellation and interrupts
        # propagate at once
        except Exception as e:  # noqa: BLE001 — classified below
            verdict = classify(e)
            if verdict not in _VERDICTS:
                raise AssertionError(f"classifier for {backend} returned {verdict!r}") from e
            if verdict == MISSING:
                if breaker is not None:
                    breaker.release_probe()
                raise FileNotFoundError(f"{op_name}: {e}") from e
            if verdict == SUCCESS_NONE:
                progress.record_progress()
                if breaker is not None:
                    breaker.record_success()
                return None
            if verdict == RAISE:
                if breaker is not None:
                    breaker.release_probe()
                raise
            if verdict == FATAL:
                if breaker is not None:
                    breaker.record_failure()
                _stamp_final("fatal")
                raise
            attempt += 1
            obs.counter(obs.RESILIENCE_RETRIES).inc()
            obs.counter(f"resilience.{backend}.retries").inc()
            if not progress.should_retry(attempt, started=started):
                if breaker is not None:
                    breaker.record_failure()
                _stamp_final("exhausted")
                raise
            logger.warning(
                "%s %s failed (attempt %d, retrying): %r", backend, op_name, attempt, e
            )
            with obs.span(
                "resilience/backoff", backend=backend, op=op_name, attempt=attempt,
                verdict=verdict,
            ) as sp:
                if sp is not None:
                    last_backoff_span = sp
                await progress.backoff(attempt)


# ------------------------------------------------------- classifiers

_FS_TRANSIENT_ERRNOS = frozenset((_errno.EINTR, _errno.EAGAIN))


def classify_fs(e: BaseException) -> str:
    """Local filesystem: EINTR and EAGAIN retry; anything else (ENOSPC,
    EIO, ...) is fatal."""
    if isinstance(e, OSError) and e.errno in _FS_TRANSIENT_ERRNOS:
        return TRANSIENT
    return FATAL


def _client_error_code(e: BaseException) -> str:
    return str(getattr(e, "response", {}).get("Error", {}).get("Code", ""))


def _http_status(e: BaseException) -> Optional[int]:
    status = getattr(e, "response", {}).get("ResponseMetadata", {}).get("HTTPStatusCode")
    return status if isinstance(status, int) else None


_S3_MISSING_CODES = frozenset(("NoSuchKey", "NoSuchUpload", "404"))
_S3_TRANSIENT_CODES = frozenset((
    "SlowDown", "Throttling", "ThrottlingException", "RequestTimeout",
    "RequestLimitExceeded", "ServiceUnavailable", "InternalError",
    "500", "502", "503", "504",
))


def classify_s3(e: BaseException) -> str:
    """S3-shaped errors, duck-typed (``e.response["Error"]["Code"]`` and
    the HTTP status; no ``botocore`` import): missing, transient or
    fatal."""
    code = _client_error_code(e)
    name = type(e).__name__
    if code in _S3_MISSING_CODES or name == "NoSuchKey":
        return MISSING
    if code in _S3_TRANSIENT_CODES or name == "SlowDown":
        return TRANSIENT
    if isinstance(e, (ConnectionError, TimeoutError)):
        return TRANSIENT
    if "ConnectionError" in name or "Timeout" in name:
        return TRANSIENT
    status = _http_status(e)
    if status is not None and status >= 500:
        return TRANSIENT
    return FATAL


def classify_generic(e: BaseException) -> str:
    """Backends with no richer signal (``memory://``, third-party
    plugins, the codec): connection and timeout errors and EINTR/EAGAIN
    retry, the rest is fatal."""
    if isinstance(e, (ConnectionError, TimeoutError)):
        return TRANSIENT
    return classify_fs(e)
