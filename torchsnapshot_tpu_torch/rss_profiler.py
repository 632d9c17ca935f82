"""RSS sampling, to show that memory stays bounded in a benchmark.

Counterpart of ``torchsnapshot_tpu/rss_profiler.py``: a background
thread samples the resident set size minus its value at entry at a
fixed interval while the context is active.  The port reads the RSS
from ``/proc/self/statm`` (Linux) in place of ``psutil``.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, List

_DEFAULT_INTERVAL_S = 0.1
_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * _PAGE_SIZE


@contextlib.contextmanager
def measure_rss_deltas(
    rss_deltas: List[int], interval_s: float = _DEFAULT_INTERVAL_S
) -> Iterator[None]:
    """Append RSS-minus-baseline samples (bytes) to ``rss_deltas`` while
    the context is active; the peak is ``max(rss_deltas)``, also set as
    the ``rss_peak_delta_bytes`` gauge."""
    baseline = _rss_bytes()
    stop = threading.Event()

    def sample() -> None:
        while not stop.is_set():
            rss_deltas.append(_rss_bytes() - baseline)
            stop.wait(interval_s)

    thread = threading.Thread(target=sample, name="tsnp-torch-rss", daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join(timeout=10 * interval_s + 1)
        rss_deltas.append(_rss_bytes() - baseline)
        from .obs import metrics as _metrics

        _metrics.gauge(_metrics.RSS_PEAK_DELTA_BYTES).set(max(rss_deltas, default=0))
