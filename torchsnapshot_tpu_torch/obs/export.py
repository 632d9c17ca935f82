"""OpenMetrics (Prometheus text exposition) export of the registry.

Counterpart of ``torchsnapshot_tpu/obs/export.py`` (the same text for
the same registry).  Scrape-based fleets run node_exporter with a
textfile collector.  ``export_openmetrics()`` renders the live
registry in the text exposition format (counters as ``_total``, gauges
plus a ``_max`` high-water twin, histograms with cumulative
``_bucket{le=...}`` series), and ``write_metrics_textfile()`` dumps it
atomically (tmp + rename — textfile collectors must never scrape a
half-written file) to the path named by the
``TORCHSNAPSHOT_TPU_TORCH_METRICS_TEXTFILE`` knob.  take/restore/async-commit
call ``maybe_write_metrics_textfile()`` on their way out, so an
exporter sidecar sees fresh numbers after every operation without any
in-process HTTP server.

Metric names are sanitized to the exposition charset
(``[a-zA-Z_:][a-zA-Z0-9_:]*``) and prefixed ``tsnp_``:
``storage.fs.write_latency_s`` → ``tsnp_storage_fs_write_latency_s``.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

from .metrics import MetricsRegistry, REGISTRY

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "tsnp_"


def _name(raw: str) -> str:
    return _PREFIX + _NAME_RE.sub("_", raw)


def _fmt(v: Any) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def export_openmetrics(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry rendered in Prometheus text exposition format."""
    snap = (registry or REGISTRY).snapshot()
    lines = []
    for raw, v in sorted(snap.get("counters", {}).items()):
        # the TYPE line must name the SAMPLE's metric name (_total
        # included) in the classic text format, or the type metadata
        # never attaches — node_exporter itself emits `# TYPE x_total
        # counter` / `x_total v`
        n = _name(raw) + "_total"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {_fmt(v)}")
    for raw, g in sorted(snap.get("gauges", {}).items()):
        n = _name(raw)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_fmt(g['value'])}")
        lines.append(f"# TYPE {n}_max gauge")
        lines.append(f"{n}_max {_fmt(g['max'])}")
    for raw, h in sorted(snap.get("histograms", {}).items()):
        n = _name(raw)
        lines.append(f"# TYPE {n} histogram")
        cumulative = 0
        for bound, count in zip(h["bounds"], h["counts"]):
            cumulative += count
            lines.append(
                f'{n}_bucket{{le="{_fmt(bound)}"}} {cumulative}'
            )
        lines.append(f'{n}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{n}_sum {_fmt(h['sum'])}")
        lines.append(f"{n}_count {h['count']}")
    return "\n".join(lines) + "\n"


def write_metrics_textfile(
    path: str, registry: Optional[MetricsRegistry] = None
) -> str:
    """Atomic dump of the exposition text to ``path`` (tmp in the same
    directory + rename, the textfile-collector contract)."""
    text = export_openmetrics(registry)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".tsnp-metrics-", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def maybe_write_metrics_textfile() -> Optional[str]:
    """Dump the registry iff the ``TORCHSNAPSHOT_TPU_TORCH_METRICS_TEXTFILE``
    knob names a path.  Best-effort and never raises: metrics export
    must not fail the operation it describes.  Returns the path written,
    or None.

    A ``{pid}`` placeholder in the path expands to this process's pid —
    REQUIRED when several worker processes share one host and one env:
    a fixed path is last-writer-wins and silently drops every other
    rank's registry from the scrape."""
    from .. import knobs, obs

    path = knobs.get_metrics_textfile()
    if not path:
        return None
    try:
        return write_metrics_textfile(
            path.replace("{pid}", str(os.getpid()))
        )
    except Exception as e:  # noqa: BLE001 — best-effort by contract
        obs.swallowed_exception("obs.export.textfile", e)
        return None
