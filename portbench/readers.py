"""What the metric readers under ``e2e/`` and ``metrics/`` share."""

from __future__ import annotations

from typing import Optional

from .stats import roofline_pct


def phase_ms_per_op(ctx, histogram: str) -> Optional[float]:
    """The program's ``histogram`` summed over the window (seconds of
    its tasks, concurrent ones added), in ms per completed operation."""
    n = len(ctx.window.done)
    if not n or histogram not in ctx.phases:
        return None
    return 1e3 * ctx.phases[histogram] / n


def kernel_roofline(ctx, trace_name: str) -> Optional[float]:
    """The least time the calls of the kernel named ``trace_name`` needed
    at the HBM peak, as a share of its time in the device trace; None
    without either."""
    if ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_seconds(trace_name)
    return roofline_pct(ctx.kernel_bytes.get(trace_name, 0), seconds, float(ctx.peaks["hbm_bytes_per_s"]))


def device_idle_pct(ctx) -> Optional[float]:
    """100 less the share of the traced window that kernels, copies and
    memsets covered; None where the trace shows no device time."""
    if ctx.trace is None or ctx.trace.busy_s <= 0 or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
