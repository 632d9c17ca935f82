"""Pinned allocations of device-to-host staging (``stage.pin_alloc_s``) per take, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "stage.pin_alloc_s")
