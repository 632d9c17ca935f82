"""Pinned allocations of tile read buffers (``read.pin_alloc_s``) per read, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "read.pin_alloc_s")
