"""The memory store's destination allocations (``write.alloc_s``) per take, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "write.alloc_s")
