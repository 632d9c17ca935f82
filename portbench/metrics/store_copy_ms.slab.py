"""The memory store's copies and digests (``write.copy_s``) per take, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "write.copy_s")
