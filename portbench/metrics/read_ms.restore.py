"""The storage read seconds (``phase.read_s``) per restore, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "phase.read_s")
