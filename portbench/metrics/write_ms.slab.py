"""The storage write seconds (``phase.write_s``) per take, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "phase.write_s")
