"""The landing seconds (H2D and K2, ``phase.consume_s``) per restore, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "phase.consume_s")
