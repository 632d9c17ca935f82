"""The take's planning seconds (``take.plan_s``, the body of ``take/plan``) per take, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "take.plan_s")
