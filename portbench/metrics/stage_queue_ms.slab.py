"""Staging functions' waits for a staging thread (``stage.queue_s``) per take, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "stage.queue_s")
