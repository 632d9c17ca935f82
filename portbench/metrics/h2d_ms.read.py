"""Host seconds in host-to-device copies of tiles (``consume.h2d_s``) per read, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "consume.h2d_s")
