"""The host's waits on device-to-host copies (``stage.d2h_wait_s``) per take, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "stage.d2h_wait_s")
