"""The eager offload's seconds (``take.offload_s``: device clones, K1 enqueue, blocking host copies) per take, ms."""

from portbench.readers import phase_ms_per_op


def value(ctx):
    return phase_ms_per_op(ctx, "take.offload_s")
