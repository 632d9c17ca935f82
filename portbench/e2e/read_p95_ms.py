"""95th percentile over every read of the window, issue to synchronised tensor, ms."""

from portbench.stats import latency_p95_ms


def value(ctx):
    return latency_p95_ms(ctx.window)
