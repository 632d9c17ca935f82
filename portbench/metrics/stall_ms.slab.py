"""Mean time ``async_take`` held the caller over the window's takes, ms
(in a traced run, with the profiler's host overhead)."""

from portbench.stats import mean_unblock_ms


def value(ctx):
    return mean_unblock_ms(ctx.window)
