"""Median time ``async_take`` held the caller over the window's takes, ms."""

from portbench.stats import median_unblock_ms


def value(ctx):
    return median_unblock_ms(ctx.window)
