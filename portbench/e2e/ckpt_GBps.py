"""State bytes of every take in the window ÷ the window's seconds, GB/s."""

from portbench.stats import rate_gbps


def value(ctx):
    return rate_gbps(ctx.window)
