"""State bytes of every take in the traced window ÷ the window's
seconds, GB/s: the take rate of a cell that does not bound it end to
end (its runs spread too widely for any bound)."""

from portbench.stats import rate_gbps


def value(ctx):
    return rate_gbps(ctx.window)
