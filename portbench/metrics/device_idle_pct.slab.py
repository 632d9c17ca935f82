"""The device's idle share of the traced window, %."""

from portbench.readers import device_idle_pct


def value(ctx):
    return device_idle_pct(ctx)
