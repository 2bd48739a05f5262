"""device_idle.grid: share of the traced grid job with nothing running on
the device."""
from gpubench.lib import layers


def read(ctx):
    return layers.device_idle(ctx)
