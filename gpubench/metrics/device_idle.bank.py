"""device_idle.bank: share of the traced bank job with nothing running on
the device."""
from gpubench.lib import layers


def read(ctx):
    return layers.device_idle(ctx)
