"""device_idle.face: share of the traced face-demo grid job with nothing
running on the device."""
from gpubench.lib import layers


def read(ctx):
    return layers.device_idle(ctx)
