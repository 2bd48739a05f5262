"""peak_gib.face: the most device memory a face-demo grid job held at
once."""
from gpubench.lib import layers


def read(ctx):
    return layers.peak_gib(ctx)
