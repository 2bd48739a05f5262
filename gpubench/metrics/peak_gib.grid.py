"""peak_gib.grid: the most device memory a grid job held at once."""
from gpubench.lib import layers


def read(ctx):
    return layers.peak_gib(ctx)
