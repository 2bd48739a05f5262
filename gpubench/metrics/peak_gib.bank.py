"""peak_gib.bank: the most device memory a bank job held at once."""
from gpubench.lib import layers


def read(ctx):
    return layers.peak_gib(ctx)
