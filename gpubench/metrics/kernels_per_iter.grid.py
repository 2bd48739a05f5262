"""kernels_per_iter.grid: every device kernel of the traced grid job (its
starts, EM, rescoring and results) over its EM iterations."""
from gpubench.lib import layers


def read(ctx):
    return layers.kernels_per_iter(ctx)
