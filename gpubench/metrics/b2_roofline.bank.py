"""b2_roofline.bank: kernel B2's (fused entry) share of its bound over the
traced bank job's EM launches, at the H100's published peaks."""
from gpubench.lib import layers


def read(ctx):
    return layers.b2_roofline(ctx)
