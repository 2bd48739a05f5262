"""b1_roofline.face: kernel B1's share of its bound in the traced
face-demo grid job, each lane at its own cell's S, at the H100's published
peaks."""
from gpubench.lib import layers


def read(ctx):
    return layers.b1_roofline(ctx)
