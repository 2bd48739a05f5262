"""em_iters.face: EM iterations per face-demo grid job, summed over its
lane chunks (the program's info["grid_chunk_iters"]), each checked against
one launch of kernel B1."""
from gpubench.lib import layers


def read(ctx):
    return layers.em_iters(ctx, "B1", exact=True)
