"""em_kernels_per_iter.face: device kernels of the traced face-demo grid
job that start inside one of the program's vbhem_em.iter spans, per
span."""
from gpubench.lib import spans


def read(ctx):
    return spans.em_kernels_per_iter(ctx, "cluster_batched", "vbhem_em")
