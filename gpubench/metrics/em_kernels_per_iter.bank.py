"""em_kernels_per_iter.bank: device kernels of the traced bank job that
start inside one of the program's vbem_em.iter spans, per span."""
from gpubench.lib import spans


def read(ctx):
    return spans.em_kernels_per_iter(ctx, "learn_bank", "vbem_em")
