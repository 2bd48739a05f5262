"""em_idle.grid: share of the traced grid job's EM iterations (the union of
the program's vbhem_em.iter spans) with nothing running on the device."""
from gpubench.lib import spans


def read(ctx):
    return spans.em_idle(ctx, "cluster_batched", "vbhem_em")
