"""em_idle.bank: share of the traced bank job's EM iterations (the union of
the program's vbem_em.iter spans) with nothing running on the device."""
from gpubench.lib import spans


def read(ctx):
    return spans.em_idle(ctx, "learn_bank", "vbem_em")
