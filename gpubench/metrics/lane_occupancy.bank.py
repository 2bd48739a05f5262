"""lane_occupancy.bank: share of the lane-iterations the EM loop ran in the
traced bank job that went to lanes not yet done (the program's counters
vbem_em.lane_iters_active over vbem_em.lane_iters_launched)."""
from gpubench.lib import spans


def read(ctx):
    return spans.lane_occupancy(ctx, "learn_bank", "vbem_em")
