"""lane_occupancy.face: share of the lane-iterations the EM loop ran in
the traced face-demo grid job that went to lanes not yet done (the
program's counters vbhem_em.lane_iters_active over
vbhem_em.lane_iters_launched)."""
from gpubench.lib import spans


def read(ctx):
    return spans.lane_occupancy(ctx, "cluster_batched", "vbhem_em")
