"""outside_em_s.grid: seconds of the traced grid job's cluster_batched
span outside its cluster_batched.em spans: the starts, the rescoring and
the selection."""
from gpubench.lib import spans


def read(ctx):
    return spans.outside_em_s(ctx, "cluster_batched")
