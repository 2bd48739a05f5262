"""em_iters.bank: EM iterations per bank job (the program's
info["model_em_iters"]), checked against the launches of kernel B2's fused
entry (one an iteration, one more for the float64 pick)."""
from gpubench.lib import layers


def read(ctx):
    return layers.em_iters(ctx, "B2_fused", exact=False)
