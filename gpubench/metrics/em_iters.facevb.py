"""em_iters.facevb: EM iterations per ragged-bank job over the K loops
(the program's info["model_em_iters"]), checked against the launches of
kernel B2's fused entry (one an iteration, one more a K for the float64
pick)."""
from gpubench.lib import ragged


def read(ctx):
    return ragged.em_iters(ctx)
