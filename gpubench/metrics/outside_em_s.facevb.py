"""outside_em_s.facevb: seconds of the traced ragged-bank job's learn_bank
span outside its learn_bank.em spans (one a K): the padding, the GMM
starts, the float64 restart picks, the results, the selection and the
per-viewer split."""
from gpubench.lib import spans


def read(ctx):
    return spans.outside_em_s(ctx, "learn_bank")
