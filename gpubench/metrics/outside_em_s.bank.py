"""outside_em_s.bank: seconds of the traced bank job's learn_bank span
outside its learn_bank.em span: the GMM starts, the float64 restart pick,
the results and the per-subject split."""
from gpubench.lib import spans


def read(ctx):
    return spans.outside_em_s(ctx, "learn_bank")
