"""pad_share.facevb: share of the step slots the traced ragged-bank job's
EM loops launched that went to padding (empty trials and steps past a
trial's end), from the program's learn_bank counters."""
from gpubench.lib import ragged


def read(ctx):
    return ragged.pad_share(ctx)
