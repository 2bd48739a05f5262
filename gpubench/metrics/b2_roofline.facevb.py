"""b2_roofline.facevb: kernel B2's (fused entry, float32) share of its
bound over the traced ragged-bank job's EM launches at K = 1, 2, 3, the
bound counted on the real trials and fixations alone, at the H100's
published peaks."""
from gpubench.lib import ragged


def read(ctx):
    return ragged.b2_roofline_real(ctx)
