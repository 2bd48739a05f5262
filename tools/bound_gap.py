"""Where the float32 VBHEM bound leaves the float64 one, term by term.

Builds a bank shaped like chip_smoke's learned bank (Kb HMMs of the
synthetic protocol's two groups: means (0, 0) / (3, 3), identity
covariances, transitions [[.6, .4], [.4, .6]] and the swapped matrix,
jittered), draws ``--lanes`` 'gmmNew' starts of the (K=2, S=2) cell at
the pipeline's settings (alpha0=1e6, Nv=100, tau=50), runs ``--iters``
EM iterations in float64 and, at each iterate, evaluates the bound in
float64 and in float32 (the E-step of the bank's device: kernel B1 on
the card, the plain version on the CPU) with the soft assignments
normalized two ways:

  * ``softmax``: ``vbhem.soft_assignments`` (normalized exponentials);
  * ``exp-lse``: exp(log_z - logsumexp(log_z)), the JAX package's form
    (``vbhem_tpu/models/vbhem.py:206``).

Prints, per iterate, the largest relative gap of the float32 bound under
each form, the largest |row sum - 1| of the float32 hat_z under each, and
the term with the largest absolute gap.

    python3 tools/bound_gap.py [--kb 512] [--lanes 4] [--iters 4]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vbhem_tpu_torch.config import VBHEMConfig  # noqa: E402
from vbhem_tpu_torch.containers import H3M, HMM, tree_map  # noqa: E402
from vbhem_tpu_torch.models import vbhem  # noqa: E402
from vbhem_tpu_torch.utils.numeric import logsumexp, tiny  # noqa: E402

CONFIG = VBHEMConfig(alpha0=1e6, m0=(1.5, 1.5), w0=1.0, nv=100, tau=50,
                     learn_hyps=False)


def protocol_like_bank(kb: int, device, seed: int = 0) -> H3M:
    """Kb two-state HMMs, half from each of the protocol's groups."""
    rng = np.random.default_rng(seed)
    half = kb // 2
    trans = np.stack([[[.6, .4], [.4, .6]]] * half
                     + [[[.4, .6], [.6, .4]]] * (kb - half))
    trans = np.abs(trans + rng.normal(0, 0.02, trans.shape))
    trans /= trans.sum(-1, keepdims=True)
    mean = np.array([[0., 0.], [3., 3.]])[None] \
        + rng.normal(0, 0.03, (kb, 2, 2))
    cov = np.eye(2)[None, None] * (1 + rng.normal(0, 0.02, (kb, 2, 1, 1)))

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    return H3M(omega=t(np.full(kb, 1.0 / kb)),
               hmm=HMM(t(np.full((kb, 2), 0.5)), t(trans), t(mean), t(cov)),
               state_mask=torch.ones(kb, 2, dtype=torch.bool, device=device))


def bound(base, post, hyps, form):
    """The bound, its terms and hat_z's largest |row sum - 1|, with hat_z
    normalized by ``form``."""
    tilde_n = (CONFIG.nv * base.num_hmms) * base.omega
    post_w, exps_w, exps = vbhem.wide_expectations(post)
    pair = vbhem.e_step(base, post, exps, CONFIG.tau)
    hat_z, z_ni, nj = vbhem.soft_assignments(tilde_n, exps.log_omega,
                                             pair.ll_elbo)
    if form == "exp-lse":
        log_z = tilde_n[:, None] * (exps.log_omega[..., None, :]
                                    + pair.ll_elbo)
        hat_z = torch.exp(log_z - logsumexp(log_z, dim=-1, keepdim=True)) \
            + tiny(log_z.dtype)
        z_ni = hat_z * tilde_n[:, None]
        nj = torch.sum(z_ni, dim=-2) + tiny(log_z.dtype)
    total, terms = vbhem.elbo(post_w, exps_w, pair, hat_z, z_ni, nj, hyps,
                              return_terms=True)
    rows = float(torch.max(torch.abs(hat_z.double().sum(-1) - 1.0)))
    return total, terms, rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kb", type=int, default=512)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    base64 = protocol_like_bank(args.kb, dev)
    base32 = tree_map(lambda x: x.float() if x.is_floating_point() else x,
                      base64)
    h64 = vbhem.VBHEMHyps.from_config(CONFIG, 2, torch.float64, dev)
    h32 = vbhem.VBHEMHyps.from_config(CONFIG, 2, torch.float32, dev)
    post = vbhem.draw_lanes("gmmNew", torch.Generator().manual_seed(0),
                            base64, 2, 2, h64, CONFIG.nv, args.lanes)
    tilde_n = (CONFIG.nv * args.kb) * base64.omega
    for it in range(args.iters):
        ll64, t64, _ = bound(base64, post, h64, "softmax")
        p32 = tree_map(lambda x: x.float(), post)
        line = [f"iterate {it}: float64 bound {float(ll64.max()):.6e}"]
        for form in ("softmax", "exp-lse"):
            ll32, t32, rows = bound(base32, p32, h32, form)
            rel = float(torch.max(torch.abs(ll32.double() - ll64)
                                  / torch.abs(ll64)))
            worst = max(t64, key=lambda k: float(torch.max(torch.abs(
                t32[k].double() - t64[k]))))
            gap = float(torch.max(torch.abs(t32[worst].double()
                                            - t64[worst])))
            line.append(f"{form}: float32 relative gap {rel:.3e}, hat_z "
                        f"|row sum - 1| {rows:.3e}, largest term gap "
                        f"{worst} {gap:.4g}")
        print("; ".join(line), flush=True)
        post = vbhem._em_iteration(base64, post, h64, tilde_n,
                                   CONFIG.tau)[0]
    return 0


if __name__ == "__main__":
    sys.exit(main())
