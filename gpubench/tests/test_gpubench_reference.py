"""The plain reference against the program's eager (CPU) path in float64
at tiny sizes: one VBHEM and one VBEM EM iteration (bound and M-step),
the starts restated from the program's uniforms (baseem, wtkmeans, the
GMM of VBEM's 'random'), and a cell's restarts rerun from them."""
import math

import pytest
import torch

from gpubench.jobs import bank as bank_job
from gpubench.jobs import grid as grid_job
from gpubench.lib import data
from gpubench.reference import starts as rstarts
from gpubench.reference import vbem as rvbem
from gpubench.reference import vbhem as rvbhem

F64 = torch.float64
TOL = 1e-10


def _close(a, b):
    return torch.max(torch.abs(a - b) / (1.0 + torch.abs(b))) <= TOL


@pytest.mark.parametrize("kr,sr", [(1, 1), (2, 2), (3, 2), (2, 3)])
def test_vbhem_iteration(kr, sr):
    from vbhem_tpu_torch.config import VBHEMConfig
    from vbhem_tpu_torch.containers import H3M, HMM
    from vbhem_tpu_torch.models import vbhem
    groups = [{"prior": [0.6, 0.3, 0.1],
               "trans": [[0.6, 0.2, 0.2], [0.5, 0.4, 0.1], [0.2, 0.3, 0.5]],
               "mean": [[0.0, 0.0], [3.0, 1.0], [1.0, 4.0]],
               "cov": [[[1.0, 0.2], [0.2, 1.5]]] * 3}] * 2
    spec = {"state_counts": [1, 2, 3], "state_count_p": [0.2, 0.3, 0.5],
            "prior_conc": 20.0, "trans_conc": 40.0, "mean_sd": 0.5,
            "cov_sd": 0.1}
    gen = data.generator(5, "cpu")
    omega, prior, trans, mean, cov, mask = data.draw_bank(
        gen, groups, 12, spec, "cpu", F64)
    base = H3M(omega=omega, hmm=HMM(prior=prior, trans=trans, mean=mean,
                                    cov=cov), state_mask=mask)
    hcfg = {"alpha0": 2.0, "eta0": 1.5, "epsilon0": 0.7, "lambda0": 1.2,
            "v0": 5.0, "m0": [1.0, 2.0], "w0": 0.5, "nv": 20, "tau": 6}
    cfg = VBHEMConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in hcfg.items()})
    hyps = vbhem.VBHEMHyps.from_config(cfg, 2, F64, "cpu")
    post = vbhem.init_baseem(torch.Generator().manual_seed(3), base, kr, sr,
                             hyps, cfg.nv)
    tilde_n = (cfg.nv * base.num_hmms) * base.omega
    new, ll, _, _, _ = vbhem._em_iteration(base, post, hyps, tilde_n,
                                           cfg.tau)
    ref_ll, ref_new = rvbhem.iteration(
        rvbhem.Bank(omega, prior, trans, mean, cov),
        rvbhem.Post(post.alpha, post.eta, post.epsilon, post.niw.beta,
                    post.niw.v, post.niw.m, post.niw.w),
        grid_job.ref_hyps(hcfg, 2), cfg.nv, cfg.tau)
    assert abs(float(ll) - float(ref_ll)) <= TOL * abs(float(ref_ll))
    got = (new.alpha, new.eta, new.epsilon, new.niw.beta, new.niw.v,
           new.niw.m, new.niw.w)
    for g, r in zip(got, ref_new):
        assert _close(g, r)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_vbem_iteration(k):
    from vbhem_tpu_torch.config import VBConfig
    from vbhem_tpu_torch.containers import SeqBatch
    from vbhem_tpu_torch.models import vbhmm
    groups = [{"prior": [0.5, 0.5], "trans": [[0.7, 0.3], [0.2, 0.8]],
               "mean": [[0.0, 0.0], [3.0, 3.0]],
               "cov": [[[1.0, 0.0], [0.0, 1.0]]] * 2}] * 2
    x, lengths = data.draw_sequences(data.generator(7, "cpu"), groups, 6,
                                        4, 9, 0.1, "cpu", F64)
    lengths[0, 1] = 4          # a ragged sequence: padded steps masked
    batch = SeqBatch(x=x, lengths=lengths)
    vcfg = {"alpha0": 0.3, "epsilon0": 0.2, "beta0": 1.5, "v0": 4.0,
            "mu0": [1.0, 1.0], "w0": 0.8}
    cfg = VBConfig(**{kk: tuple(v) if isinstance(v, list) else v
                      for kk, v in vcfg.items()})
    hyps = vbhmm.VBHyps.from_config(cfg, 2, F64, "cpu")
    post = vbhmm.random_init(torch.Generator().manual_seed(2), batch, k,
                             hyps)
    new, ll, _, _ = vbhmm._iteration(batch, post, hyps)
    mask = torch.arange(9) < lengths[..., None]
    ref_ll, ref_new = rvbem.iteration(
        x, mask, rvbem.Post(post.alpha, post.epsilon, post.niw.beta,
                            post.niw.v, post.niw.m, post.niw.w),
        bank_job.ref_hyps(vcfg, 2))
    assert _close(ll, ref_ll)
    got = (new.alpha, new.epsilon, new.niw.beta, new.niw.v, new.niw.m,
           new.niw.w)
    for g, r in zip(got, ref_new):
        assert _close(g, r)


GROUPS3 = [{"prior": [0.6, 0.3, 0.1],
            "trans": [[0.6, 0.2, 0.2], [0.5, 0.4, 0.1], [0.2, 0.3, 0.5]],
            "mean": [[0.0, 0.0], [3.0, 1.0], [1.0, 4.0]],
            "cov": [[[1.0, 0.2], [0.2, 1.5]]] * 3},
           {"prior": [0.2, 0.3, 0.5],
            "trans": [[0.3, 0.3, 0.4], [0.1, 0.8, 0.1], [0.4, 0.4, 0.2]],
            "mean": [[5.0, 0.0], [3.0, 1.0], [-2.0, 3.0]],
            "cov": [[[0.7, 0.0], [0.0, 0.7]]] * 3}]
SPEC3 = {"state_counts": [1, 2, 3], "state_count_p": [0.2, 0.3, 0.5],
         "prior_conc": 20.0, "trans_conc": 40.0, "mean_sd": 0.3,
         "cov_sd": 0.1}
HCFG = {"alpha0": 2.0, "eta0": 1.5, "epsilon0": 0.7, "lambda0": 1.2,
        "v0": 5.0, "m0": [1.0, 2.0], "w0": 0.5, "nv": 20, "tau": 6}


def _base(n=12, seed=5):
    from vbhem_tpu_torch.containers import H3M, HMM
    omega, prior, trans, mean, cov, mask = data.draw_bank(
        data.generator(seed, "cpu"), GROUPS3, n, SPEC3, "cpu", F64)
    return (H3M(omega=omega, hmm=HMM(prior=prior, trans=trans, mean=mean,
                                     cov=cov), state_mask=mask),
            rvbhem.Bank(omega, prior, trans, mean, cov), mask)


@pytest.mark.parametrize("mode", ["baseem", "wtkmeans"])
def test_vbhem_starts_from_the_programs_uniforms(mode):
    from vbhem_tpu_torch.config import VBHEMConfig
    from vbhem_tpu_torch.models import vbhem
    base, bank, mask = _base()
    cfg = VBHEMConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in HCFG.items()})
    hyps = vbhem.VBHEMHyps.from_config(cfg, 2, F64, "cpu")
    kr, sr, n = 3, 2, 7
    got = vbhem.draw_lanes(mode, data.generator(11, "cpu"), base, kr, sr,
                           hyps, cfg.nv, n)
    want = rstarts.vbhem_starts(mode, data.generator(11, "cpu"), bank, mask,
                                grid_job.ref_hyps(HCFG, 2), cfg.nv, kr, sr,
                                n, slice(0, n), F64)
    for g, w in zip((got.alpha, got.eta, got.epsilon, got.niw.beta,
                     got.niw.v, got.niw.m, got.niw.w), want):
        assert _close(g, w)


def test_vbem_starts_from_the_programs_uniforms():
    from vbhem_tpu_torch.config import VBConfig
    from vbhem_tpu_torch.containers import SeqBatch
    from vbhem_tpu_torch.models import vbhmm
    groups = [{"prior": [0.5, 0.5], "trans": [[0.7, 0.3], [0.2, 0.8]],
               "mean": [[0.0, 0.0], [3.0, 3.0]],
               "cov": [[[1.0, 0.0], [0.0, 1.0]]] * 2}] * 2
    x, lengths = data.draw_sequences(data.generator(7, "cpu"), groups, 5,
                                     4, 9, 0.1, "cpu", F64)
    vcfg = {"alpha0": 0.3, "epsilon0": 0.2, "beta0": 1.5, "v0": 4.0,
            "mu0": [1.0, 1.0], "w0": 0.8}
    cfg = VBConfig(**{kk: tuple(v) if isinstance(v, list) else v
                      for kk, v in vcfg.items()})
    hyps = vbhmm.VBHyps.from_config(cfg, 2, F64, "cpu")
    k, restarts = 2, 3
    got = vbhmm.random_init(data.generator(4, "cpu"),
                            SeqBatch(x=x, lengths=lengths), k, hyps,
                            lanes=(restarts,))
    u = rstarts.gmm_draws(data.generator(4, "cpu"), 5, restarts, 4 * 9)
    w_pt = torch.ones(5, 4 * 9, dtype=F64)
    weight, mean, cov = rstarts.gmm(x.flatten(1, 2), w_pt, u, k)
    want = rstarts.vbem_start(weight, mean, cov,
                              torch.sum(w_pt, -1)[:, None],
                              bank_job.ref_hyps(vcfg, 2))
    for g, w in zip((got.alpha, got.epsilon, got.niw.beta, got.niw.v,
                     got.niw.m, got.niw.w), want):
        assert torch.max(torch.abs(g - w) / (1.0 + torch.abs(w))) <= 1e-8


@pytest.mark.parametrize("mode", ["baseem", "wtkmeans"])
def test_rerun_meets_the_programs_cell_winner(mode):
    # the program's padded, masked grid in float64 against the reference's
    # unpadded EM of one cell's restarts from the same starts
    from vbhem_tpu_torch.config import VBHEMConfig
    from vbhem_tpu_torch.models import vbhem
    base, bank, mask = _base(n=10, seed=8)
    hcfg = dict(HCFG, trials=5, max_iter=60, min_diff=1e-7, initmode=mode,
                learn_hyps=False)
    cfg = VBHEMConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in hcfg.items()})
    ks, ss = [1, 2, 3], [1, 2]
    _, info = vbhem.cluster_batched(data.generator(21, "cpu"), base, ks, ss,
                                    cfg)

    class _Job:
        config = {"vbhem": hcfg}
        device = torch.device("cpu")
        dtype = F64
    _Job.ks, _Job.ss = ks, ss
    answer = {"bank": (bank.omega, bank.prior, bank.trans, bank.mean,
                       bank.cov, mask), "restart_seed": 21}
    for cell in [(2, 2), (3, 1), (3, 2)]:
        _, e_best = grid_job.rerun(_Job, answer, cell, F64, F64)
        p = info["model_all"][cell].post
        e_prog, _ = rvbhem.iteration(
            bank, rvbhem.Post(p.alpha, p.eta, p.epsilon, p.niw.beta, p.niw.v,
                              p.niw.m, p.niw.w),
            grid_job.ref_hyps(hcfg, 2), hcfg["nv"], hcfg["tau"])
        assert math.isclose(float(e_prog), e_best, rel_tol=1e-6), cell
