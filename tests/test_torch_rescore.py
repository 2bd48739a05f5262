"""The port's float64 rescoring of a VBHEM grid cell
(``models/rescore.elbo_f64`` and ``pair_ll_elbo_f64``, on the device in
float64) against the JAX package's NumPy oracle
(``vbhem_tpu.models.rescore``) on the same float64 inputs, made from a
numpy seed: the bound and each of its ten terms at rtol 1e-10, and the
data term's recursion at rtol 1e-10.  Posteriors come from a few of the
port's EM iterations, so they are not the initializer's."""
import numpy as np
import pytest
import torch

from tests.test_torch_vbhem import jax_bank
from vbhem_tpu.models import rescore as jrescore
from vbhem_tpu_torch import VBHEMConfig, convert
from vbhem_tpu_torch.models import rescore as trescore
from vbhem_tpu_torch.models import vbhem as tv

RTOL = 1e-10


def problem(seed, kb=9, sb=2, kr=3, sr=2, ragged=False):
    """A bank, hyperparameters and a posterior after 4 EM iterations, in
    the port's float64 containers on the CPU."""
    jb = jax_bank(np.random.default_rng(seed), kb, sb, 2)
    base = convert.to_torch(jb, device="cpu")
    if ragged:   # every other base HMM with its last state padded out
        prior, trans = base.hmm.prior.clone(), base.hmm.trans.clone()
        prior[::2, -1] = 0.0
        prior = prior / prior.sum(-1, keepdim=True)
        trans[::2, -1] = 0.0
        trans[::2, :, -1] = 0.0
        rows = trans.sum(-1, keepdim=True)
        trans = torch.where(rows > 0, trans / rows.clamp_min(1e-300), trans)
        mask = base.state_mask.clone()
        mask[::2, -1] = False
        base = base._replace(hmm=base.hmm._replace(prior=prior, trans=trans),
                             state_mask=mask)
    cfg = VBHEMConfig(m0=(0.0, 0.0), w0=0.7, nv=10, tau=6, alpha0=2.0)
    hyps = tv.VBHEMHyps.from_config(cfg, 2, device="cpu")
    post = tv.init_baseem(torch.Generator().manual_seed(seed), base, kr, sr,
                          hyps, cfg.nv)
    st = tv.vbhem_em(base, post, hyps, nv=cfg.nv, tau=cfg.tau, max_iter=4,
                     min_diff=0.0)
    return base, st.post, hyps, cfg


CASES = {"sr2": dict(seed=3), "sr1": dict(seed=4, sr=1),
         "sr3_kr2": dict(seed=5, kr=2, sr=3),
         "ragged_sb3": dict(seed=6, sb=3, ragged=True)}


@pytest.mark.parametrize("name", list(CASES))
def test_elbo_f64_matches_jax_oracle_with_its_terms(name):
    base, post, hyps, cfg = problem(**CASES[name])
    want, want_terms = jrescore.elbo_f64(
        convert.to_numpy(base), convert.to_numpy(post),
        convert.to_numpy(hyps), cfg.nv, cfg.tau, return_terms=True)
    got, terms = trescore.elbo_f64(base, post, hyps, cfg.nv, cfg.tau,
                                   return_terms=True)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert set(terms) == set(want_terms) == {f"lt{i}" for i in range(1, 11)}
    for t in want_terms:
        np.testing.assert_allclose(terms[t], want_terms[t], rtol=RTOL,
                                   atol=1e-9, err_msg=t)
    assert trescore.elbo_f64(base, post, hyps, cfg.nv, cfg.tau) == got


def test_pair_ll_elbo_f64_matches_jax_oracle():
    base, post, hyps, cfg = problem(7, sb=3, kr=2, sr=3)
    exps = tv.reduced_expectations(post)
    ell = tv.pair_estep_cuda.expected_pair_ll_variational(
        base.hmm.mean, base.hmm.cov, post.niw.m, post.niw.w, post.niw.v,
        post.niw.beta, exps.log_lam)
    args = (base.hmm.prior, base.hmm.trans, exps.log_pi, exps.log_a, ell)
    want = jrescore.pair_ll_elbo_f64(*[a.numpy() for a in args], cfg.tau)
    got = trescore.pair_ll_elbo_f64(*args, cfg.tau)
    assert got.dtype == torch.float64 and got.shape == (9, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_elbo_f64_of_float32_models_and_the_device_bound():
    """A float32 bank and posterior are rescored in float64 as their
    float64 casts are; and the rescoring is the bound the EM loop
    evaluates, on the EM loop's own E-step."""
    base, post, hyps, cfg = problem(8)
    cast = (lambda t: tv.tree_map(
        lambda a: a.float() if a.is_floating_point() else a, t))
    back = (lambda t: tv.tree_map(
        lambda a: a.double() if a.is_floating_point() else a, t))
    b32, p32, h32 = cast(base), cast(post), cast(hyps)
    assert trescore.elbo_f64(b32, p32, h32, cfg.nv, cfg.tau) == \
        trescore.elbo_f64(back(b32), back(p32), back(h32), cfg.nv, cfg.tau)
    exps = tv.reduced_expectations(post)
    pair = tv.e_step(base, post, exps, cfg.tau)
    tilde_n = (cfg.nv * base.num_hmms) * base.omega
    soft = tv.soft_assignments(tilde_n, exps.log_omega, pair.ll_elbo)
    want = float(tv.elbo(post, exps, pair, *soft, hyps))
    np.testing.assert_allclose(
        trescore.elbo_f64(base, post, hyps, cfg.nv, cfg.tau), want,
        rtol=RTOL)
