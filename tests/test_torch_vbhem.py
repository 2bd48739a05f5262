"""The port's VBHEM main path against the JAX package on the same float64
inputs, made from a numpy seed and handed to both packages through
``vbhem_tpu_torch.convert``: each function of the EM iteration at rtol
1e-10, the lane-batched EM loop against ``jax.vmap(vbhem_em)`` (the same
per-lane iteration count, ll at rtol 1e-9, posterior at 1e-8), the ELBO
trace, the (K, S) sweep on a small planted bank, and the pruning
helpers.  The two packages draw different random restarts, so the sweep
compares the selection, not the trials."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu.config import VBHEMConfig as JConfig
from vbhem_tpu import containers as jc
from vbhem_tpu.models import vbhem as jv
from vbhem_tpu.utils.metrics import rand_index
from vbhem_tpu_torch import VBHEMConfig
from vbhem_tpu_torch import containers as tc
from vbhem_tpu_torch import convert
from vbhem_tpu_torch.models import vbhem as tv
from vbhem_tpu_torch.utils import planted

RTOL = 1e-10


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def assert_tree_close(got, want, rtol=RTOL, atol=0.0):
    g, w = convert.to_numpy(got), want
    if isinstance(w, tuple) and hasattr(w, "_fields"):
        assert tuple(g._fields) == tuple(w._fields)
        for f in w._fields:
            assert_tree_close(getattr(g, f), getattr(w, f), rtol, atol)
    elif w is not None:
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


def jax_bank(rng, kb, sb, d):
    mean = rng.normal(size=(kb, sb, d)) * 3.0
    a = rng.normal(size=(kb, sb, d, d)) * 0.3
    cov = np.einsum("ksde,ksfe->ksdf", a, a) + np.eye(d)
    return jc.H3M(omega=jnp.full((kb,), 1.0 / kb),
                  hmm=jc.HMM(prior=jnp.asarray(rng.dirichlet(np.ones(sb), kb)),
                             trans=jnp.asarray(
                                 rng.dirichlet(np.ones(sb), (kb, sb))),
                             mean=jnp.asarray(mean), cov=jnp.asarray(cov)),
                  state_mask=jnp.ones((kb, sb), bool))


@pytest.fixture(scope="module", params=[2, 1], ids=["sr2", "sr1"])
def problem(request):
    """One EM iteration's inputs and the JAX package's intermediates."""
    sr = request.param
    kb, sb, kr, d, tau = 10, 3, 3, 2, 4
    jb = jax_bank(np.random.default_rng(sr), kb, sb, d)
    cfg = JConfig(m0=(0.5, -0.5), w0=0.5, nv=20, tau=tau)
    jh = jv.VBHEMHyps.from_config(cfg, d)
    jpost = jv.init_baseem(jax.random.key(sr), jb, kr, sr, jh, cfg.nv)
    tilde_n = (cfg.nv * kb) * jb.omega
    exps = jv.reduced_expectations(jpost)
    pair = jv.e_step(jb, jpost, exps, tau)
    hat_z, z_ni, nj = jv.soft_assignments(tilde_n, exps.log_omega,
                                          pair.ll_elbo)
    return dict(jb=jb, jh=jh, jpost=jpost, tilde_n=tilde_n, exps=exps,
                pair=pair, soft=(hat_z, z_ni, nj), tau=tau, cfg=cfg,
                tb=to_port(jb), th=to_port(jh),
                tpost=to_port(jpost))


def test_reduced_expectations_and_e_step(problem):
    p = problem
    exps = tv.reduced_expectations(p["tpost"])
    assert_tree_close(exps, p["exps"])
    pair = tv.e_step(p["tb"], p["tpost"], to_port(p["exps"]),
                     p["tau"])
    assert_tree_close(pair, p["pair"], atol=1e-13)


def test_soft_assignments(problem):
    p = problem
    got = tv.soft_assignments(to_port(p["tilde_n"]),
                              to_port(p["exps"].log_omega),
                              to_port(p["pair"].ll_elbo))
    for g, w in zip(got, p["soft"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_aggregate_stats(problem):
    p = problem
    hat_z, z_ni, nj = p["soft"]
    want = jv.aggregate_stats(p["jb"], p["pair"], z_ni, nj)
    got = tv.aggregate_stats(p["tb"], to_port(p["pair"]),
                             to_port(z_ni), to_port(nj))
    assert_tree_close(got, want, atol=1e-12)
    if p["jpost"].num_states == 1:
        assert np.all(got.nj_rho2rho.numpy() == 1e-12)


@pytest.mark.parametrize("covar_type", ["full", "diag"])
def test_m_step(problem, covar_type):
    p = problem
    hat_z, z_ni, nj = p["soft"]
    stats = jv.aggregate_stats(p["jb"], p["pair"], z_ni, nj)
    want = jv.m_step(stats, p["jh"], covar_type)
    got = tv.m_step(to_port(stats), p["th"], covar_type)
    assert_tree_close(got, want, atol=1e-14)


def test_elbo(problem):
    p = problem
    hat_z, z_ni, nj = p["soft"]
    want = jv.elbo(p["jpost"], p["exps"], p["pair"], hat_z, z_ni, nj,
                   p["jh"])
    got = tv.elbo(p["tpost"], to_port(p["exps"]),
                  to_port(p["pair"]), *map(to_port,
                                                   (hat_z, z_ni, nj)),
                  p["th"])
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_vbhem_em_lanes_match_jax_vmap():
    """Four restart lanes from JAX-made baseem posteriors: the port's
    lane-batched loop (done lanes frozen) against jax.vmap(vbhem_em)."""
    kb, sb, kr, sr, d = 12, 3, 3, 2, 2
    jb = jax_bank(np.random.default_rng(11), kb, sb, d)
    cfg = JConfig(m0=(0.0, 0.0), w0=1.0, nv=10, tau=5)
    jh = jv.VBHEMHyps.from_config(cfg, d)
    posts = jax.vmap(lambda k: jv.init_baseem(k, jb, kr, sr, jh, cfg.nv))(
        jax.random.split(jax.random.key(0), 4))
    want = jax.vmap(lambda q: jv.vbhem_em(jb, q, jh, nv=cfg.nv, tau=cfg.tau,
                                          max_iter=30))(posts)
    got = tv.vbhem_em(to_port(jb), to_port(posts),
                      to_port(jh), nv=cfg.nv, tau=cfg.tau,
                      max_iter=30)
    it = np.asarray(want.it)
    assert len(set(it.tolist())) > 1      # lanes finish at different times
    np.testing.assert_array_equal(got.it.numpy(), it)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_allclose(got.ll.numpy(), np.asarray(want.ll), rtol=1e-9)
    np.testing.assert_allclose(got.last_ll.numpy(), np.asarray(want.last_ll),
                               rtol=1e-9)
    assert_tree_close(got.post, want.post, rtol=1e-8, atol=1e-12)
    # the count statistics; y_bar and s_plus_c divide by a near-zero
    # count for an empty state, where summation order alone moves them
    for f in ("nj", "nj_rho1", "nj_rho2rho", "nj_rho"):
        np.testing.assert_allclose(getattr(got.stats, f).numpy(),
                                   np.asarray(getattr(want.stats, f)),
                                   rtol=1e-8, atol=1e-10, err_msg=f)
    np.testing.assert_allclose(got.hat_z.numpy(), np.asarray(want.hat_z),
                               rtol=1e-8, atol=1e-12)


def test_em_trace_elbo_never_decreases():
    kb, sb, d = 12, 3, 2
    jb = jax_bank(np.random.default_rng(12), kb, sb, d)
    cfg = JConfig(m0=(0.0, 0.0), w0=1.0, nv=10, tau=5)
    jh = jv.VBHEMHyps.from_config(cfg, d)
    jpost = jv.init_baseem(jax.random.key(5), jb, 2, 2, jh, cfg.nv)
    _, want = jv.em_trace(jb, jpost, jh, cfg.nv, cfg.tau, n_iter=25)
    post, lls = tv.em_trace(to_port(jb), to_port(jpost),
                            to_port(jh), cfg.nv, cfg.tau, n_iter=25)
    lls = lls.numpy()
    np.testing.assert_allclose(lls, np.asarray(want), rtol=1e-9)
    assert np.all(np.diff(lls) >= -1e-9 * np.abs(lls[:-1])), lls
    assert isinstance(post, tc.H3MPosterior)


def test_cluster_planted_bank_matches_jax_selection():
    """Two planted groups of base HMMs (``planted.planted_bank`` at
    Kb=24, the bank chip_smoke.py clusters at Kb=8192).  A restart
    reaches the best K=2 optimum in about a quarter of the runs (the
    rest split a group's states poorly, with the labels still right), so
    16 restarts per cell keep the selection stable."""
    kb = 24
    base, labels = planted.planted_bank(kb, torch.device("cpu"),
                                        torch.float64, seed=4)
    kw = dict(trials=16, learn_hyps=False, initmode="baseem", nv=100,
              tau=5, m0=(13.0, 10.0), w0=1.0, max_iter=60)
    res, info = tv.cluster(torch.Generator().manual_seed(0), base,
                           [1, 2, 3], 2, VBHEMConfig(**kw))
    jres, jinfo = jv.cluster(jax.random.key(0), _jax_h3m(base), [1, 2, 3],
                             2, JConfig(**kw))
    assert info["model_best_k"] == jinfo["model_best_k"] == 2, (
        info["model_ll"], jinfo["model_ll"])
    assert rand_index(res.label.numpy(), labels)[1] == pytest.approx(1.0)
    assert rand_index(np.asarray(jres.label), labels)[1] == pytest.approx(1.0)
    assert set(info["model_all"]) == {(1, 2), (2, 2), (3, 2)}
    assert all(n >= 1 for n in info["model_em_iters"].values())
    assert np.all(np.isfinite(info["model_ll"]))


def test_planted_rand_index_matches_jax():
    rng = np.random.default_rng(31)
    for a, b in (([0, 0, 1, 1], [1, 1, 0, 0]), ([0, 1, 0, 1], [0, 0, 1, 1]),
                 (rng.integers(0, 3, 40), rng.integers(0, 4, 40))):
        assert planted.rand_index(a, b) == pytest.approx(
            rand_index(np.asarray(a), np.asarray(b))[1], rel=1e-12)


def _jax_h3m(base):
    n = convert.to_numpy(base)
    return jc.H3M(omega=jnp.asarray(n.omega),
                  hmm=jc.HMM(*map(jnp.asarray, n.hmm)),
                  state_mask=jnp.asarray(n.state_mask))


def test_cluster_rejects_what_is_not_ported():
    """Every initmode is ported now; the JAX package's contract stays:
    'auto' is a ValueError in the single-mode worker, and an unknown mode
    is one in the front-end too."""
    base, _ = planted.planted_bank(8, torch.device("cpu"), torch.float64)
    gen = torch.Generator().manual_seed(0)
    cfg = VBHEMConfig(learn_hyps=False)
    assert cfg.initmode == "auto"
    with pytest.raises(ValueError, match="front-end"):
        tv.fit_single_ks(gen, base, 2, 2, cfg)
    with pytest.raises(ValueError, match="unknown initmode"):
        tv.cluster(gen, base, 2, 2,
                   VBHEMConfig(learn_hyps=False, initmode="nope"))
    with pytest.raises(ValueError, match="unknown initmode"):
        tv.resolve_initmode("nope")


def _jax_result(rng, kb, kr, sr, d):
    a = rng.normal(size=(kr, sr, d, d))
    post = jc.H3MPosterior(
        alpha=jnp.asarray(rng.uniform(1, 9, kr)),
        eta=jnp.asarray(rng.uniform(1, 9, (kr, sr))),
        epsilon=jnp.asarray(rng.uniform(0.5, 9, (kr, sr, sr))),
        niw=jc.NIW(beta=jnp.asarray(rng.uniform(1, 9, (kr, sr))),
                   v=jnp.asarray(rng.uniform(4, 9, (kr, sr))),
                   m=jnp.asarray(rng.normal(size=(kr, sr, d))),
                   w=jnp.asarray(np.einsum("...de,...fe->...df", a, a)
                                 + np.eye(d))))
    hat_z = rng.dirichlet(np.ones(kr), kb)
    counts = rng.uniform(0, 5, (kr, sr))
    counts[0, 1] = 1e-4                   # a state below state_thresh
    counts[2, :] = 1e-5                   # a cluster with no live state
    nj = np.array([5.0, 0.5, 3.0, 2.0])[:kr]
    return jv.VBHEMResult(
        post=post, h3m=post.to_h3m(), ll=jnp.asarray(-12.5),
        hat_z=jnp.asarray(hat_z), ll_elbo=jnp.asarray(rng.normal(size=(kb, kr))),
        nj=jnp.asarray(nj), label=jnp.argmax(jnp.asarray(hat_z), -1),
        counts_n1=jnp.asarray(rng.uniform(0, 1, (kr, sr))),
        counts=jnp.asarray(counts),
        trans_counts=jnp.asarray(rng.uniform(0, 1, (kr, sr, sr))))


def test_remove_empty_clusters_and_to_hmm_list():
    jres = _jax_result(np.random.default_rng(21), 9, 4, 3, 2)
    tres = to_port(jres)
    want = jv.remove_empty_clusters(jres, cluster_thresh=1.0)
    got = tv.remove_empty_clusters(tres, cluster_thresh=1.0)
    assert got.nj.shape == (3,)
    assert_tree_close(got, want, rtol=1e-12)
    assert tv.remove_empty_clusters(tres, cluster_thresh=0.1) is tres
    for g, w in zip(tv.to_hmm_list(tres), jv.to_hmm_list(jres)):
        assert_tree_close(g, w, rtol=1e-12)
    assert [h.num_states for h in tv.to_hmm_list(tres)] == [2, 3, 1, 3]


def test_select_best_trial_finalize_and_groups():
    jres = _jax_result(np.random.default_rng(22), 6, 3, 2, 2)
    st = tv.VBHEMState(
        post=tv.stack_lanes([to_port(jres.post)] * 3),
        ll=torch.tensor([-3.0, -1.0, -2.0], dtype=torch.float64),
        last_ll=torch.zeros(3, dtype=torch.float64),
        it=torch.tensor([4, 5, 6]), hat_z=to_port(
            np.stack([np.asarray(jres.hat_z)] * 3)),
        ll_elbo=to_port(np.stack([np.asarray(jres.ll_elbo)] * 3)),
        stats=tv.ClusterStats(*[torch.stack([x] * 3) for x in (
            to_port(jres.nj), to_port(jres.counts_n1),
            to_port(jres.trans_counts), to_port(jres.counts),
            torch.zeros(3, 2, 2, dtype=torch.float64),
            torch.zeros(3, 2, 2, 2, dtype=torch.float64))]),
        done=torch.ones(3, dtype=torch.bool))
    best = tv.select_best_trial(st)
    assert int(best.it) == 5 and float(best.ll) == -1.0
    res = tv.finalize(best)
    np.testing.assert_array_equal(res.label.numpy(), np.asarray(jres.label))
    assert sum(len(g) for g in res.groups) == 6


def test_h3m_from_results_and_hmms():
    rng = np.random.default_rng(23)
    results = []
    for s in (2, 3, 2):
        a = rng.normal(size=(s, 2, 2))
        post = jc.HMMPosterior(
            alpha=jnp.asarray(rng.uniform(1, 9, s)),
            epsilon=jnp.asarray(rng.uniform(0.5, 9, (s, s))),
            niw=jc.NIW(beta=jnp.asarray(rng.uniform(1, 9, s)),
                       v=jnp.asarray(rng.uniform(4, 9, s)),
                       m=jnp.asarray(rng.normal(size=(s, 2))),
                       w=jnp.asarray(np.einsum("...de,...fe->...df", a, a)
                                     + np.eye(2))))
        results.append(jc.VBHMMResult(
            post=post, model=post.to_point(), ll=jnp.asarray(0.0),
            gamma=jnp.zeros((1, 1, s)), counts_n1=jnp.ones(s),
            counts=jnp.ones(s), trans_counts=jnp.ones((s, s))))
    tres = [to_port(r) for r in results]
    for kw in (dict(), dict(use_post=False), dict(covar_type="diag")):
        assert_tree_close(tv.h3m_from_results(tres, device="cpu", **kw),
                          jv.h3m_from_results(results, **kw), rtol=1e-12)
    hmms = [r.model for r in results]
    assert_tree_close(tv.h3m_from_hmms([to_port(h) for h in hmms],
                                       device="cpu"),
                      jv.h3m_from_hmms(hmms), rtol=1e-12)
    # a bank of one state count is stacked on the device in one pass
    uniform = [r for r in results if r.post.alpha.shape == (2,)]
    for kw in (dict(), dict(use_post=False), dict(covar_type="diag"),
               dict(dtype=np.float32)):
        got = tv.h3m_from_results([to_port(r) for r in uniform],
                                  device="cpu", **kw)
        assert_tree_close(got, jv.h3m_from_results(uniform, **kw),
                          rtol=1e-6 if kw.get("dtype") else 1e-12)
        assert got.state_mask.dtype == torch.bool
    cfg = dataclasses.replace(VBHEMConfig(), w0=(0.5, 2.0))
    h = tv.VBHEMHyps.from_config(cfg, 2, device="cpu")
    assert_tree_close(h, jv.VBHEMHyps.from_config(
        dataclasses.replace(JConfig(), w0=(0.5, 2.0)), 2), rtol=0)
