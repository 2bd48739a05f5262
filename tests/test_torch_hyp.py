"""The port's hyperparameter-learning core (``vbhem_tpu_torch.hyp``) and the
two engines' hyp objectives against the JAX package on the same float64
inputs, made from a numpy seed (or by the JAX package) and handed over
through ``vbhem_tpu_torch.convert``.

  * ``pack``/``unpack``/``bound_vectors``/``transform_bounds`` of both
    registries at D=2 and D=3: equal to the JAX ones at 1e-12, the round
    trip exact to 1e-12;
  * ``lbfgs_box`` against the JAX ``lbfgs_box`` (optax's L-BFGS with its
    backtracking line search) on a box quadratic with an active bound,
    2-D Rosenbrock and an objective that is infinite on a half-plane,
    each alone and all as lanes of one batched call that stop at
    different steps: iterates, best values and step counts at 1e-10;
    the best-so-far iterate on an objective where the line search fails
    uphill (the monotone contract C2);
  * the VBEM objective and the VBHEM objective (plain and masked): value
    and theta-gradient equal to the JAX ``value_and_grad`` of the same
    composition at hyps0 and at a perturbed theta, to 1e-9 relative; the
    VBEM gradient held to the analytic oracle of tests/test_hyp.py;
  * SciPy's ``optimize_hyps`` on one VBEM solution against the JAX one at
    1e-6 relative;
  * C1 (``max_hyp_solutions`` below 1 raises) and C2 (degraded and
    degenerate lanes revert with their hyps);
  * per-lane hyps equal to broadcast unbatched hyps give bit-identical
    ``m_step``/``elbo`` in both engines;
  * a run of the hyp paths with jax, optax and the JAX package blocked.

The entry points with hyps on are held to the JAX package in
tests/test_torch_hyp_engines.py (VBEM) and tests/test_torch_hyp_vbhem.py
(VBHEM)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_hyp import reference_gradients
from tests.test_torch_vbhem import jax_bank
from tests.test_torch_vbhmm import subject
from vbhem_tpu import hyp as jhyp
from vbhem_tpu.config import HypBounds as JBounds
from vbhem_tpu.config import VBConfig as JVBConfig
from vbhem_tpu.config import VBHEMConfig as JConfig
from vbhem_tpu.models import vbhem as jvh
from vbhem_tpu.models import vbhmm as jvb
from vbhem_tpu_torch import VBConfig, VBHEMConfig, convert
from vbhem_tpu_torch import hyp as thyp
from vbhem_tpu_torch.config import HypBounds
from vbhem_tpu_torch.containers import tree_map
from vbhem_tpu_torch.models import vbhem as tvh
from vbhem_tpu_torch.models import vbhmm as tvb

REPO = Path(__file__).resolve().parent.parent
sg = jax.lax.stop_gradient


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def np_(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# ---------------------------------------------------------------------------
# the spec registry
# ---------------------------------------------------------------------------

REGISTRIES = {
    "vb": (jhyp.vb_specs, thyp.vb_specs, JVBConfig, VBConfig, jvb.VBHyps,
           tvb.VBHyps),
    "vbhem": (jhyp.vbhem_specs, thyp.vbhem_specs, JConfig, VBHEMConfig,
              jvh.VBHEMHyps, tvh.VBHEMHyps),
}


@pytest.mark.parametrize("engine", ["vb", "vbhem"])
@pytest.mark.parametrize("dim", [2, 3])
def test_pack_unpack_and_bounds_match_jax(engine, dim):
    jspecs_fn, tspecs_fn, JC, TC, JH, TH = REGISTRIES[engine]
    rng = np.random.default_rng(dim)
    kw = dict(w0=tuple(rng.uniform(0.5, 2.0, dim)), v0=dim + 2.5,
              alpha0=0.7, epsilon0=1.3)
    kw["mu0" if engine == "vb" else "m0"] = tuple(rng.normal(size=dim))
    jcfg, tcfg = JC(**kw), TC(**kw)
    jspecs = jspecs_fn(dim, JBounds(), jcfg.learn_hyps_keys)
    tspecs = tspecs_fn(dim, HypBounds(), tcfg.learn_hyps_keys)
    assert [s.name for s in tspecs] == [s.name for s in jspecs]
    assert "m0" in [s.name for s in tspecs]     # config key mu0 -> m0
    jh, th = JH.from_config(jcfg, dim), TH.from_config(tcfg, dim,
                                                       device="cpu")
    theta = thyp.pack(th, tspecs)
    np.testing.assert_allclose(theta, jhyp.pack(jh, jspecs), rtol=1e-12)
    for got, want in zip(thyp.bound_vectors(tspecs),
                         jhyp.bound_vectors(jspecs)):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    assert thyp.transform_bounds(tspecs) == pytest.approx(
        jhyp.transform_bounds(jspecs), rel=1e-12)
    # v0 -> log(v0 - D + 1)
    iv = [s.name for s in tspecs].index("v0")
    off = sum(s.size for s in tspecs[:iv])
    assert theta[off] == pytest.approx(np.log(dim + 2.5 - dim + 1.0),
                                       rel=1e-12)
    # the round trip, and unpack at a moved theta, one set and as lanes
    back = thyp.unpack(torch.as_tensor(theta), th, tspecs)
    for f in th._fields:
        np.testing.assert_allclose(np_(getattr(back, f)),
                                   np_(getattr(th, f)), rtol=1e-12)
    moved = theta + rng.normal(size=theta.shape) * 0.3
    want = jhyp.unpack(jnp.asarray(moved), jh, jspecs)
    lanes = thyp.unpack(torch.as_tensor(np.stack([theta, moved])), th,
                        tspecs)
    for f in th._fields:
        np.testing.assert_allclose(np_(getattr(lanes, f))[1],
                                   np.asarray(getattr(want, f)), rtol=1e-12)
        assert getattr(lanes, f).shape[:1] == (2,)


# ---------------------------------------------------------------------------
# lbfgs_box
# ---------------------------------------------------------------------------

def _quad(t, xp):
    return (t[..., 0] + 5.0) ** 2 + (t[..., 1] - 1.0) ** 2


def _rosen(t, xp):
    return (1 - t[..., 0]) ** 2 + 100 * (t[..., 1] - t[..., 0] ** 2) ** 2


def _half(t, xp):
    """Infinite on the half-plane t0 > 0.7, where the minimum lies."""
    inf = xp.full_like(t[..., 0], np.inf)
    return xp.where(t[..., 0] > 0.7, inf,
                    (t[..., 0] - 2.0) ** 2 + 3 * (t[..., 1] + 0.5) ** 2)


# (objective, lo, hi, start): the box quadratic of tests/test_hyp.py:141
# (its minimum outside the box, so a bound is active)
LBFGS_CASES = {"box_quadratic": (_quad, [-1.0, 0.5], [2.0, 3.0], [0.0, 0.0]),
               "rosenbrock": (_rosen, [-2.0, -2.0], [2.0, 2.0], [-1.2, 1.0]),
               "inf_half_plane": (_half, [-3.0, -3.0], [3.0, 3.0],
                                  [-1.0, 1.0])}


@pytest.fixture(scope="module")
def jax_lbfgs():
    out = {}
    for name, (f, lo, hi, x0) in LBFGS_CASES.items():
        th, v, it = jhyp.lbfgs_box(lambda t: f(t, jnp), jnp.asarray(x0),
                                   jnp.asarray(lo), jnp.asarray(hi),
                                   max_steps=50)
        out[name] = (np.asarray(th), float(v), int(it))
    return out


@pytest.mark.parametrize("name", list(LBFGS_CASES))
def test_lbfgs_box_matches_jax_alone(jax_lbfgs, name):
    f, lo, hi, x0 = LBFGS_CASES[name]
    th, v, it = thyp.lbfgs_box(lambda t, lanes: f(t, torch),
                               torch.tensor(x0, dtype=torch.float64),
                               np.asarray(lo), np.asarray(hi), max_steps=50)
    jth, jv_, jit = jax_lbfgs[name]
    np.testing.assert_allclose(th.numpy(), jth, rtol=1e-10, atol=1e-12)
    assert float(v) == pytest.approx(jv_, rel=1e-10)
    assert int(it) == jit
    assert np.all(th.numpy() >= lo) and np.all(th.numpy() <= hi)
    if name == "box_quadratic":
        np.testing.assert_allclose(th.numpy(), [-1.0, 1.0], atol=1e-6)


def test_lbfgs_box_lanes_match_jax():
    """The three problems as lanes of one batched call in one box, where
    they stop at different steps, each lane against the JAX function run
    alone in that box; every objective call after the first lane stops
    carries only the lanes still evaluating."""
    names = list(LBFGS_CASES)
    seen = []

    def fun(t, lanes):
        seen.append(lanes.tolist())
        return torch.stack([LBFGS_CASES[names[i]][0](row, torch)
                            for row, i in zip(t, lanes.tolist())])

    lo, hi = np.array([-1.0, -2.0]), np.array([2.0, 2.0])
    x0 = torch.tensor([LBFGS_CASES[n][3] for n in names],
                      dtype=torch.float64)
    th, v, it = thyp.lbfgs_box(fun, x0, lo, hi, max_steps=50)
    for i, n in enumerate(names):
        f = LBFGS_CASES[n][0]
        jth, jv_, jit = jhyp.lbfgs_box(lambda t: f(t, jnp),
                                       jnp.asarray(LBFGS_CASES[n][3]),
                                       jnp.asarray(lo), jnp.asarray(hi),
                                       max_steps=50)
        np.testing.assert_allclose(th[i].numpy(), np.asarray(jth),
                                   rtol=1e-10, atol=1e-12)
        assert float(v[i]) == pytest.approx(float(jv_), rel=1e-10)
        assert int(it[i]) == int(jit)
    assert len(set(it.tolist())) == 3, it
    assert max(map(len, seen)) == 3 and min(map(len, seen)) < 3


def _uphill(t, xp):
    """A wall at t0 = 0.5 that every probe of the first line search lands
    behind: the search fails, the step is taken uphill, and the best value
    stays the start's."""
    wall = xp.where(t[..., 0] > 0.5, xp.full_like(t[..., 0], 100.0),
                    xp.zeros_like(t[..., 0]))
    return (t[..., 0] - 3.0) ** 2 + wall


def test_lbfgs_box_keeps_the_best_iterate():
    """C2 at the optimizer: the final iterate (near t=3, value near 100) is
    worse than the start (6.5025); lbfgs_box returns the start, as the
    JAX function does."""
    lo, hi = np.array([-5.0]), np.array([5.0])
    th, v, it = thyp.lbfgs_box(lambda t, lanes: _uphill(t, torch),
                               torch.tensor([0.45], dtype=torch.float64),
                               lo, hi, max_steps=30)
    jth, jv_, jit = jhyp.lbfgs_box(lambda t: _uphill(t, jnp),
                                   jnp.asarray([0.45]), jnp.asarray(lo),
                                   jnp.asarray(hi), max_steps=30)
    assert float(v) == pytest.approx((0.45 - 3.0) ** 2, rel=1e-12)
    np.testing.assert_allclose(th.numpy(), [0.45], rtol=1e-12)
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=1e-10)
    assert float(v) == pytest.approx(float(jv_), rel=1e-10)
    assert int(it) == int(jit) > 1


# ---------------------------------------------------------------------------
# the objectives: value and theta-gradient against JAX
# ---------------------------------------------------------------------------

VB_CFG = dict(mu0=(1.5, 1.5), w0=1.0, max_iter=40)


@pytest.fixture(scope="module")
def vbem_problem():
    """A converged-ish VBEM solution of one subject (the JAX package's EM
    from its own random start) and the JAX value_and_grad of the objective
    theta -> -elbo at the fixed point."""
    tb, jb = subject(seed=11, n_seqs=10, t=30)
    jcfg = JVBConfig(**VB_CFG)
    jh = jvb.VBHyps.from_config(jcfg, 2)
    post0 = jvb.random_init(jax.random.key(2), jb, 2, jh)
    st = jvb.vbem_em(jb, post0, jh, max_iter=15)
    specs = jhyp.vb_specs(2, jcfg.bounds, jcfg.learn_hyps_keys)

    @jax.jit
    def vg(theta):
        def comp(th):
            hyps = jhyp.unpack(th, jh, specs)
            s = jvb.vbem_em(jb, st.post, sg(hyps), max_iter=jcfg.max_iter,
                            min_diff=jcfg.min_diff)
            post = sg(s.post)
            fb = jvb.e_step(jb, post)
            return -jvb.elbo(jb, post, fb, jvb.suff_stats(jb, fb), hyps)
        return jax.value_and_grad(comp)(theta)

    return dict(tb=tb, jb=jb, jh=jh, st=st, vg=vg,
                theta0=jhyp.pack(jh, specs))


def _port_value_grad(fun, th0, specs, theta):
    t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    v = fun(thyp.unpack(t[None], th0, specs), torch.tensor([0]))[0]
    (g,) = torch.autograd.grad(v, t)
    return float(v.detach()), g.numpy()


def test_vbem_objective_value_and_gradient_match_jax(vbem_problem):
    p = vbem_problem
    cfg = VBConfig(**VB_CFG)
    th0 = tvb.VBHyps.from_config(cfg, 2, device="cpu")
    specs = thyp.vb_specs(2, cfg.bounds, cfg.learn_hyps_keys)
    posts = tree_map(lambda a: a[None], to_port(p["st"].post))
    stats = {}
    fun = tvb.neg_elbo_objective(p["tb"], posts, cfg, stats=stats)
    rng = np.random.default_rng(4)
    for theta in (p["theta0"],
                  p["theta0"] + rng.normal(size=p["theta0"].shape) * 0.2):
        v, g = _port_value_grad(fun, th0, specs, theta)
        jv_, jg = p["vg"](jnp.asarray(theta))
        assert v == pytest.approx(float(jv_), rel=1e-9)
        np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-9,
                                   atol=1e-9 * np.abs(np.asarray(jg)).max())
    assert stats["e_steps"] == 2 and stats["em_iters"] >= 2


def test_vbem_gradient_matches_the_analytic_oracle(vbem_problem):
    """autograd of the port's bound at the JAX fixed point, in the hyps
    themselves, against the hand-derived formulas (`vbhmm_em_lb.m:261-324`)
    at the oracle test's tolerance (tests/test_hyp.py:74-90)."""
    p = vbem_problem
    post = to_port(p["st"].post)
    hyps = tree_map(lambda a: a.clone().requires_grad_(True),
                    to_port(p["jh"]))
    fb = tvb.e_step(p["tb"], post)
    v = -tvb.elbo(p["tb"], post, fb, tvb.suff_stats(p["tb"], fb), hyps)
    grads = torch.autograd.grad(v, list(hyps))
    got = dict(zip(hyps._fields, grads))
    ref = reference_gradients(p["jb"], p["st"], p["jh"])
    for f in ("alpha0", "epsilon0", "v0", "beta0", "w0", "m0"):
        np.testing.assert_allclose(-got[f].numpy(), ref[f], rtol=1e-6)


VBHEM_KW = dict(m0=(0.0, 0.0), w0=1.0, nv=10, tau=5, max_iter=30)
KMAX, SMAX = 3, 3


@pytest.fixture(scope="module")
def vbhem_problem():
    """A small bank, one plain (2, 2) start and one padded start of cell
    (2, 2) at (3, 3), and the JAX value_and_grad of both objectives."""
    jb = jax_bank(np.random.default_rng(5), 10, 2, 2)
    jcfg = JConfig(**VBHEM_KW)
    jh = jvh.VBHEMHyps.from_config(jcfg, 2)
    specs = jhyp.vbhem_specs(2, jcfg.bounds, jcfg.learn_hyps_keys)
    tilde_n = (jcfg.nv * jb.num_hmms) * jb.omega
    plain = jvh.init_baseem(jax.random.key(1), jb, 2, 2, jh, jcfg.nv)
    padded = jvh.init_baseem(jax.random.key(1), jb, KMAX, SMAX, jh, jcfg.nv)
    cm, sm = jnp.arange(KMAX) < 2, jnp.arange(SMAX) < 2
    kw = dict(nv=jcfg.nv, tau=jcfg.tau, max_iter=jcfg.max_iter,
              min_diff=jcfg.min_diff)

    @jax.jit
    def vg_plain(theta):
        def comp(th):
            hyps = jhyp.unpack(th, jh, specs)
            post = sg(jvh.vbhem_em(jb, plain, sg(hyps), **kw).post)
            exps = jvh.reduced_expectations(post)
            pair = jvh.e_step(jb, post, exps, jcfg.tau)
            soft = jvh.soft_assignments(tilde_n, exps.log_omega,
                                        pair.ll_elbo)
            return -jvh.elbo(post, exps, pair, *soft, hyps)
        return jax.value_and_grad(comp)(theta)

    @jax.jit
    def vg_masked(theta):
        def comp(th):
            hyps = jhyp.unpack(th, jh, specs)
            post = sg(jvh.vbhem_em_masked(jb, padded, sg(hyps), cmask=cm,
                                          smask=sm, **kw).post)
            exps = jvh.reduced_expectations_masked(post, cm, sm)
            pair = jvh.e_step(jb, post, exps, jcfg.tau)
            soft = jvh.soft_assignments(tilde_n, exps.log_omega,
                                        pair.ll_elbo)
            return -jvh.elbo_masked(post, exps, pair, *soft, hyps, cm, sm)
        return jax.value_and_grad(comp)(theta)

    return dict(jb=jb, jh=jh, plain=plain, padded=padded, cm=cm, sm=sm,
                vg={"plain": vg_plain, "masked": vg_masked},
                theta0=jhyp.pack(jh, specs))


@pytest.mark.parametrize("kind", ["plain", "masked"])
def test_vbhem_objective_value_and_gradient_match_jax(vbhem_problem, kind):
    p = vbhem_problem
    cfg = VBHEMConfig(**VBHEM_KW)
    th0 = tvh.VBHEMHyps.from_config(cfg, 2, device="cpu")
    specs = thyp.vbhem_specs(2, cfg.bounds, cfg.learn_hyps_keys)
    base = to_port(p["jb"])
    if kind == "plain":
        fun = tvh.neg_elbo_objective(base, to_port(tree_map(
            lambda a: a[None], p["plain"])), cfg)
    else:
        fun = tvh.neg_elbo_objective(
            base, to_port(tree_map(lambda a: a[None], p["padded"])), cfg,
            cmask=torch.tensor(np.asarray(p["cm"]))[None],
            smask=torch.tensor(np.asarray(p["sm"]))[None])
    rng = np.random.default_rng(6)
    for theta in (p["theta0"],
                  p["theta0"] + rng.normal(size=p["theta0"].shape) * 0.2):
        v, g = _port_value_grad(fun, th0, specs, theta)
        jv_, jg = p["vg"][kind](jnp.asarray(theta))
        assert v == pytest.approx(float(jv_), rel=1e-9)
        np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-9,
                                   atol=1e-9 * np.abs(np.asarray(jg)).max())


# SciPy's solve learns the keys the data determine, with EM run to a tight
# fixed point: with every key, alpha0 and epsilon0 drift along flat
# directions toward their bounds, where L-BFGS-B ends 'ABNORMAL' at points
# that differ at 1e-5 between any two float64 implementations
SCIPY_CFG = dict(VB_CFG, learn_hyps_keys=("beta0", "w0", "mu0"),
                 min_diff=1e-9, max_iter=400)


def test_optimize_hyps_scipy_matches_jax(vbem_problem):
    """SciPy's L-BFGS-B on one VBEM solution (``optimize_solution_hyps``):
    the learned hyps and the final bound agree with the JAX package's at
    1e-6 relative, and both converge."""
    p = vbem_problem
    jcfg, cfg = JVBConfig(**SCIPY_CFG), VBConfig(**SCIPY_CFG)
    jhy, jst, jinfo = jvb.optimize_solution_hyps(p["jb"], p["st"].post,
                                                 p["jh"], jcfg)
    th0 = tvb.VBHyps.from_config(cfg, 2, device="cpu")
    hy, st, info = tvb.optimize_solution_hyps(p["tb"], to_port(p["st"].post),
                                              th0, cfg)
    assert info["converged"] and jinfo["converged"]
    assert float(st.ll) == pytest.approx(float(jst.ll), rel=1e-6)
    assert float(st.ll) > float(p["st"].ll)
    for f in hy._fields:
        np.testing.assert_allclose(np_(getattr(hy, f)),
                                   np.asarray(getattr(jhy, f)), rtol=1e-6)


# ---------------------------------------------------------------------------
# C1 and C2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [VBConfig, VBHEMConfig])
def test_max_hyp_solutions_below_one_raises(cls):
    for n in (0, -1):
        with pytest.raises(ValueError, match="max_hyp_solutions"):
            cls(max_hyp_solutions=n)
    cfg = cls(max_hyp_solutions=1)
    with pytest.raises(ValueError, match="max_hyp_solutions"):
        dataclasses.replace(cfg, max_hyp_solutions=0)
    assert cls().max_hyp_solutions is None


def test_degraded_and_degenerate_lanes_revert_with_their_hyps():
    """The fallback's signatures (tests/test_hyp.py:244) on port tensors,
    and substitute_lanes putting hyps0 back on exactly those lanes."""
    pre_ll = np.array([-743e3, -743e3, -743e3, -743e3, -695169.0])
    post_ll = np.array([-741e3, 7.6e6, -30.4, np.nan, -698419.0])
    np.testing.assert_array_equal(thyp.degenerate_mask(pre_ll, post_ll),
                                  jhyp.degenerate_mask(pre_ll, post_ll))
    pre = tvb.EMState(post=None, ll=torch.as_tensor(pre_ll),
                      last_ll=None, it=torch.arange(5), gamma=torch.zeros(
                          5, 2, 3), stats=None, done=None)
    post = pre._replace(ll=torch.as_tensor(post_ll), it=-torch.arange(5),
                        gamma=torch.ones(5, 2, 3))
    out, n_bad, bad = thyp.fallback_degenerate_lanes(post, pre, pre.ll,
                                                     post.ll)
    np.testing.assert_array_equal(bad, [False, True, True, True, True])
    assert n_bad == 4
    np.testing.assert_array_equal(out.it.numpy(), [0, 1, 2, 3, 4])
    assert torch.equal(out.gamma[0], torch.ones(2, 3))
    assert torch.equal(out.gamma[1:], torch.zeros(4, 2, 3))
    h0 = tvb.VBHyps.from_config(VBConfig(mu0=(0.0, 0.0), w0=1.0), 2,
                                device="cpu")
    hb = tree_map(lambda a: (a * 2 + 1).expand((5,) + a.shape).clone(), h0)
    hs = thyp.substitute_lanes(hb, h0, bad)
    for f in h0._fields:
        assert torch.equal(getattr(hs, f)[0], getattr(hb, f)[0])
        for i in range(1, 5):
            assert torch.equal(getattr(hs, f)[i], getattr(h0, f))
    # within the tolerance max(1e-6 |pre|, 1e-3) a lane is kept
    _, n, _ = thyp.fallback_degenerate_lanes(
        pre, pre, np.array([-1000.0] * 5), np.array([-1000.0009] * 5))
    assert n == 0


def test_learn_reverts_a_degraded_lane_with_its_hyps(monkeypatch):
    """C2 through ``learn``: a lane whose optimized bound ends below its
    pre-optimization bound reverts to its restart solution, and its hyps
    to hyps0, so ``info['learned_hyps']`` matches the state kept."""
    tb, _ = subject(seed=5, n_seqs=8, t=20)
    cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=2, max_iter=30,
                   learn_hyps=True, hyp_max_steps=2)
    real = tvb.optimize_solution_hyps_batched

    def degrade(batch, init_posts, hyps0, config, per_lane_data=False,
                stats=None):
        hyps_b, sts = real(batch, init_posts, hyps0, config, per_lane_data,
                           stats)
        return hyps_b, sts._replace(ll=sts.ll - 1e6)   # every lane worse

    monkeypatch.setattr(tvb, "optimize_solution_hyps_batched", degrade)
    res, info = tvb.learn(torch.Generator().manual_seed(0), tb, 2, cfg)
    h0 = tvb.VBHyps.from_config(cfg, 2, device="cpu")
    assert info["hyp_reverted"] == info["hyp_lanes"] == 4
    for f in h0._fields:
        assert torch.equal(getattr(info["learned_hyps"], f), getattr(h0, f))
    assert float(res.ll) == pytest.approx(float(np.max(info["hyp_ll_pre"])),
                                          rel=1e-12)


# ---------------------------------------------------------------------------
# per-lane hyps: broadcast unbatched hyps give bit-identical results
# ---------------------------------------------------------------------------

def _lanes(h, n):
    return tree_map(lambda a: a.expand((n,) + a.shape).clone(), h)


def test_per_lane_hyps_bit_identical_vbem():
    tb, _ = subject(seed=3, n_seqs=6, t=15)
    cfg = VBConfig(mu0=(1.5, 1.5), w0=(0.7, 1.3))
    h = tvb.VBHyps.from_config(cfg, 2, device="cpu")
    post = tvb.random_init(torch.Generator().manual_seed(1), tb, 3, h,
                           lanes=(4,))
    fb = tvb.e_step(tb, post)
    stats = tvb.suff_stats(tb, fb)
    for covar_type in ("full", "diag"):
        a = tvb.m_step(stats, h, covar_type)
        b = tvb.m_step(stats, _lanes(h, 4), covar_type)
        for x, y in zip(a, b):
            for u, w in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert torch.equal(u, w)
    assert torch.equal(tvb.elbo(tb, post, fb, stats, h),
                       tvb.elbo(tb, post, fb, stats, _lanes(h, 4)))
    # one lane's own hyps change that lane only
    hl = _lanes(h, 4)._replace(alpha0=torch.tensor([0.1, 0.5, 0.1, 0.1],
                                                   dtype=torch.float64))
    ll = tvb.elbo(tb, post, fb, stats, hl)
    base = tvb.elbo(tb, post, fb, stats, h)
    assert torch.equal(ll[[0, 2, 3]], base[[0, 2, 3]]) and ll[1] != base[1]


def test_per_lane_hyps_bit_identical_vbhem():
    jb = jax_bank(np.random.default_rng(2), 8, 2, 2)
    base = to_port(jb)
    cfg = VBHEMConfig(m0=(0.5, -0.5), w0=(0.8, 1.2), nv=10, tau=5)
    h = tvh.VBHEMHyps.from_config(cfg, 2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    post = tvh.init_baseem(gen, base, KMAX, SMAX, h, cfg.nv, lanes=(3,))
    cm = torch.tensor([[True, True, False], [True, True, True],
                       [True, False, False]])
    sm = torch.tensor([[True, True, False], [True, True, True],
                       [True, True, True]])
    tilde_n = (cfg.nv * base.num_hmms) * base.omega
    for masks in ((None, None), (cm, sm)):
        exps = tvh.reduced_expectations(post, *masks)
        pair = tvh.e_step(base, post, exps, cfg.tau)
        soft = tvh.soft_assignments(tilde_n, exps.log_omega, pair.ll_elbo)
        stats = tvh.aggregate_stats(base, pair, soft[1], soft[2])
        a = tvh.elbo(post, exps, pair, *soft, h, *masks)
        b = tvh.elbo(post, exps, pair, *soft, _lanes(h, 3), *masks)
        assert torch.equal(a, b)
        for x, y in zip(tvh.m_step(stats, h), tvh.m_step(stats,
                                                         _lanes(h, 3))):
            for u, w in zip(x if isinstance(x, tuple) else (x,),
                            y if isinstance(y, tuple) else (y,)):
                assert torch.equal(u, w)


# ---------------------------------------------------------------------------
# the hyp paths with jax blocked
# ---------------------------------------------------------------------------

def test_hyp_paths_run_with_jax_blocked():
    """A tiny learn_bank and cluster_batched with hyps on import and run
    with jax, optax and the JAX package blocked (as on the machine with
    the card)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'optax', 'vbhem_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from vbhem_tpu_torch import VBConfig, VBHEMConfig, hyp\n"
        "from vbhem_tpu_torch.models import batch, vbhem\n"
        "from vbhem_tpu_torch.experiments import synthetic\n"
        "from vbhem_tpu_torch.utils.planted import synthetic_subjects\n"
        "bs, lab = synthetic_subjects(2, n_seqs=4, t=12, device='cpu',\n"
        "                             dtype=torch.float32)\n"
        "cfg = VBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=2, max_iter=8,\n"
        "               learn_hyps=True, hyp_max_steps=2)\n"
        "res = synthetic.learn_subject_hmms(torch.Generator(), bs, 2, cfg)\n"
        "base = vbhem.h3m_from_results(res, device='cpu')\n"
        "vcfg = VBHEMConfig(trials=2, nv=10, tau=3, max_iter=5,\n"
        "                   initmode='baseem', m0=(1.5, 1.5), w0=1.0,\n"
        "                   hyp_max_steps=2, max_hyp_solutions=1)\n"
        "r, info = vbhem.cluster_batched(torch.Generator(), base, [1, 2],\n"
        "                                [1, 2], vcfg)\n"
        "assert vcfg.learn_hyps and info['hyp']['hyp_lanes'] == 16\n"
        "assert synthetic.default_vb_config().learn_hyps\n"
        "print(len(res), sorted(info['model_hyps']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "4"
