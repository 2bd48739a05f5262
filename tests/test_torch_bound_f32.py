"""The float32 bounds of the three EM engines (VBHEM, VBEM, grouped VBEM)
against the JAX package's float64 bounds on the same values, under the
hyperparameters that empirical Bayes reaches (the L-BFGS box runs to e^30
for alpha0, eta0, epsilon0, lambda0 and w0, to 1e4 for v0), and the
float32 VBHEM loop's stopping test at epsilon0 = 1e8 against
``jax.vmap(vbhem_em)`` in float64.

Every input is made in float64 from a numpy seed (a posterior is the JAX
package's M-step of random statistics), then rounded to float32: the JAX
package gets the rounded values in float64, the port the same values in
float32, so only the port's float32 arithmetic separates the two.  The
prior and posterior Dirichlet constants are lgamma differences of numbers
up to 6e14, and (eps0 - 1) sum E[log A] multiplies E[log A] by e^30:
evaluated in float32 on this file's data the VBHEM bound is 5.3e4 nats
(6%) off at eps0 = 1e10 and lt6 alone 5.9e7 at alpha0 = e^30, so the
port evaluates them in float64 and keeps float32 only in the data terms.

Tolerance: the bound within 1e-6 of |bound| (each case's bound is about
-1e6 for VBHEM, -4e3 for VBEM): the data terms' float32 products, about
6e-8 each, and the float64 rounding of lgamma near 6e14 (a few ulp of
0.125, on both sides) stay below it; each of the ten VBHEM terms within
the same 1e-6 of |bound| of its float64 value.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu import containers as jc
from vbhem_tpu.config import VBConfig as JVBConfig
from vbhem_tpu.config import VBHEMConfig as JConfig
from vbhem_tpu.models import vbhem as jv
from vbhem_tpu.models import vbhmm as jvb
from vbhem_tpu.models import vbhmm_groups as jg
from vbhem_tpu.ops.fb import FBStats as JFBStats
from vbhem_tpu.ops.pair_estep import PairStats as JPairStats
from vbhem_tpu_torch import convert
from vbhem_tpu_torch.models import vbhem as tv
from vbhem_tpu_torch.models import vbhmm as tvb
from vbhem_tpu_torch.models import vbhmm_groups as tg

RTOL = 1e-6
E30 = math.exp(30.0)
BIG = (1e6, 1e10, E30)


def cases(names):
    """One case a hyperparameter: each of ``names`` at each value of BIG,
    v0 at 1e4 and w0 at e^30."""
    out = [(n, v) for n in names for v in BIG]
    return out + [("v0", 1e4), ("w0", E30)]


def case_id(c):
    return f"{c[0]}={c[1]:.3g}"


def rounded(tree):
    """``tree`` with its floating leaves rounded to float32, in float64."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def f32(tree):
    return convert.to_torch(tree, device="cpu", dtype=torch.float32)


def f64(tree):
    return convert.to_torch(tree, device="cpu", dtype=torch.float64)


def spd(rng, shape, d):
    a = rng.normal(size=shape + (d, d)) * 0.3
    return np.einsum("...de,...fe->...df", a, a) + np.eye(d)


def assert_bound(got, want, what):
    err = abs(float(got) - float(want))
    assert err <= RTOL * abs(float(want)), (
        f"{what}: float32 {float(got)!r} against float64 {float(want)!r}, "
        f"gap {err:.4g} > {RTOL:.0e} x |bound|")


# ---------------------------------------------------------------------------
# VBHEM: elbo_masked on a padded (3, 3) lane whose active cell is (2, 2)
# ---------------------------------------------------------------------------

KB, KMAX, SMAX, D, NV, TAU = 40, 3, 3, 2, 100, 50
CMASK = np.array([True, True, False])
SMASK = np.array([True, True, False])


@pytest.fixture(scope="module")
def vbhem_data():
    """Random cluster statistics, the pair bound ll_elbo and the soft
    assignments, all rounded to float32 values."""
    rng = np.random.default_rng(7)
    ll_elbo = -rng.uniform(150.0, 400.0, (KB, KMAX))
    nj = rng.uniform(1000.0, 3000.0, KMAX)
    stats = jv.ClusterStats(
        nj=jnp.asarray(nj),
        nj_rho1=jnp.asarray(nj[:, None] * rng.dirichlet(np.ones(SMAX), KMAX)),
        nj_rho2rho=jnp.asarray(nj[:, None, None] * (TAU - 1) * rng.dirichlet(
            np.ones(SMAX * SMAX), KMAX).reshape(KMAX, SMAX, SMAX)),
        nj_rho=jnp.asarray(nj[:, None] * TAU * rng.dirichlet(np.ones(SMAX),
                                                             KMAX)),
        y_bar=jnp.asarray(rng.normal(size=(KMAX, SMAX, D)) * 3.0),
        s_plus_c=jnp.asarray(spd(rng, (KMAX, SMAX), D)))
    return rounded(stats), jnp.asarray(np.float32(ll_elbo), jnp.float64)


def vbhem_inputs(vbhem_data, name, value):
    """(JAX float64 inputs, port float32 inputs) of elbo_masked: the
    posterior is the M-step of the statistics under the case's hyps."""
    stats, ll_elbo = vbhem_data
    jh = jv.VBHEMHyps.from_config(JConfig(m0=(0.5, -0.5), w0=0.5, nv=NV,
                                          tau=TAU), D)
    val = jnp.full_like(jh.w0, value) if name == "w0" else jnp.asarray(value)
    jh = rounded(jh._replace(**{name: val}))
    post = rounded(jv.m_step(stats, jh))
    cm, sm = jnp.asarray(CMASK), jnp.asarray(SMASK)
    exps = jv.reduced_expectations_masked(post, cm, sm)
    # the soft assignments as a float32 run forms them (hat_z floored at
    # float32's smallest normal, so that hat_z log hat_z stays finite)
    soft = tv.soft_assignments(
        torch.full((KB,), float(NV)),
        tv.reduced_expectations(f32(post), torch.as_tensor(CMASK),
                                torch.as_tensor(SMASK)).log_omega,
        f32(ll_elbo))
    soft = tuple(jnp.asarray(a.double().numpy()) for a in soft)
    zeros = jnp.zeros(())
    pair = JPairStats(ll_elbo=ll_elbo, nu_1=zeros, sum_xi=zeros,
                      sum_t_nu=zeros)
    want = jax.jit(jv.elbo_masked)(post, exps, pair, *soft, jh, cm, sm)
    return dict(want=want, post=post, pair=pair, soft=soft, hyps=jh)


@pytest.mark.parametrize("case", cases(("alpha0", "eta0", "epsilon0",
                                        "lambda0")), ids=case_id)
def test_vbhem_f32_bound_matches_jax_f64(vbhem_data, case):
    p = vbhem_inputs(vbhem_data, *case)
    cm, sm = torch.as_tensor(CMASK), torch.as_tensor(SMASK)
    post32 = f32(p["post"])
    exps32 = tv.reduced_expectations(post32, cm, sm)
    pair32 = tv.PairStats(*[convert.to_torch(a, "cpu", torch.float32)
                            for a in p["pair"]])
    got, terms = tv.elbo(post32, exps32, pair32, *map(f32, p["soft"]),
                         f32(p["hyps"]), cm, sm, return_terms=True)
    assert got.dtype == torch.float32
    assert_bound(got, p["want"], "bound")
    # the port's float64 terms of the same values, held to the JAX bound
    post64 = f64(p["post"])
    pair64 = tv.PairStats(*[convert.to_torch(a, "cpu", torch.float64)
                            for a in p["pair"]])
    want64, terms64 = tv.elbo(post64, tv.reduced_expectations(post64, cm, sm),
                              pair64, *map(f64, p["soft"]), f64(p["hyps"]),
                              cm, sm, return_terms=True)
    np.testing.assert_allclose(float(want64), float(p["want"]), rtol=2e-9)
    for k, t in terms.items():
        err = abs(float(t) - float(terms64[k]))
        assert err <= RTOL * abs(float(want64)), (
            f"{k}: float32 run {float(t)!r} against float64 "
            f"{float(terms64[k])!r}")


# ---------------------------------------------------------------------------
# VBEM and grouped VBEM: 25 sequences of T=50, K=2
# ---------------------------------------------------------------------------

N, T, K, G = 25, 50, 2, 2


@pytest.fixture(scope="module")
def vbem_data():
    """A batch and random E-step outputs, rounded to float32 values."""
    rng = np.random.default_rng(8)
    batch = jc.SeqBatch(x=jnp.asarray(rng.normal(size=(N, T, D)) * 2.0),
                        lengths=jnp.full((N,), T, jnp.int32))
    fb = JFBStats(
        log_rho=jnp.asarray(-rng.uniform(1.5, 8.0, (N, T, K))),
        gamma=jnp.asarray(rng.dirichlet(np.ones(K), (N, T))),
        xi_sum=jnp.asarray((T - 1) * rng.dirichlet(np.ones(K * K), N)
                           .reshape(N, K, K)),
        phi_norm=jnp.asarray(-rng.uniform(100.0, 200.0, N)))
    return rounded(batch), rounded(fb)


def vb_hyps(name, value):
    jh = jvb.VBHyps.from_config(JVBConfig(mu0=(0.5, -0.5), w0=0.5), D)
    val = jnp.full_like(jh.w0, value) if name == "w0" else jnp.asarray(value)
    return rounded(jh._replace(**{name: val}))


@pytest.mark.parametrize("case", cases(("alpha0", "epsilon0", "beta0")),
                         ids=case_id)
def test_vbem_f32_bound_matches_jax_f64(vbem_data, case):
    batch, fb = vbem_data
    jh = vb_hyps(*case)
    stats = rounded(jvb.suff_stats(batch, fb))
    post = rounded(jvb.m_step(stats, jh))
    want = jax.jit(jvb.elbo)(batch, post, fb, stats, jh)
    got = tvb.elbo(f32(batch), f32(post), f32(fb), f32(stats), f32(jh))
    assert got.dtype == torch.float32
    assert_bound(got, want, "bound")


@pytest.mark.parametrize("case", cases(("alpha0", "epsilon0", "beta0")),
                         ids=case_id)
def test_grouped_f32_bound_matches_jax_f64(vbem_data, case):
    batch, fb = vbem_data
    jh = vb_hyps(*case)
    group_map = jnp.arange(N) % G
    stats = rounded(jg.grouped_stats(batch, fb, group_map, G))
    post = rounded(jg.m_step(stats, jh))
    want = jax.jit(jg.elbo)(batch, post, fb, stats, jh)
    tstats = tg.GroupedStats(shared=f32(stats.shared),
                             nk1_g=f32(stats.nk1_g), m_g=f32(stats.m_g))
    tpost = tg.GroupedPosterior(alpha=f32(post.alpha),
                                epsilon=f32(post.epsilon), niw=f32(post.niw))
    got = tg.elbo(f32(batch), tpost, f32(fb), tstats, f32(jh))
    assert got.dtype == torch.float32
    assert_bound(got, want, "bound")


# ---------------------------------------------------------------------------
# The stopping test: float32 lanes stop where float64 lanes do
# ---------------------------------------------------------------------------

def jax_bank(rng, kb, sb, d):
    mean = rng.normal(size=(kb, sb, d)) * 3.0
    cov = spd(rng, (kb, sb), d)
    return jc.H3M(omega=jnp.full((kb,), 1.0 / kb),
                  hmm=jc.HMM(prior=jnp.asarray(rng.dirichlet(np.ones(sb), kb)),
                             trans=jnp.asarray(
                                 rng.dirichlet(np.ones(sb), (kb, sb))),
                             mean=jnp.asarray(mean), cov=jnp.asarray(cov)),
                  state_mask=jnp.ones((kb, sb), bool))


def test_f32_em_stops_where_f64_does():
    """Six baseem lanes at eps0 = 1e8 (Kb=20, Kr=Sr=2, Nv=100, tau=10):
    the port's float32 vbhem_em against jax.vmap(vbhem_em) in float64 from
    the same (float32-rounded) starts.  Every lane must stop by its
    convergence test before max_iter, within one iteration of the float64
    lane (they agree on every lane of this seed; one iteration leaves room
    for a float32 summation order that flips one test), with its bound
    within 1e-5 of the float64 lane's.  Before the float64 prior terms the
    float32 lanes' bounds moved by up to 8e-4 relative an iteration from
    rounding alone, and ended 1e-3 to 6e-3 off."""
    kb, sb, kr, sr, d, nv, tau, lanes, max_iter = 20, 2, 2, 2, 2, 100, 10, \
        6, 100
    jb = rounded(jax_bank(np.random.default_rng(3), kb, sb, d))
    jh = rounded(jv.VBHEMHyps.from_config(
        JConfig(m0=(0.0, 0.0), w0=1.0, nv=nv, tau=tau, epsilon0=1e8), d))
    keys = jax.random.split(jax.random.key(0), lanes)
    posts = rounded(jax.jit(jax.vmap(
        lambda k: jv.init_baseem(k, jb, kr, sr, jh, nv)))(keys))
    want = jax.jit(jax.vmap(lambda q: jv.vbhem_em(
        jb, q, jh, nv=nv, tau=tau, max_iter=max_iter)))(posts)
    got = tv.vbhem_em(f32(jb), f32(posts), f32(jh), nv=nv, tau=tau,
                      max_iter=max_iter)
    it, it64 = got.it.numpy(), np.asarray(want.it)
    ll, ll64 = got.ll.double().numpy(), np.asarray(want.ll)
    assert np.all(it64 < max_iter), it64
    # done before max_iter with a finite bound: stopped by convergence
    assert np.all(got.done.numpy()) and np.all(it < max_iter), it
    assert np.all(np.isfinite(ll)), ll
    assert np.all(np.abs(it - it64) <= 1), (it, it64)
    np.testing.assert_allclose(ll, ll64, rtol=1e-5)


# ---------------------------------------------------------------------------
# Learned hyps in float32 stay inside their box
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["vbhem", "vbem"])
def test_f32_hyps_stay_inside_their_box(engine):
    """L-BFGS iterates on the box's edges, unpacked into each dtype's hyps.
    v0's lower bound D - 1 + e^-20 is D - 1 in float32, where the bound's
    Wishart normalizer lgamma((v0 + 1 - D) / 2) is lgamma(0): the bound
    is -inf and every EM run under it goes on to max_iter.  In float32
    every learned hyp must lie inside its box and the normalizer be
    finite; in float64 the hyps are the box's own values."""
    from vbhem_tpu_torch import hyp
    from vbhem_tpu_torch.config import HypBounds, VBConfig, VBHEMConfig
    from vbhem_tpu_torch.utils.numeric import log_wishart_b
    if engine == "vbhem":
        specs = hyp.vbhem_specs(D, HypBounds(), VBHEMConfig().learn_hyps_keys)
        make = lambda dt: tv.VBHEMHyps.from_config(VBHEMConfig(), D, dt,
                                                   "cpu")
    else:
        specs = hyp.vb_specs(D, HypBounds(), VBConfig().learn_hyps_keys)
        make = lambda dt: tvb.VBHyps.from_config(VBConfig(), D, dt, "cpu")
    for theta in hyp.bound_vectors(specs):
        theta = torch.as_tensor(theta, dtype=torch.float64)
        h32 = hyp.unpack(theta, make(torch.float32), specs)
        h64 = hyp.unpack(theta, make(torch.float64), specs)
        for s in specs:
            v32 = getattr(h32, s.name).double()
            assert torch.all((v32 >= s.lo) & (v32 <= s.hi)), (s.name, v32)
        i = 0
        for s in specs:
            want = s.inverse(theta[i: i + s.size])
            i += s.size
            got = getattr(h64, s.name).reshape(-1)
            assert torch.equal(got, want), s.name
        # as the bounds evaluate it: in float64, from the float32 hyps
        assert torch.isfinite(log_wishart_b(
            torch.tensor(0.0, dtype=torch.float64), h32.v0.double(), D))
