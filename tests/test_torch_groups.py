"""The port's grouped VBEM and hyp heuristics (ROADMAP A5) against the JAX
package on the same float64 inputs, made from a numpy seed: the E-step
(per-sequence scores), the grouped statistics, the M-step and the bound
at 1e-10; the grouped EM loop over lanes from the same starts (1e-9);
``learn_grouped``'s selection over K with hyps off and on; the group
split and the permutation; ``set_hyperparam`` in both modes and
``format_hyps``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbhem_tpu.config import VBConfig as JConfig
from vbhem_tpu.containers import SeqBatch as JBatch
from vbhem_tpu.models import hyp_heuristics as jhh
from vbhem_tpu.models import vbhmm as jvb
from vbhem_tpu.models import vbhmm_groups as jg
from vbhem_tpu_torch import VBConfig, convert
from vbhem_tpu_torch.containers import SeqBatch
from vbhem_tpu_torch.models import hyp_heuristics as thh
from vbhem_tpu_torch.models import vbhmm_groups as tg

RTOL = 1e-10
D = 2
CFG = dict(mu0=(1.5, 1.5), w0=1.0)


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def sample_two_dynamics(seed, n_per=10, t=40, ragged=True):
    """Sequences from two 2-state HMMs with shared emissions (means (0,0)
    and (3,3)) but different dynamics, one sticky and one alternating:
    the grouped-VBEM use case.  Ragged lengths when ``ragged``."""
    rng = np.random.default_rng(seed)
    means = np.array([[0.0, 0.0], [3.0, 3.0]])
    trans = [np.array([[0.8, 0.2], [0.2, 0.8]]),
             np.array([[0.2, 0.8], [0.8, 0.2]])]
    x = np.zeros((2 * n_per, t, D))
    lengths = np.full(2 * n_per, t, np.int32)
    for i in range(2 * n_per):
        a = trans[i // n_per]
        z = rng.integers(2)
        for s in range(t):
            x[i, s] = means[z] + rng.normal(size=D) * 0.7
            z = rng.choice(2, p=a[z])
        if ragged and i % 3 == 1:
            lengths[i] = t - 7 - i % 5
            x[i, lengths[i]:] = 0.0
    group_map = np.repeat([0, 1], n_per)
    return x, lengths, group_map


@pytest.fixture(scope="module")
def data():
    x, lengths, gm = sample_two_dynamics(0)
    jb = JBatch(x=jnp.asarray(x), lengths=jnp.asarray(lengths))
    tb = SeqBatch(x=torch.as_tensor(x), lengths=torch.as_tensor(lengths))
    jh = jvb.VBHyps.from_config(JConfig(**CFG), D)
    th = to_port(jh)
    # a grouped start: two restarts of the JAX package's random init
    keys = jax.random.split(jax.random.key(1), 2)
    p0 = jax.vmap(lambda k: jg.from_ungrouped(
        jvb.random_init(k, jb, 2, jh), 2))(keys)
    return dict(jb=jb, tb=tb, jh=jh, th=th, gm=gm, jgm=jnp.asarray(gm),
                tgm=torch.as_tensor(gm), p0=p0, tp0=tg.GroupedPosterior(
                    *to_port(jvb.HMMPosterior(*p0))))


def _one(post, lane=0):
    return jax.tree.map(lambda a: a[lane], post)


def test_e_step_stats_m_step_elbo_match_jax(data):
    d = data
    jpost = _one(d["p0"])
    tpost = tg.GroupedPosterior(*[convert.to_torch(a, device="cpu")
                                  for a in jpost])
    jfb = jg.e_step(d["jb"], jpost, d["jgm"])
    tfb = tg.e_step(d["tb"], tpost, d["tgm"])
    for f in ("log_rho", "gamma", "xi_sum", "phi_norm"):
        close(getattr(tfb, f), getattr(jfb, f), atol=1e-12)
    jst = jg.grouped_stats(d["jb"], jfb, d["jgm"], 2)
    tst = tg.grouped_stats(d["tb"], tfb, d["tgm"], 2)
    close(tst.nk1_g, jst.nk1_g)
    close(tst.m_g, jst.m_g)
    for f in jst.shared._fields:
        close(getattr(tst.shared, f), getattr(jst.shared, f), atol=1e-12)
    jm = jg.m_step(jst, d["jh"])
    tm = tg.m_step(tst, d["th"])
    close(tm.alpha, jm.alpha)
    close(tm.epsilon, jm.epsilon)
    for f in jm.niw._fields:
        close(getattr(tm.niw, f), getattr(jm.niw, f), atol=1e-12)
    close(tg.elbo(d["tb"], tpost, tfb, tst, d["th"]),
          jg.elbo(d["jb"], jpost, jfb, jst, d["jh"]))


def test_e_step_lanes_and_per_lane_hyps(data):
    """The E-step and bound over a lane axis equal each lane alone, also
    with one set of hyps per lane."""
    d = data
    tpost = d["tp0"]
    fb = tg.e_step(d["tb"], tpost, d["tgm"])
    st = tg.grouped_stats(d["tb"], fb, d["tgm"], 2)
    hyps_l = type(d["th"])(*[torch.stack([h, h * 1.5]) if name != "m0"
                             else torch.stack([h, h + 0.3])
                             for name, h in zip(d["th"]._fields, d["th"])])
    ll = tg.elbo(d["tb"], tpost, fb, st, hyps_l)
    m = tg.m_step(st, hyps_l)
    for lane in range(2):
        one = convert.to_torch(convert.to_numpy(
            jax.tree.map(lambda a: a[lane], tpost)), device="cpu")
        one = tg.GroupedPosterior(*one)
        h = type(d["th"])(*[h[lane] for h in hyps_l])
        fb1 = tg.e_step(d["tb"], one, d["tgm"])
        st1 = tg.grouped_stats(d["tb"], fb1, d["tgm"], 2)
        np.testing.assert_allclose(
            ll[lane].item(), tg.elbo(d["tb"], one, fb1, st1, h).item(),
            rtol=1e-12)
        m1 = tg.m_step(st1, h)
        close(m.alpha[lane], m1.alpha.numpy(), rtol=1e-12)
        close(m.niw.w[lane], m1.niw.w.numpy(), rtol=1e-12)


def test_vbem_em_matches_jax(data):
    """The grouped EM over two restart lanes against ``jax.vmap`` of the
    JAX loop from the same starts: the same iterations, ll at 1e-9."""
    d = data
    kw = dict(max_iter=40)
    want = jax.vmap(lambda p: jg.vbem_em(d["jb"], p, d["jh"], d["jgm"],
                                         **kw))(d["p0"])
    got = tg.vbem_em(d["tb"], d["tp0"], d["th"], d["tgm"], **kw)
    np.testing.assert_array_equal(got.it.numpy(), np.asarray(want.it))
    close(got.ll, want.ll, rtol=1e-9)
    close(got.post.alpha, want.post.alpha, rtol=1e-8)
    close(got.post.niw.m, want.post.niw.m, rtol=1e-8, atol=1e-9)
    close(got.gamma, want.gamma, rtol=1e-8, atol=1e-9)


def test_split_groups_and_permute(data):
    d = data
    post = tg.GroupedPosterior(*[convert.to_torch(a, device="cpu")
                                 for a in _one(d["p0"])])
    parts = tg.split_groups(post)
    jparts = jg.split_groups(_one(d["p0"]))
    assert len(parts) == len(jparts) == 2
    for p, jp in zip(parts, jparts):
        close(p.alpha, jp.alpha)
        close(p.epsilon, jp.epsilon)
        assert p.niw is post.niw
    perm = [1, 0]
    got = tg.permute(post, perm)
    want = jg.permute(_one(d["p0"]), jnp.asarray(perm))
    close(got.alpha, want.alpha)
    close(got.epsilon, want.epsilon)
    for f in want.niw._fields:
        close(getattr(got.niw, f), getattr(want.niw, f))
    back = tg.from_ungrouped(parts[0], 3)
    assert back.alpha.shape == (3, 2) and back.epsilon.shape == (3, 2, 2)
    np.testing.assert_array_equal(back.alpha[2].numpy(),
                                  parts[0].alpha.numpy())


def _group_trans(res):
    return [m.trans.numpy() if torch.is_tensor(m.trans)
            else np.asarray(m.trans) for m in res.group_models]


def _two_dynamics_batch():
    x, lengths, gm = sample_two_dynamics(3, n_per=8, t=30, ragged=False)
    return x, lengths, gm, SeqBatch(x=torch.as_tensor(x),
                                    lengths=torch.as_tensor(lengths))


LEARN_KW = dict(CFG, numtrials=2, max_iter=50, hyp_max_steps=3,
                max_hyp_solutions=1)


def _check_dynamics(res):
    a0, a1 = _group_trans(res)
    assert a0[0, 0] > 0.6 and a0[1, 1] > 0.6, a0
    assert a1[0, 1] > 0.6 and a1[1, 0] > 0.6, a1


def test_learn_grouped_selects_k_as_jax():
    """``learn_grouped`` over K in {1, 2}, hyps off: the port and the JAX
    package both select K=2 at the same optima (the restarts differ) and
    recover each group's dynamics (state 0 the higher-count state)."""
    x, lengths, gm, tb = _two_dynamics_batch()
    tres, tinfo = tg.learn_grouped(torch.Generator().manual_seed(0), tb,
                                   [1, 2], gm, 2, VBConfig(**LEARN_KW))
    jres, jinfo = jg.learn_grouped(
        jax.random.key(0), JBatch(x=jnp.asarray(x),
                                  lengths=jnp.asarray(lengths)),
        [1, 2], gm, 2, JConfig(**LEARN_KW))
    assert tinfo["model_best_k"] == jinfo["model_best_k"] == 2, (
        tinfo["model_ll"], jinfo["model_ll"])
    np.testing.assert_allclose(tinfo["model_ll"], jinfo["model_ll"],
                               rtol=1e-6)
    _check_dynamics(tres)
    _check_dynamics(jres)
    assert tinfo["model_infos"][1]["em_iters"] >= 2


def test_learn_grouped_selects_k_with_hyps():
    """``learn_grouped`` over K in {1, 2} with hyps on (the port's lane
    L-BFGS and lane repairs): K=2 selected, the dynamics recovered, the
    learned hyps inside their box, the stage's counts reported, and the
    kept bound at least the hyps-off one (the JAX package's hyp
    objective is held to the port's in tests/test_torch_hyp*.py)."""
    from vbhem_tpu_torch import hyp as hypmod
    *_, gm, tb = _two_dynamics_batch()
    cfg = VBConfig(**dict(LEARN_KW, learn_hyps=True))
    res, info = tg.learn_grouped(torch.Generator().manual_seed(0), tb,
                                 [1, 2], gm, 2, cfg)
    assert info["model_best_k"] == 2, info["model_ll"]
    _check_dynamics(res)
    best = info["model_infos"][1]
    assert best["hyp_lanes"] % 4 == 0 and best["hyp_em_iters"] > 0
    lo, hi = hypmod.bound_vectors(hypmod.vb_specs(D, cfg.bounds,
                                                  cfg.learn_hyps_keys))
    theta = hypmod.pack(best["learned_hyps"], hypmod.vb_specs(
        D, cfg.bounds, cfg.learn_hyps_keys))
    assert np.all(theta >= lo - 1e-9) and np.all(theta <= hi + 1e-9)
    r0, _ = tg.learn_grouped(torch.Generator().manual_seed(0), tb, 2, gm, 2,
                             VBConfig(**LEARN_KW))
    assert float(res.ll) >= float(r0.ll) - 1e-6


def test_set_hyperparam_and_format_hyps_match_jax(data):
    d = data
    x3 = np.concatenate([np.asarray(d["jb"].x),
                         np.abs(np.random.default_rng(2).normal(
                             250, 30, size=d["jb"].x.shape[:2] + (1,)))],
                        axis=-1)
    j3 = JBatch(x=jnp.asarray(x3), lengths=d["jb"].lengths)
    t3 = SeqBatch(x=torch.as_tensor(x3), lengths=d["tb"].lengths)
    for jbs, tbs in (([d["jb"]], [d["tb"]]), ([j3, d["jb"]][:1], [t3])):
        for mode, size in (("d", None), ("c", (512, 384))):
            want = jhh.set_hyperparam(JConfig(), jbs, mode, size)
            got = thh.set_hyperparam(VBConfig(), tbs, mode, size)
            np.testing.assert_allclose(got.mu0, want.mu0, rtol=1e-12)
            np.testing.assert_allclose(got.w0, want.w0, rtol=1e-12)
    with pytest.raises(ValueError, match="image_size"):
        thh.set_hyperparam(VBConfig(), [d["tb"]], "c")
    with pytest.raises(ValueError, match="unknown mode"):
        thh.set_hyperparam(VBConfig(), [d["tb"]], "x")
    assert thh.format_hyps(d["th"]) == jhh.format_hyps(d["jh"])
    assert thh.format_hyps(d["th"], ["alpha0", "m0"]) == \
        jhh.format_hyps(d["jh"], ["alpha0", "m0"])
