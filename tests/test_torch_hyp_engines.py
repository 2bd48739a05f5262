"""The port's hyps-on VBEM entry points against the JAX package, driven from
the same restarts: each package's restarts are the JAX package's own draws
(the port's restart drawing is replaced by the JAX package's initial
posteriors, converted), so both run EM from the same starts, keep the
same uniqueLL survivors and optimize the same lanes.  In float64, at
``hyp_max_steps=5`` or fewer:

  * ``vbhmm.learn`` with hyps on: the kept lane, its learned hyps and the
    final bound at 1e-6 relative; ``optimize_solution_hyps_batched`` on the
    initial posteriors the JAX run gave it (recorded), every lane's learned
    hyps and final bound at 1e-6;
  * ``batch.learn_bank`` with hyps on: every subject's kept model and
    learned hyps at 1e-6, and the stage's lane layout (one lane per subject
    and survivor, min(cap, restarts) a subject);
  * ``batch.learn_batch(learn_hyps_batch=True)``: the shared hyps and every
    subject's refit at 1e-6.

The VBHEM entry points are in tests/test_torch_hyp_vbhem.py (each JAX run
here compiles its own L-BFGS program; the split keeps every file near a
minute and a half in one process)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vbhmm import subject
from vbhem_tpu.config import VBConfig as JVBConfig
from vbhem_tpu.containers import SeqBatch as JSeqBatch
from vbhem_tpu.models import batch as jbatch
from vbhem_tpu.models import vbhmm as jvb
from vbhem_tpu_torch import VBConfig, convert
from vbhem_tpu_torch.models import batch as tbatch
from vbhem_tpu_torch.models import vbhmm as tvb

RTOL = 1e-6


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def close_hyps(got, want, rtol=RTOL):
    for f in got._fields:
        np.testing.assert_allclose(convert.to_numpy(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=rtol)


VB_KW = dict(mu0=(1.5, 1.5), w0=1.0, numtrials=4, max_iter=60,
             learn_hyps=True, hyp_max_steps=5)


# ---------------------------------------------------------------------------
# VBEM: learn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def learn_run():
    """The JAX package's learn with hyps on, its restarts' initial
    posteriors, and the inputs/outputs of its optimize_solution_hyps_batched
    call (recorded)."""
    tb, jb = subject(seed=7, n_seqs=12, t=30)
    jcfg = JVBConfig(**VB_KW)
    key = jax.random.key(3)
    jh = jvb.VBHyps.from_config(jcfg, 2)
    posts = jax.vmap(lambda k: jvb.random_init(k, jb, 2, jh))(
        jax.random.split(key, jcfg.numtrials))
    recorded = []
    real = jvb.optimize_solution_hyps_batched

    def record(batch, init_posts, hyps0, config):
        out = real(batch, init_posts, hyps0, config)
        recorded.append((init_posts, out))
        return out

    jvb.optimize_solution_hyps_batched = record
    try:
        res, info = jvb.learn(key, jb, 2, jcfg)
    finally:
        jvb.optimize_solution_hyps_batched = real
    return dict(tb=tb, jb=jb, posts=posts, res=res, info=info,
                recorded=recorded)


def test_learn_with_hyps_matches_jax(learn_run, monkeypatch):
    r = learn_run
    monkeypatch.setattr(tvb, "random_init",
                        lambda *a, **k: to_port(r["posts"]))
    res, info = tvb.learn(torch.Generator(), r["tb"], 2, VBConfig(**VB_KW))
    assert float(res.ll) == pytest.approx(float(r["res"].ll), rel=RTOL)
    close_hyps(info["learned_hyps"], r["info"]["learned_hyps"])
    np.testing.assert_allclose(res.model.mean.numpy(),
                               np.asarray(r["res"].model.mean), rtol=RTOL)
    np.testing.assert_allclose(res.model.trans.numpy(),
                               np.asarray(r["res"].model.trans), rtol=RTOL)
    assert info["hyp_lanes"] % 4 == 0 and info["hyp_reverted"] == 0
    assert np.all(info["hyp_ll_post"] >= info["hyp_ll_pre"])


def test_vbem_optimize_solution_hyps_batched_matches_jax(learn_run):
    """The batched optimizer on the JAX run's own lanes, at
    hyp_max_steps=5: every lane's learned hyps and final bound."""
    r = learn_run
    (init_posts, (jhyps_b, jsts)), = r["recorded"]
    cfg = VBConfig(**VB_KW)
    stats = {}
    hyps_b, sts = tvb.optimize_solution_hyps_batched(
        r["tb"], to_port(init_posts),
        tvb.VBHyps.from_config(cfg, 2, device="cpu"), cfg, stats=stats)
    np.testing.assert_allclose(sts.ll.numpy(), np.asarray(jsts.ll),
                               rtol=RTOL)
    close_hyps(hyps_b, jhyps_b)
    assert stats["steps"].max() <= cfg.hyp_max_steps
    assert stats["lane_evals"] >= stats["calls"] > 0


# ---------------------------------------------------------------------------
# VBEM: learn_bank and learn_batch
# ---------------------------------------------------------------------------

BANK_KW = dict(mu0=(1.5, 1.5), w0=1.0, numtrials=3, max_iter=40,
               learn_hyps=True, hyp_max_steps=3, max_hyp_solutions=2)


def _subjects(n, seed):
    """n subjects, the port's and the JAX package's batches."""
    pairs = [subject(seed=seed + i, n_seqs=8, t=20) for i in range(n)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_learn_bank_with_hyps_matches_jax(monkeypatch):
    tbs, jbs = _subjects(3, 20)
    jcfg = JVBConfig(**BANK_KW)
    key = jax.random.key(9)
    jh = jvb.VBHyps.from_config(jcfg, 2)
    jres, jinfo = jbatch.learn_bank(key, jbs, 2, jcfg)
    # learn_bank's restarts: per subject, per trial
    posts = jax.vmap(lambda sk, x, ln: jax.vmap(
        lambda tk: jvb.random_init(tk, JSeqBatch(x=x, lengths=ln), 2, jh))(
            jax.random.split(sk, jcfg.numtrials)))(
        jax.random.split(key, len(jbs)), jnp.stack([b.x for b in jbs]),
        jnp.stack([b.lengths for b in jbs]))
    monkeypatch.setattr(tvb, "random_init", lambda *a, **k: to_port(posts))
    res, info = tbatch.learn_bank(torch.Generator(), tbs, 2,
                                  VBConfig(**BANK_KW))
    assert info["hyp_lanes"] == 3 * min(BANK_KW["max_hyp_solutions"],
                                        BANK_KW["numtrials"])
    for r, jr in zip(res, jres):
        assert float(r.ll) == pytest.approx(float(jr.ll), rel=RTOL)
        np.testing.assert_allclose(r.model.mean.numpy(),
                                   np.asarray(jr.model.mean), rtol=RTOL)
    close_hyps(info["learned_hyps"], jinfo["learned_hyps"])
    assert info["learned_hyps"].alpha0.shape == (3,)
    assert info["learned_hyps"].w0.shape == (3, 2)


def test_learn_batch_shared_hyps_match_jax(monkeypatch):
    """One hyperparameter set shared by all subjects, SciPy's L-BFGS-B over
    the summed best-solution bounds (`vbhmm_learn_batch.m:107-457`)."""
    tbs, jbs = _subjects(2, 40)
    kw = dict(mu0=(1.5, 1.5), w0=1.0, numtrials=3, max_iter=40,
              learn_hyps_keys=("beta0", "w0", "mu0"), min_diff=1e-9)
    jcfg = JVBConfig(**kw)
    key = jax.random.key(12)
    jh = jvb.VBHyps.from_config(jcfg, 2)
    jres, jinfo = jbatch.learn_batch(key, jbs, 2, jcfg,
                                     learn_hyps_batch=True)
    starts = iter([to_port(jax.vmap(lambda k: jvb.random_init(
        k, b, 2, jh))(jax.random.split(jax.random.fold_in(key, i),
                                       jcfg.numtrials)))
        for i, b in enumerate(jbs)])
    monkeypatch.setattr(tvb, "random_init", lambda *a, **k: next(starts))
    res, info = tbatch.learn_batch(torch.Generator(), tbs, 2,
                                   VBConfig(**kw), learn_hyps_batch=True)
    close_hyps(info["learned_hyps"], jinfo["learned_hyps"])
    assert info["fun"] == pytest.approx(jinfo["fun"], rel=1e-9)
    for r, jr in zip(res, jres):
        assert float(r.ll) == pytest.approx(float(jr.ll), rel=RTOL)
        np.testing.assert_allclose(r.model.mean.numpy(),
                                   np.asarray(jr.model.mean), rtol=RTOL)
