"""The port's hyps-on VBHEM entry points against the JAX package, driven
from the same restarts (the JAX package's baseem draws, converted, in place
of the port's), in float64 at ``hyp_max_steps`` of 5 or fewer:

  * ``vbhem.cluster`` with hyps on (one cell): the score, the kept model
    and the kept lane's hyps at 1e-6 relative; the cell's
    ``optimize_solution_hyps_batched`` on the JAX run's own lanes
    (recorded), every lane's learned hyps and final bound at 1e-6;
  * ``vbhem.cluster_batched`` with hyps on over the padded (K, S) grid
    (``optimize_hyps_grid_batched``: one lane per cell and survivor on the
    masked EM): the selected cell, every cell's score
    (``info['model_ll']``), kept hyps and posterior at 1e-6, and the grid
    stage's lanes (a multiple of 16)."""
import jax
import numpy as np
import torch

from tests.test_torch_hyp_engines import RTOL, close_hyps, to_port
from tests.test_torch_vbhem import jax_bank
from vbhem_tpu.config import VBHEMConfig as JConfig
from vbhem_tpu.models import vbhem as jvh
from vbhem_tpu_torch import VBHEMConfig
from vbhem_tpu_torch.models import vbhem as tvh


CLUSTER_KW = dict(m0=(0.0, 0.0), w0=1.0, nv=10, tau=5, trials=3,
                  max_iter=25, initmode="baseem", learn_hyps=True,
                  hyp_max_steps=5, max_hyp_solutions=2)


def test_cluster_with_hyps_matches_jax(monkeypatch):
    """``cluster`` on cell (2, 2) with hyps on (one cell: each cell costs
    the JAX package a compile of its L-BFGS program; the selection over
    cells is the hyps-off path's, tested in tests/test_torch_vbhem.py),
    from the JAX package's baseem restarts: the score and the kept model
    agree at 1e-6 relative, and the cell's
    ``optimize_solution_hyps_batched`` (recorded from the JAX run, the
    same initial posteriors) agrees in learned hyps and final ELBOs; the
    kept lane's hyps are the recorded lane's."""
    jb = jax_bank(np.random.default_rng(8), 10, 2, 2)
    jcfg, cfg = JConfig(**CLUSTER_KW), VBHEMConfig(**CLUSTER_KW)
    key = jax.random.key(6)
    jh = jvh.VBHEMHyps.from_config(jcfg, 2)
    recorded = []
    real = jvh.optimize_solution_hyps_batched

    def record(base, init_posts, hyps0, config):
        out = real(base, init_posts, hyps0, config)
        recorded.append((init_posts, out))
        return out

    monkeypatch.setattr(jvh, "optimize_solution_hyps_batched", record)
    jres, jinfo = jvh.cluster(key, jb, 2, 2, jcfg)
    # the JAX package's restarts of the cell, trial by trial
    cell_key = jax.random.fold_in(jax.random.fold_in(key, 0), 0)
    keys = jax.random.split(jax.random.fold_in(cell_key, 0), jcfg.trials)
    posts = to_port(jax.vmap(lambda k: jvh.init_baseem(
        k, jb, 2, 2, jh, jcfg.nv))(keys))
    monkeypatch.setitem(tvh._DRAWS, "baseem", (lambda *a: {},
                                               lambda *a, **k: posts))
    base = to_port(jb)
    res, info = tvh.cluster(torch.Generator(), base, 2, 2, cfg)
    np.testing.assert_allclose(info["model_ll"], jinfo["model_ll"],
                               rtol=RTOL)
    np.testing.assert_allclose(res.post.niw.m.numpy(),
                               np.asarray(jres.post.niw.m), rtol=RTOL,
                               atol=1e-9)
    np.testing.assert_allclose(res.hat_z.numpy(), np.asarray(jres.hat_z),
                               rtol=RTOL, atol=1e-9)
    (init_posts, (jhyps_b, jsts)), = recorded
    stage = info["hyp_stages"][(2, 2)]
    assert stage["hyp_lanes"] == 4 and stage["hyp_reverted"] == 0
    th0 = tvh.VBHEMHyps.from_config(cfg, 2, device="cpu")
    hyps_b, sts = tvh.optimize_solution_hyps_batched(
        base, to_port(init_posts), th0, cfg)
    np.testing.assert_allclose(sts.ll.numpy(), np.asarray(jsts.ll),
                               rtol=RTOL)
    close_hyps(hyps_b, jhyps_b)
    lane = int(np.argmax(np.asarray(jsts.ll)))
    close_hyps(info["model_hyps"][(2, 2)],
               jax.tree.map(lambda a: a[lane], jhyps_b))


GRID_KW = dict(m0=(0.0, 0.0), w0=1.0, nv=10, tau=5, trials=3, max_iter=25,
               initmode="baseem", learn_hyps=True, hyp_max_steps=3,
               max_hyp_solutions=2)


def test_cluster_batched_with_hyps_matches_jax(monkeypatch):
    jb = jax_bank(np.random.default_rng(5), 10, 2, 2)
    jcfg = JConfig(**GRID_KW)
    ks, ss = [1, 2], [1, 2]
    key = jax.random.key(4)
    jh = jvh.VBHEMHyps.from_config(jcfg, 2)
    jres, jinfo = jvh.cluster_batched(key, jb, ks, ss, jcfg)
    # fit_grid_batched's restarts, cell-major, at the padded (K, S)
    keys = jax.random.split(key, (len(ks) * len(ss), jcfg.trials))
    posts = jax.vmap(jax.vmap(lambda k: jvh.init_baseem(
        k, jb, max(ks), max(ss), jh, jcfg.nv)))(keys)
    flat = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), posts)
    monkeypatch.setitem(tvh._DRAWS, "baseem", (lambda *a: {},
                                               lambda *a, **k: to_port(flat)))
    res, info = tvh.cluster_batched(torch.Generator(), to_port(jb), ks, ss,
                                    VBHEMConfig(**GRID_KW))
    assert (info["model_best_k"], info["model_best_s"]) == (
        jinfo["model_best_k"], jinfo["model_best_s"])
    np.testing.assert_allclose(info["model_ll"], jinfo["model_ll"],
                               rtol=RTOL)
    for cell, r in info["model_all"].items():
        close_hyps(info["model_hyps"][cell], jinfo["model_hyps"][cell])
        jr = jinfo["model_all"][cell]
        np.testing.assert_allclose(r.post.niw.m.numpy(),
                                   np.asarray(jr.post.niw.m), rtol=RTOL,
                                   atol=1e-9)
        np.testing.assert_allclose(r.hat_z.numpy(), np.asarray(jr.hat_z),
                                   rtol=RTOL, atol=1e-9)
    hyp = info["hyp"]
    assert hyp["hyp_lanes"] % 16 == 0 and hyp["hyp_reverted"] == 0
    assert len(hyp["hyp_steps"]) == hyp["hyp_lanes"]
    assert hyp["hyp_em_iters"] > 0 and hyp["hyp_e_steps"] == hyp["hyp_calls"]
