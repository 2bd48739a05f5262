"""The port's padded (K, S) grid against the JAX package on the same
float64 inputs, made from a numpy seed (or by the JAX package) and handed
over through ``vbhem_tpu_torch.convert``: the masked numeric helpers and
the masked bound (``elbo`` with masks, the JAX ``elbo_masked``) at rtol
1e-10; ``vbhem_em_masked`` over lanes with their
own masks, from the same initial posteriors, against
``jax.vmap(vbhem_em_masked)`` at 1e-8 on every lane's ELBO and posterior;
padded equals unpadded; chunked equals unchunked; ``cluster_batched`` and
``run_vbhem`` on a JAX-made bank of the data of tests/test_vbhem.py
selecting (2, 2) with Rand index 1.0; float32 banks reporting the float32
scores beside the float64 ones; and the initializers not ported yet
raising NotImplementedError.  The two packages draw different restarts, so the
sweeps compare selections with the planted groups."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vbhem import assert_tree_close, jax_bank
from vbhem_tpu.config import VBConfig as JVBConfig
from vbhem_tpu.config import VBHEMConfig as JConfig
from vbhem_tpu.containers import HMM as JHMM
from vbhem_tpu.containers import SeqBatch as JSeqBatch
from vbhem_tpu.models import batch as jbatch
from vbhem_tpu.models import hmm_tools
from vbhem_tpu.models import vbhem as jv
from vbhem_tpu.utils import numeric as jnum
from vbhem_tpu_torch import VBHEMConfig, convert
from vbhem_tpu_torch.experiments import synthetic as tsyn
from vbhem_tpu_torch.models import vbhem as tv
from vbhem_tpu_torch.utils import numeric as tnum

RTOL = 1e-10
REPO = Path(__file__).resolve().parent.parent


def to_port(obj):
    return convert.to_torch(obj, device="cpu")


def test_masked_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 3, 5)) * 4.0
    conc = rng.uniform(0.2, 9.0, size=(4, 3, 5))
    mask = rng.uniform(size=(4, 3, 5)) < 0.6
    mask[0, 0] = False                      # a slice with nothing active
    mask[1, 1] = True
    row_mask = mask[:, :1, :]               # a mask that broadcasts
    for m in (mask, row_mask):
        for keepdim in (False, True):
            want = jnum.masked_logsumexp(jnp.asarray(a), jnp.asarray(m),
                                         axis=-1, keepdims=keepdim)
            got = tnum.masked_logsumexp(torch.as_tensor(a),
                                        torch.as_tensor(m), dim=-1,
                                        keepdim=keepdim)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL)
        want = jnum.masked_e_log_dirichlet(jnp.asarray(conc), jnp.asarray(m))
        got = tnum.masked_e_log_dirichlet(torch.as_tensor(conc),
                                          torch.as_tensor(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
        assert np.all(got.numpy()[~np.broadcast_to(m, conc.shape)] == -1e30)
    mask[0, 0, 0] = True                    # every slice has an entry
    want = jnum.masked_log_dirichlet_const(jnp.asarray(conc),
                                           jnp.asarray(mask))
    got = tnum.masked_log_dirichlet_const(torch.as_tensor(conc),
                                          torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert np.isneginf(tnum.masked_logsumexp(
        torch.as_tensor(a), torch.zeros(5, dtype=torch.bool)).numpy()).all()


# (K, S) of each lane, padded to KMAX x SMAX: single-cluster and
# single-state lanes among them
CELLS = [(1, 1), (2, 2), (3, 1), (1, 3), (3, 3), (2, 3)]
KMAX, SMAX = 3, 3


def _masks(cells):
    cm = np.stack([np.arange(KMAX) < k for k, _ in cells])
    sm = np.stack([np.arange(SMAX) < s for _, s in cells])
    return cm, sm


@pytest.fixture(scope="module")
def padded():
    """Padded lanes of a small bank: JAX-made baseem posteriors at (KMAX,
    SMAX), one per cell of CELLS, and the JAX package's masked EM over
    them (jax.vmap of vbhem_em_masked)."""
    kb, sb, d = 10, 2, 2
    jb = jax_bank(np.random.default_rng(5), kb, sb, d)
    cfg = JConfig(m0=(0.0, 0.0), w0=1.0, nv=10, tau=5)
    jh = jv.VBHEMHyps.from_config(cfg, d)
    keys = jax.random.split(jax.random.key(3), len(CELLS))
    posts = jax.vmap(lambda k: jv.init_baseem(k, jb, KMAX, SMAX, jh,
                                              cfg.nv))(keys)
    cm, sm = _masks(CELLS)
    want = jax.vmap(lambda p, c, s: jv.vbhem_em_masked(
        jb, p, jh, nv=cfg.nv, tau=cfg.tau, cmask=c, smask=s,
        max_iter=40))(posts, jnp.asarray(cm), jnp.asarray(sm))
    return dict(jb=jb, jh=jh, posts=posts, cm=cm, sm=sm, cfg=cfg, want=want)


def test_reduced_expectations_and_elbo_masked_match_jax(padded):
    p = padded
    jb, jh, cfg = p["jb"], p["jh"], p["cfg"]
    tilde_n = (cfg.nv * jb.num_hmms) * jb.omega

    def one(post, cmask, smask):
        exps = jv.reduced_expectations_masked(post, cmask, smask)
        pair = jv.e_step(jb, post, exps, cfg.tau)
        hat_z, z_ni, nj = jv.soft_assignments(tilde_n, exps.log_omega,
                                              pair.ll_elbo)
        return exps, pair, (hat_z, z_ni, nj), jv.elbo_masked(
            post, exps, pair, hat_z, z_ni, nj, jh, cmask, smask)
    exps, pair, soft, ll = jax.vmap(one)(p["posts"], jnp.asarray(p["cm"]),
                                         jnp.asarray(p["sm"]))
    tpost, cm, sm = to_port(p["posts"]), to_port(p["cm"]), to_port(p["sm"])
    texps = tv.reduced_expectations(tpost, cm, sm)
    assert_tree_close(texps, exps, rtol=RTOL)
    got = tv.elbo(tpost, texps, to_port(pair), *map(to_port, soft),
                  to_port(jh), cm, sm)
    np.testing.assert_allclose(got.numpy(), np.asarray(ll), rtol=RTOL)
    assert np.all(np.isfinite(got.numpy()))
    # masked entries carry -1e30, and the bound stays finite in float32
    assert np.all(texps.log_omega.numpy()[~p["cm"]] == -1e30)
    post32, pair32, h32, tilde32 = (
        convert.to_torch(x, device="cpu", dtype=torch.float32)
        for x in (p["posts"], pair, jh, tilde_n))
    exps32 = tv.reduced_expectations(post32, cm, sm)
    soft32 = tv.soft_assignments(tilde32, exps32.log_omega, pair32.ll_elbo)
    f32 = tv.elbo(post32, exps32, pair32, *soft32, h32, cm, sm)
    assert np.all(np.isfinite(f32.numpy()))
    np.testing.assert_allclose(f32.numpy(), np.asarray(ll), rtol=1e-4)


def test_vbhem_em_masked_lanes_match_jax_vmap(padded):
    """Every lane its own masks, from the same initial posteriors: the
    same iteration counts, ELBOs and posteriors (on the active sub-grid;
    the masked entries' values are never read)."""
    p = padded
    want = p["want"]
    got = tv.vbhem_em_masked(to_port(p["jb"]), to_port(p["posts"]),
                             to_port(p["jh"]), nv=p["cfg"].nv,
                             tau=p["cfg"].tau, cmask=to_port(p["cm"]),
                             smask=to_port(p["sm"]), max_iter=40)
    it = np.asarray(want.it)
    assert len(set(it.tolist())) > 1
    np.testing.assert_array_equal(got.it.numpy(), it)
    np.testing.assert_allclose(got.ll.numpy(), np.asarray(want.ll),
                               rtol=1e-8)
    for lane, (k, s) in enumerate(CELLS):
        g = convert.to_numpy(got.post)
        for f, view in (("alpha", lambda a: a[lane, :k]),
                        ("eta", lambda a: a[lane, :k, :s]),
                        ("epsilon", lambda a: a[lane, :k, :s, :s])):
            np.testing.assert_allclose(
                view(getattr(g, f)), view(np.asarray(getattr(want.post, f))),
                rtol=1e-8, err_msg=f"{f} {k, s}")
        for f in ("beta", "v", "m", "w"):
            np.testing.assert_allclose(
                getattr(g.niw, f)[lane, :k, :s],
                np.asarray(getattr(want.post.niw, f))[lane, :k, :s],
                rtol=1e-8, atol=1e-10, err_msg=f"{f} {k, s}")
        np.testing.assert_allclose(got.hat_z.numpy()[lane, :, :k],
                                   np.asarray(want.hat_z)[lane, :, :k],
                                   rtol=1e-8, atol=1e-12)


def test_padded_equals_unpadded(padded):
    """A padded lane's active sub-grid runs as the unpadded EM from the
    same start (the sliced initial posterior): the same iterations and
    ELBO, the same posterior."""
    p = padded
    tb, th = to_port(p["jb"]), to_port(p["jh"])
    posts = to_port(p["posts"])
    for lane, (k, s) in enumerate(CELLS):
        one = tv.tree_map(torch.Tensor.contiguous, tv.H3MPosterior(
            alpha=posts.alpha[lane, :k], eta=posts.eta[lane, :k, :s],
            epsilon=posts.epsilon[lane, :k, :s, :s],
            niw=tv.NIW(*[f[lane, :k, :s] for f in posts.niw])))
        ref = tv.vbhem_em(tb, one, th, nv=p["cfg"].nv, tau=p["cfg"].tau,
                          max_iter=40)
        pad = tv.vbhem_em_masked(
            tb, tv.tree_map(lambda a: a[lane], posts), th, nv=p["cfg"].nv,
            tau=p["cfg"].tau, cmask=to_port(p["cm"][lane]),
            smask=to_port(p["sm"][lane]), max_iter=40)
        assert int(pad.it) == int(ref.it), (k, s)
        np.testing.assert_allclose(float(pad.ll), float(ref.ll), rtol=1e-9)
        np.testing.assert_allclose(pad.post.niw.m[:k, :s].numpy(),
                                   ref.post.niw.m.numpy(), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(pad.hat_z[:, :k].numpy(),
                                   ref.hat_z.numpy(), atol=1e-9)


def gt_hmm(trans):
    return JHMM(prior=jnp.asarray([0.5, 0.5]),
                trans=jnp.asarray(trans, jnp.float64),
                mean=jnp.asarray([[0.0, 0.0], [3.0, 3.0]]),
                cov=jnp.broadcast_to(jnp.eye(2), (2, 2, 2)))


@pytest.fixture(scope="module")
def learned_bank():
    """A JAX-made bank on the data of tests/test_vbhem.py:25 (2
    ground-truth HMMs x 6 subjects, 15 sequences of T=50 each), learned by
    the JAX package's batched VBEM (``batch.learn_bank``, one program for
    the 12 subjects); with the port's copy of the results and the bank."""
    batches, labels = [], []
    for gi, h in enumerate([gt_hmm([[0.6, 0.4], [0.4, 0.6]]),
                            gt_hmm([[0.4, 0.6], [0.6, 0.4]])]):
        for si in range(6):
            key = jax.random.key(100 + gi * 10 + si)
            _, x = hmm_tools.sample(key, h, t=50, n=15)
            batches.append(JSeqBatch(x=x,
                                     lengths=jnp.full((15,), 50, jnp.int32)))
            labels.append(gi)
    results, _ = jbatch.learn_bank(
        jax.random.key(7), batches, 2,
        JVBConfig(mu0=(1.5, 1.5), w0=1.0, numtrials=3))
    jbase = jv.h3m_from_results(results, use_post=True)
    return (results, [to_port(r) for r in results], np.array(labels),
            jbase, to_port(jbase))


# the settings of tests/test_vbhem.py:227-238 with 16 restarts: the port's
# draws differ from the JAX package's, and at 6 a seed can miss the (2, 2)
# optimum (a collapsed (2, 2) winner scores below (1, 2))
GRID_CFG = dict(alpha0=1e6, m0=(1.5, 1.5), w0=1.0, trials=16, nv=100,
                tau=50, initmode="baseem", learn_hyps=False)


def test_fit_grid_batched_trial_chunking(learned_bank):
    """Chunked lanes (as the card runs a grid larger than its memory)
    equal the unchunked sweep: the same initial posteriors, iterations
    and ELBOs."""
    *_, tbase = learned_bank
    cfg = VBHEMConfig(**dict(GRID_CFG, trials=4, nv=10, tau=5, max_iter=20))
    hyps = tv.VBHEMHyps.from_config(cfg, 2, device="cpu")
    runs = [tv.fit_grid_batched(torch.Generator().manual_seed(5), tbase,
                                [1, 2], [2, 3], cfg, hyps, trial_chunk=c)
            for c in (None, 3)]
    (full, cells, cm, sm), (chunked, cells2, cm2, sm2) = runs
    assert cells == cells2 == [(1, 2), (1, 3), (2, 2), (2, 3)]
    assert torch.equal(cm, cm2) and torch.equal(sm, sm2)
    assert full.ll.shape == (4, 4)
    np.testing.assert_allclose(chunked.ll.numpy(), full.ll.numpy(),
                               rtol=1e-12)
    np.testing.assert_array_equal(chunked.it.numpy(), full.it.numpy())
    assert_tree_close(chunked.post, convert.to_numpy(full.post), rtol=1e-12)
    assert tv.chunk_iterations(full.it, 3) == [
        int(full.it.reshape(-1)[a:a + 3].max()) for a in range(0, 16, 3)]


JAX_INFO_KEYS = {"model_ll", "model_ll_device", "model_ll_k",
                 "model_best_s_per_k", "model_k", "model_s", "model_best_k",
                 "model_best_s", "model_all", "model_hyps", "vbhemopt",
                 "version"}


def test_cluster_batched_and_run_vbhem_select_2_2(learned_bank):
    """On the JAX-made bank the port's cluster_batched selects (2, 2) with
    the planted labels (the JAX package's does on this data,
    tests/test_vbhem.py:227-238), and its run_vbhem scores K=2,
    S=[2, 2], Rand index 1.0."""
    _, tresults, labels, jbase, tbase = learned_bank
    res, info = tv.cluster_batched(torch.Generator().manual_seed(11), tbase,
                                   [1, 2, 3], [1, 2], VBHEMConfig(**GRID_CFG))
    assert (info["model_best_k"], info["model_best_s"]) == (2, 2), info
    assert tsyn.rand_index(res.label.numpy(), labels)[0] == pytest.approx(1.0)
    assert set(info) >= JAX_INFO_KEYS
    assert np.all(np.isfinite(info["model_ll"]))
    # float64 banks select on the device's own scores
    np.testing.assert_array_equal(info["model_ll"], info["model_ll_device"])
    assert info["grid_trial_chunk"] is None
    assert len(info["grid_chunk_iters"]) == 1
    assert info["grid_chunk_iters"][0] == max(info["model_em_iters"].values())
    # each cell's winner sliced down to its (K, S)
    for (k, s), r in info["model_all"].items():
        assert r.post.eta.shape == (k, s) and r.hat_z.shape == (12, k)
        assert r.trans_counts.shape == (k, s, s)

    cfg = dataclasses.replace(tsyn.default_vbhem_config(trials=16),
                              learn_hyps=False)
    res, info, score = tsyn.run_vbhem(torch.Generator().manual_seed(2),
                                      tresults, labels, [1, 2, 3], [1, 2],
                                      cfg)
    assert score.rand_index == pytest.approx(1.0)
    assert (score.best_k, score.best_s, score.s_list) == (2, 2, [2, 2])


def test_cluster_batched_f32_reports_device_and_f64_scores(learned_bank):
    """A float32 bank: every cell winner is re-evaluated in float64 and
    selection uses those scores; both grids are reported, and at this
    benign scale they agree closely (tests/test_rescore.py:58-78)."""
    *_, tbase = learned_bank
    b32 = tv.tree_map(lambda a: a.float() if a.is_floating_point() else a,
                      tbase)
    cfg = VBHEMConfig(**dict(GRID_CFG, trials=3, tau=10, max_iter=30))
    _, info = tv.cluster_batched(torch.Generator().manual_seed(1), b32,
                                 [1, 2], [1, 2], cfg)
    ll64, ll32 = info["model_ll"], info["model_ll_device"]
    assert np.isfinite(ll64).all() and np.isfinite(ll32).all()
    assert not np.array_equal(ll64, ll32)
    np.testing.assert_allclose(ll64, ll32, rtol=1e-3)
    assert info["model_all"][(2, 2)].post.eta.dtype == torch.float32


def test_what_is_not_ported_raises(learned_bank):
    """Every initmode is ported now; what still raises is the JAX
    package's contract: 'auto' in the single-mode grid worker (the
    front-end runs it mode by mode) and an unknown mode anywhere."""
    *_, tbase = learned_bank
    gen = torch.Generator().manual_seed(0)
    cfg = VBHEMConfig(initmode="auto", learn_hyps=False)
    hyps = tv.VBHEMHyps.from_config(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="front-end"):
        tv.fit_grid_batched(gen, tbase, [2], [2], cfg, hyps)
    with pytest.raises(ValueError, match="unknown initmode"):
        tv.cluster_batched(gen, tbase, 2, 2,
                           VBHEMConfig(initmode="nope", learn_hyps=False))


def test_lane_chunk_is_reckoned_from_the_launch():
    """No chunking on the CPU; on a card, the bytes a lane takes at the
    protocol's padded shape: B1's 41 output values a pair and 72 of the EM
    iteration's, 113 in all (B1 takes the checkpointed design, its state in
    shared memory; the scratch design's 490 values a pair, 603 in all,
    only where a launch takes it)."""
    base = to_port(jax_bank(np.random.default_rng(1), 4, 2, 2))
    assert tv.lane_chunk(base, 6, 5, 50, 10_000) is None
    pairs = 8192 * 6
    got = tv.grid_lane_bytes(8192, 2, 6, 5, 50, 4, 1920)
    assert tv.pair_estep_cuda.design(2, 5, 50, 4, pairs * 1920).kind == \
        "checkpointed"
    assert got == pairs * (41 + 72) * 4
    # a card with fewer SMs than the checkpointed design needs: scratch
    assert tv.grid_lane_bytes(8192, 9, 6, 9, 50, 4, 1920) == pairs * (
        (1 + 9 + 81 + 81) + 49 * 81 + (12 + 9 + 81 + 3 * 81)) * 4
    # a launch small enough to stay resident has no scratch
    small = tv.grid_lane_bytes(40, 2, 2, 2, 10, 4, 1)
    assert small == 80 * ((1 + 2 + 4 + 4) + 12 + 2 + 4 + 12) * 4


def test_lane_chunk_arithmetic_on_a_card(monkeypatch):
    """lane_chunk on a card (its free memory and SMs stubbed): lanes of
    grid_lane_bytes filling GRID_MEMORY_SHARE of the free memory, within
    the launch grid's MAX_GRID_Y / Kmax, in the fewest equal chunks; None
    where all lanes fit.  With 79 GiB free the protocol grid's 1920 lanes
    at Kb=8192 run in two chunks of 960 (1909 fit; the scratch design's
    603 values a pair let 357 fit, six chunks)."""
    from types import SimpleNamespace
    free = 79 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (free, 80 * 2 ** 30))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(
                            multi_processor_count=132))

    class CudaMean:
        device = torch.device("cuda", 0)

        @staticmethod
        def element_size():
            return 4

    def bank(kb):
        return SimpleNamespace(hmm=SimpleNamespace(mean=CudaMean()),
                               state_mask=torch.ones(kb, 2, dtype=bool))

    per = tv.grid_lane_bytes(8192, 2, 6, 5, 50, 4, 1920)
    assert int(free * tv.GRID_MEMORY_SHARE) // per == 1909
    assert tv.lane_chunk(bank(8192), 6, 5, 50, 1920) == 960
    assert tv.lane_chunk(bank(8192), 6, 5, 50, 3000) == 1500
    assert int(free * tv.GRID_MEMORY_SHARE) // (
        8192 * 6 * (41 + 490 + 72) * 4) == 357
    assert tv.lane_chunk(bank(8192), 6, 5, 50, 1909) is None
    # a small bank: the launch grid's cap, 65535 // Kmax = 10922 lanes,
    # in equal chunks
    assert tv.pair_estep_cuda.MAX_GRID_Y // 6 == 10922
    assert tv.lane_chunk(bank(40), 6, 5, 50, 20_000) == 10_000


def test_grid_path_runs_with_jax_blocked():
    """The grid, its rescoring and run_vbhem import and run with jax and
    the JAX package blocked (as on the machine with the card)."""
    code = (
        "import sys, dataclasses\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vbhem_tpu'] = None\n"
        "import torch\n"
        "from vbhem_tpu_torch import VBHEMConfig\n"
        "from vbhem_tpu_torch.models import vbhem, rescore\n"
        "from vbhem_tpu_torch.experiments import synthetic\n"
        "from vbhem_tpu_torch.utils.planted import planted_bank\n"
        "base, _ = planted_bank(8, torch.device('cpu'), torch.float32)\n"
        "cfg = VBHEMConfig(trials=2, nv=10, tau=3, max_iter=5,\n"
        "                  initmode='baseem', learn_hyps=False,\n"
        "                  m0=(13.0, 10.0), w0=1.0)\n"
        "res, info = vbhem.cluster_batched(torch.Generator(), base,\n"
        "                                  [1, 2], [1, 2], cfg)\n"
        "assert synthetic.default_vbhem_config().trials == 50\n"
        "print(info['model_best_k'], info['model_ll'].shape)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["(2,", "2)"]
