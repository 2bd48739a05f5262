"""A ragged bank: ``batch.learn_bank`` over viewers with different numbers
of trials and trial lengths, and K given as a list (the face demo's first
stage, `vbdemo_face.m:21-40`), in float64 on the CPU.

* Padding changes nothing: each viewer's models, bounds, iterations and K
  from the ragged bank equal those of ``learn_bank`` on that viewer alone,
  unpadded, from the same starts (1e-10).
* Each viewer's K and bound equal those of the benchmark's plain reference
  (``gpubench/reference/select.py``: real trials only, the starts restated
  from the program's uniforms), and of ``vbhmm.learn`` on one viewer.
* The plain E-step gives an empty sequence exactly zero responsibilities,
  statistics and bound terms, and the GMM start never seeds from a padded
  point.

On the card (marked ``card``, skipped here; no JAX is imported, so run
there with ``python3 -m pytest --noconftest -o addopts="" -p
no:cacheprovider -m card -v tests/test_torch_ragged_bank.py``): kernel
B2's fused entry and entry 1 with empty sequences, float32 and float64,
K = 1..3, against the plain version on the same padded input and on the
input without the empty sequences.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vbhem_tpu_torch import VBConfig
from vbhem_tpu_torch.containers import SeqBatch
from vbhem_tpu_torch.models import batch as tbatch
from vbhem_tpu_torch.models import vbhmm as tv
from vbhem_tpu_torch.ops import fb as tfb
from vbhem_tpu_torch.ops import gmm as tgmm
from vbhem_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench.reference import select as rselect  # noqa: E402
from gpubench.reference import vbem as rvbem  # noqa: E402

KS = [1, 2, 3]
CFG = VBConfig(alpha0=1.0, epsilon0=1.0, beta0=1.0, v0=10.0, mu0=(0.0, 0.0),
               w0=0.1, numtrials=3, max_iter=60, min_diff=1e-6,
               learn_hyps=False)
MEANS = np.array([[0.0, 0.0], [6.0, 0.0], [3.0, 5.0]])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")


def ragged_viewers(seed=3, n_viewers=6, trials=(2, 5), fixations=(1, 7)):
    """Viewers of 1-3 well separated states, ``trials`` trials of
    ``fixations`` fixations each (inclusive ranges): the padded bank
    (x [S, N, T, 2], lengths [S, N], real trials first, zeros past each
    trial's end) and one unpadded SeqBatch a viewer, float64."""
    rng = np.random.default_rng(seed)
    n_max, t_max = trials[1], fixations[1]
    x = np.zeros((n_viewers, n_max, t_max, 2))
    lengths = np.zeros((n_viewers, n_max), np.int32)
    for v in range(n_viewers):
        k = v % 3 + 1
        trans = np.full((k, k), 0.2 / max(k - 1, 1)) + np.eye(k) * (
            0.8 - 0.2 / max(k - 1, 1)) if k > 1 else np.ones((1, 1))
        n = rng.integers(trials[0], trials[1] + 1)
        for i in range(n):
            t = rng.integers(fixations[0], fixations[1] + 1)
            z = rng.integers(k)
            for j in range(t):
                x[v, i, j] = MEANS[z] + 0.7 * rng.standard_normal(2)
                z = rng.choice(k, p=trans[z])
            lengths[v, i] = t
    # the bank's own layout: as many trials and steps as the longest
    n_used = int(np.max(np.sum(lengths > 0, -1)))
    x = torch.as_tensor(x[:, :n_used, :lengths.max()])
    lengths = torch.as_tensor(lengths[:, :n_used])
    batches = []
    for v in range(n_viewers):
        n = int(torch.sum(lengths[v] > 0))
        t = int(torch.max(lengths[v]))
        batches.append(SeqBatch(x=x[v, :n, :t], lengths=lengths[v, :n]))
    return x, lengths, batches


def start_means(batches, seed=11):
    """Fixed GMM start means per viewer and K ([L, K, D]): K distinct real
    points of the viewer for each restart."""
    rng = np.random.default_rng(seed)
    out = []
    for b in batches:
        pts = b.x[b.mask]
        per_k = {}
        for k in KS:
            lanes = 1 if k == 1 else CFG.numtrials
            per_k[k] = torch.stack([pts[torch.as_tensor(
                rng.choice(len(pts), k, replace=False))]
                for _ in range(lanes)])
        out.append(per_k)
    return out


def test_padding_changes_nothing(monkeypatch):
    """The ragged bank against each viewer alone, unpadded, from the same
    GMM start means: models, bounds, each restart's EM iterations and the
    selected K."""
    x, lengths, batches = ragged_viewers()
    means = start_means(batches)
    current = []

    def fixed_init(gen, bank, k, hyps, covar_type="full", lanes=()):
        xs, w = tv._pooled(bank)
        mean0 = torch.stack([means[v][k] for v in current])
        g = tgmm.fit_gmm_from_means(xs, mean0, w)
        return tv._from_gmm(bank, g, hyps, covar_type, 1)

    iters = []
    em = tv.vbem_em

    def counted(*a, **kw):
        st = em(*a, **kw)
        iters.append(st.it.clone())
        return st

    monkeypatch.setattr(tv, "random_init", fixed_init)
    monkeypatch.setattr(tv, "vbem_em", counted)
    gen = torch.Generator().manual_seed(0)
    current[:] = range(len(batches))
    bank_res, bank_info = tbatch.learn_bank(gen, batches, KS, CFG)
    bank_iters = list(iters)
    assert bank_info["model_k"] == KS
    assert sorted(set(bank_info["model_best_k"])) != [1]
    for v, b in enumerate(batches):
        current[:] = [v]
        iters.clear()
        res, info = tbatch.learn_bank(gen, [b], KS, CFG)
        assert info["model_best_k"] == [bank_info["model_best_k"][v]]
        np.testing.assert_allclose(info["model_ll"][0],
                                   bank_info["model_ll"][v], rtol=1e-10)
        for it_bank, it_one in zip(bank_iters, iters):
            assert torch.equal(it_bank[v], it_one[0])
        got, want = bank_res[v], res[0]
        n, t = b.x.shape[:2]
        for f in ("ll", "counts_n1", "counts", "trans_counts"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=1e-10, atol=1e-12)
        for a, w in zip((got.post.alpha, got.post.epsilon, *got.post.niw),
                        (want.post.alpha, want.post.epsilon,
                         *want.post.niw)):
            torch.testing.assert_close(a, w, rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(got.gamma[:n, :t], want.gamma,
                                   rtol=1e-10, atol=1e-12)
        assert torch.all(got.gamma[n:] == 0) and torch.all(
            got.gamma[:, t:] == 0)
        for per_k, one in zip(bank_info["model_all"], info["model_all"]):
            torch.testing.assert_close(per_k.ll[v], one.ll[0], rtol=1e-10,
                                       atol=0)


def _ref_hyps():
    return rvbem.Hyps(alpha0=CFG.alpha0, epsilon0=CFG.epsilon0,
                      beta0=CFG.beta0, v0=CFG.v0, m0=CFG.mu0,
                      w0=(CFG.w0,) * 2)


def test_selection_matches_the_plain_reference():
    """The program's float64 run from its own draws against the plain
    reference restating the same starts on each viewer's real trials: the
    same K for every viewer, its picked restart's last bound and the bound
    at the selected model equal at 1e-10."""
    x, lengths, batches = ragged_viewers(seed=5)
    seed = 2 ** 33 + 17
    res, info = tbatch.learn_bank(torch.Generator().manual_seed(seed),
                                  batches, KS, CFG)
    s, n, t, _ = x.shape
    subjects = torch.arange(s)
    restarts = [1 if k == 1 else CFG.numtrials for k in KS]
    us = rselect.draws(torch.Generator().manual_seed(seed), s, restarts,
                       n * t, subjects)
    cfg = {"max_iter": CFG.max_iter, "min_diff": CFG.min_diff}
    chosen, picked, corrected = rselect.select(x, lengths, subjects, us, KS,
                                               _ref_hyps(), cfg, pick="last")
    assert chosen == info["model_best_k"]
    np.testing.assert_allclose(info["model_ll"], corrected.numpy(),
                               rtol=1e-10)
    for v, r in enumerate(res):
        k = chosen[v]
        assert r.post.alpha.shape[-1] == k
        np.testing.assert_allclose(
            float(r.ll) + math.lgamma(k + 1),
            float(corrected[v, KS.index(k)]), rtol=1e-10)
        ref = rvbem.Post(*(a[v:v + 1] for a in picked[KS.index(k)]))
        got = rvbem.Post(r.post.alpha[None], r.post.epsilon[None],
                         r.post.niw.beta[None], r.post.niw.v[None],
                         r.post.niw.m[None], r.post.niw.w[None])
        one = torch.tensor([v])
        e_ref = rselect.iteration(x, lengths, one, ref, _ref_hyps())[0]
        e_got = rselect.iteration(x, lengths, one, got, _ref_hyps())[0]
        torch.testing.assert_close(e_got, e_ref, rtol=1e-10, atol=0)


def test_list_of_k_on_one_viewer_is_vbhmm_learn():
    """``learn_bank`` over a list of K on one viewer is ``vbhmm.learn``'s
    selection (`vbhmm_learn.m:391`): the same draws, the same K and
    model."""
    _, _, batches = ragged_viewers(seed=7)
    b = batches[2]
    res, info = tbatch.learn_bank(torch.Generator().manual_seed(4), [b], KS,
                                  CFG)
    one, one_info = tv.learn(torch.Generator().manual_seed(4), b, KS, CFG)
    assert info["model_best_k"] == [one_info["model_best_k"]]
    np.testing.assert_allclose(info["model_ll"][0], one_info["model_ll"],
                               rtol=1e-12)
    torch.testing.assert_close(res[0].post.niw.m, one.post.niw.m,
                               rtol=1e-12, atol=1e-12)


def test_learn_bank_records_pad_select_and_counters():
    x, lengths, batches = ragged_viewers(seed=9)
    s, n, t, _ = x.shape
    with profiling.recording() as rec:
        res, info = tbatch.learn_bank(torch.Generator().manual_seed(1),
                                      batches, KS, CFG)
    names = [sp.name for sp in rec.spans]
    assert names.count("learn_bank") == 1
    assert names.count("learn_bank.pad") == 1
    assert names.count("learn_bank.select") == 1
    for phase in ("starts", "em", "pick"):
        assert names.count(f"learn_bank.{phase}") == len(KS)
    restarts = sum(1 if k == 1 else CFG.numtrials for k in KS)
    c = rec.counters
    assert c["learn_bank.seqs_padded"] == int(torch.sum(lengths == 0))
    assert c["learn_bank.steps_valid"] == int(torch.sum(lengths)) * restarts
    assert c["learn_bank.steps_launched"] == s * n * t * restarts
    assert sum(c[f"learn_bank.selected_k.{k}"] for k in KS) == s
    for k in KS:
        assert c[f"learn_bank.selected_k.{k}"] == \
            info["model_best_k"].count(k)
    assert info["model_em_iters"] == sum(
        i["model_em_iters"] for i in info["model_infos"])
    assert [int(r.post.alpha.shape[-1]) for r in res] == info["model_best_k"]
    # a single K keeps the single-K info and no selection
    with profiling.recording() as rec:
        res, info = tbatch.learn_bank(torch.Generator().manual_seed(1),
                                      batches, 2, CFG)
    assert set(info) == {"model_em_iters"}
    assert "learn_bank.select" not in [sp.name for sp in rec.spans]
    assert all(r.post.alpha.shape[-1] == 2 for r in res)


def test_empty_sequence_contributes_exactly_nothing():
    """The plain E-step's gamma, xi_sum, phi_norm and masked log_rho of an
    empty sequence are exactly 0, and the statistics and bound equal those
    of the batch without it."""
    x, lengths, batches = ragged_viewers(seed=13)
    v = int(torch.argmin(torch.sum(lengths > 0, -1)))
    bank = SeqBatch(x=x[v], lengths=lengths[v])             # with empties
    real = batches[v]
    empty = lengths[v] == 0
    assert torch.any(empty)
    hyps = tv.VBHyps.from_config(CFG, 2, torch.float64, "cpu")
    post = tv.random_init(torch.Generator().manual_seed(0), real, 3, hyps)
    fb = tv.e_step(bank, post)
    for f in ("log_rho", "gamma", "xi_sum", "phi_norm"):
        assert torch.all(getattr(fb, f)[empty] == 0.0), f
    fb_real = tv.e_step(real, post)
    st, st_real = tv.suff_stats(bank, fb), tv.suff_stats(real, fb_real)
    for a, b in zip(st, st_real):
        torch.testing.assert_close(a, b, rtol=1e-13, atol=0)
    torch.testing.assert_close(tv.elbo(bank, post, fb, st, hyps),
                               tv.elbo(real, post, fb_real, st_real, hyps),
                               rtol=1e-13, atol=0)


def test_gmm_start_never_seeds_from_a_padded_point(monkeypatch):
    """The random-sample start of the ragged bank's GMM fits picks only
    real points (padded steps and empty trials have weight 0), and a bank
    without padding draws the same uniforms as before."""
    x, lengths, batches = ragged_viewers(seed=17)
    bank, added = tbatch.pad_bank(batches)
    assert torch.equal(bank.x, x) and torch.equal(bank.lengths, lengths)
    assert added == int(torch.sum(lengths == 0))
    seen = []
    fit = tgmm.fit_gmm_from_means

    def spy(xs, mean0, weights, *a, **kw):
        seen.append((xs, mean0, weights))
        return fit(xs, mean0, weights, *a, **kw)

    monkeypatch.setattr(tgmm, "fit_gmm_from_means", spy)
    hyps = tv.VBHyps.from_config(CFG, 2, torch.float64, "cpu")
    tv.random_init(torch.Generator().manual_seed(2), bank, 3, hyps,
                   lanes=(40,))
    xs, mean0, w = seen[0]
    checked = 0
    for s in range(xs.shape[0]):
        real = xs[s][w[s] > 0]
        if len(real) < 3:           # fewer real points than K
            continue
        hit = (mean0[s][..., None, :] == real).all(-1).any(-1)
        assert torch.all(hit), s
        checked += 1
    assert checked >= 4
    # no padding: the start is the uniform draw's top K, as before
    full = SeqBatch(x=x[:, :2, :1], lengths=torch.ones(6, 2,
                                                        dtype=torch.int32))
    seen.clear()
    tv.random_init(torch.Generator().manual_seed(2), full, 2, hyps,
                   lanes=(5,))
    u = torch.rand((6, 5, 2), generator=torch.Generator().manual_seed(2),
                   dtype=torch.float64)
    idx = torch.topk(u, 2, dim=-1).indices
    want = torch.gather(full.x.flatten(1, 2)[:, None].expand(-1, 5, -1, -1),
                        -2, idx[..., None].expand(idx.shape + (2,)))
    assert torch.equal(seen[0][1], want)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _b2_case(k, dtype, dev):
    """A padded batch of 2 subjects x 3 restarts with empty sequences, its
    emission constants and scores, on ``dev``."""
    x, lengths, _ = ragged_viewers(seed=19 + k, n_viewers=2,
                                   trials=(3, 6), fixations=(1, 9))
    lengths[0, -1] = 0                  # at least one empty sequence
    x[0, -1] = 0.0
    rng = np.random.default_rng(k)
    lanes = (2, 3)
    d = 2
    a = rng.normal(size=lanes + (k, d, d))
    niw = tfb.NIW(beta=torch.as_tensor(rng.uniform(5, 20, lanes + (k,))),
                  v=torch.as_tensor(rng.uniform(8, 30, lanes + (k,))),
                  m=torch.as_tensor(MEANS[:k] + rng.normal(
                      size=lanes + (k, d))),
                  w=torch.as_tensor(np.einsum("...ij,...kj->...ik", a, a)
                                    / 10 + 0.1 * np.eye(d)))
    log_pz1 = torch.as_tensor(np.log(rng.dirichlet(np.ones(k), lanes) * .8))
    log_trans = torch.as_tensor(
        np.log(rng.dirichlet(np.ones(k), lanes + (k,)) * .9))
    xs = x[:, None]                                        # [2, 1, N, T, D]
    mask = (torch.arange(x.shape[2]) < lengths[..., None])[:, None]
    return tuple(a.to(dev, dtype) if a.is_floating_point() else a.to(dev)
                 for a in (xs, mask, log_pz1, log_trans)) + (
        tfb.NIW(*(a.to(dev, dtype) for a in niw)),)


@pytest.mark.card
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("entry", ["fused", "entry1"])
def test_card_b2_empty_sequences(card, entry, dtype, k):
    from vbhem_tpu_torch.ops import fb_cuda
    dev = torch.device("cuda")
    xs, mask, p, a, niw = _b2_case(k, dtype, dev)
    log_rho = tfb.expected_log_gauss(xs, niw)
    if entry == "fused":
        got = fb_cuda.e_step_fused(xs, mask, p, a,
                                   tfb.emission_constants(niw))
    else:
        got = fb_cuda.forward_backward_auto(p, a, log_rho.contiguous(), mask)
    torch.cuda.synchronize()
    f64 = [q.double() for q in (p, a, log_rho)]
    want = tfb.forward_backward(*f64, mask)
    tol = dict(rtol=1e-10, atol=1e-12) if dtype == torch.float64 else \
        dict(rtol=5e-5, atol=5e-5)
    for f in ("log_rho", "gamma", "xi_sum", "phi_norm"):
        torch.testing.assert_close(getattr(got, f).double(),
                                   getattr(want, f), **tol, msg=f)
    full = torch.broadcast_to(mask, got.gamma.shape[:-1])
    empty = ~full[..., 0]
    assert torch.any(empty)
    for f in ("gamma", "xi_sum", "phi_norm", "log_rho"):
        assert torch.all(getattr(got, f)[empty] == 0), f
    # each subject's statistics without its empty sequences
    for sbj in range(xs.shape[0]):
        keep = ~empty[sbj, 0]
        alone = tfb.forward_backward(f64[0][sbj], f64[1][sbj],
                                     f64[2][sbj][:, keep], mask[sbj][:, keep])
        for f in ("gamma", "xi_sum", "phi_norm"):
            torch.testing.assert_close(getattr(got, f)[sbj][:, keep].double(),
                                       getattr(alone, f), **tol, msg=f)
