"""Plain reference of the face demo's first stage (`vbdemo_face.m:21-40`):
each subject's HMM learned for every K of a list, its restarts from GMM
starts, the VBEM of ``reference/vbem.py`` to convergence, the restart
picked on its bound and the K on bound + lgamma(K+1)
(`vbhmm_learn.m:364-437`, `:391`).

A subject is its real sequences only.  The data comes as the padded bank
the program was handed (x [S, N, T, D], lengths [S, N], each subject's real
sequences first, an absent one of length 0); subjects with the same number
of real sequences run together, trimmed to the group's longest real
sequence, their shorter sequences masked as ``reference/vbem.py`` masks
them.  No sequence of length 0 reaches the reference.

The starts are restated from the uniforms the program drew
(``reference/starts.py``): per K, in the list's order, one float64 uniform
per subject, restart and point of the padded bank [S, L, N*T], L = 1 for
K = 1.  A restart's start means are the K real points of the subject with
the largest uniforms; no padded point seeds one.

Everything runs in the dtype asked for (float64 for the reference, lower
for its control), with TF32 off for any float32 product on the card.
Plain PyTorch; it imports nothing of the program under test.
"""
from __future__ import annotations

import math

import torch

from . import starts as rstarts
from . import vbem as rvbem

F64 = torch.float64


class no_tf32:
    """float32 matrix products in float32, not TF32, inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def trial_groups(lengths, subjects=None) -> list:
    """The subjects (all, or those of ``subjects``) grouped by their
    number of real sequences: [(positions in ``subjects``, indices into
    the bank, n)]."""
    if subjects is None:
        subjects = torch.arange(lengths.shape[0], device=lengths.device)
    counts = torch.sum(lengths[subjects] > 0, dim=-1)
    out = []
    for n in sorted(set(counts.tolist())):
        pos = torch.nonzero(counts == n).flatten()
        out.append((pos, subjects[pos], n))
    return out


def real_trials(x, lengths, idx, n: int):
    """The real sequences of subjects ``idx`` (each with ``n``): x
    [B, n, T', D] and mask [B, n, T'], T' the longest of them, and the
    index of each of their points in the padded bank's N*T points."""
    ln = lengths[idx, :n]
    t_real = max(int(torch.max(ln)), 1)
    t_bank = x.shape[2]
    pos = (torch.arange(n, device=x.device)[:, None] * t_bank
           + torch.arange(t_real, device=x.device)[None, :]).flatten()
    mask = torch.arange(t_real, device=x.device) < ln[..., None]
    return x[idx, :n, :t_real], mask, pos


def _lanes(post: rvbem.Post, b: int, lanes: int) -> rvbem.Post:
    return rvbem.Post(*(a.reshape((b * lanes,) + a.shape[2:]) for a in post))


def em(x, mask, post: rvbem.Post, hyps: rvbem.Hyps, max_iter: int,
       min_diff: float):
    """``reference/vbem.em``'s loop, also returning each lane's last
    bound: the bound of the posterior its final iteration started from,
    the bound a VBEM run reports.  (final posteriors, last bound [B])."""
    dtype, dev = post.alpha.dtype, post.alpha.device
    b = post.alpha.shape[0]
    last = torch.full((b,), -torch.finfo(dtype).max, dtype=dtype,
                      device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for it in range(max_iter):
        ll, new = rvbem.iteration(x, mask, post, hyps)
        unstable = torch.isnan(ll)
        keep = ~done & ~unstable
        post = rvbem.Post(*(torch.where(keep.reshape((b,) + (1,) * (
            a.dim() - 1)), a, o) for a, o in zip(new, post)))
        conv = (it > 0) & (torch.abs((ll - last) / last) <= min_diff)
        last = torch.where(done, last, ll)
        done = done | conv | unstable
        if bool(torch.all(done)):
            break
    return post, last


def draws(gen, n_subjects: int, restarts: list, points: int, subjects):
    """The program's start uniforms for every K of the list, in its order
    ([S, L, points] each, drawn on the generator's device), each kept only
    for ``subjects``."""
    out = []
    for lanes in restarts:
        u = rstarts.gmm_draws(gen, n_subjects, lanes, points)
        out.append(u[subjects.to(u.device)].clone())
        del u
    return out


def restarts(x, lengths, subjects, u, k: int, hyps: rvbem.Hyps, cfg: dict,
             dtype=F64, pick_dtype=F64, pick: str = "final"):
    """Every restart of one K for ``subjects``, from the start uniforms
    ``u`` [B, L, N*T] (rows in the order of ``subjects``), run in
    ``dtype`` to convergence; each subject's best restart by its bound in
    ``pick_dtype`` at the final model (``pick='final'``) or by the bound of
    its last iteration (``'last'``).  Returns (the picked posteriors
    [B, K, ...], their bound in float64 [B]) in the order of
    ``subjects``."""
    b = len(subjects)
    post_out, score_out = None, torch.empty(b, dtype=F64, device=x.device)
    for pos, idx, n in trial_groups(lengths, subjects):
        xs, ms, ppos = real_trials(x, lengths, idx, n)
        xs = xs.to(dtype)
        lanes = u.shape[1]
        w_pt = ms.flatten(1).to(dtype)
        ug = u[pos.to(u.device)][..., ppos.to(u.device)].to(x.device)
        ug = torch.where(w_pt[:, None, :] > 0, ug, -1.0)
        weight, mean, cov = rstarts.gmm(xs.flatten(1, 2), w_pt, ug, k)
        post0 = rstarts.vbem_start(weight, mean, cov,
                                   torch.sum(w_pt, -1)[:, None], hyps)
        bg = len(idx)
        xl = xs.repeat_interleave(lanes, 0)
        ml = ms.repeat_interleave(lanes, 0)
        post, last = em(xl, ml, _lanes(post0, bg, lanes), hyps,
                        cfg["max_iter"], cfg["min_diff"])
        if pick == "final":
            e, _ = rvbem.iteration(xl.to(pick_dtype), ml,
                                   rvbem.cast(post, pick_dtype), hyps)
        else:
            e = last
        e = torch.nan_to_num(e.to(F64), nan=-math.inf).reshape(bg, lanes)
        best = torch.argmax(e, 1) + torch.arange(bg, device=e.device) * lanes
        picked = rvbem.Post(*(a[best] for a in post))
        if post_out is None:
            post_out = rvbem.Post(*(torch.zeros((b,) + a.shape[1:],
                                                dtype=a.dtype,
                                                device=a.device)
                                    for a in picked))
        for full, part in zip(post_out, picked):
            full[pos] = part
        score_out[pos] = torch.max(e, 1).values
    return post_out, score_out


def select(x, lengths, subjects, us: list, ks: list, hyps: rvbem.Hyps,
           cfg: dict, dtype=F64, pick_dtype=F64, pick: str = "final"):
    """The whole stage for ``subjects``: every K's restarts
    (:func:`restarts`, ``us[i]`` the uniforms of ``ks[i]``), then each
    subject's K by its picked bound + lgamma(K+1).  Returns (the chosen K
    [B] as a list, the per-K picked posteriors, the corrected scores
    [B, len(ks)] in float64)."""
    with no_tf32():
        picked, scores = [], []
        for k, u in zip(ks, us):
            post, score = restarts(x, lengths, subjects, u, k, hyps, cfg,
                                   dtype, pick_dtype, pick)
            picked.append(post)
            scores.append(score + math.lgamma(k + 1))
        corrected = torch.stack(scores, 1)
        chosen = [ks[c] for c in torch.argmax(corrected, 1).tolist()]
    return chosen, picked, corrected


def iteration(x, lengths, subjects, post: rvbem.Post, hyps: rvbem.Hyps,
              dtype=F64, center: bool = False):
    """One EM iteration of ``reference/vbem.py`` in ``dtype`` for each of
    ``subjects`` (models of one K, rows in the order of ``subjects``) on its
    real sequences: (the bound at ``post`` [B], the M-step's posterior),
    in ``dtype``.

    With ``center`` each subject's points, posterior means and prior mean
    are first shifted by the mean of its real points (in float64), which
    moves no bound, and the new means shifted back in float64: a low
    precision's second moments then keep their digits at pixel
    coordinates."""
    b = len(subjects)
    bound = torch.empty(b, dtype=dtype, device=x.device)
    new = rvbem.Post(*(torch.empty(a.shape, dtype=dtype, device=a.device)
                       for a in post))
    with no_tf32():
        for pos, idx, n in trial_groups(lengths, subjects):
            xs, ms, _ = real_trials(x, lengths, idx, n)
            p = rvbem.Post(*(a[pos] for a in post))
            h = hyps
            if center:
                w = ms[..., None].to(F64)
                c = torch.sum(xs.to(F64) * w, (1, 2)) / torch.sum(w, (1, 2))
                xs = torch.where(ms[..., None], xs.to(F64) - c[:, None, None],
                                 0.0)
                p = p._replace(m=p.m.to(F64) - c[:, None])
                h = hyps._replace(m0=torch.as_tensor(
                    hyps.m0, dtype=F64, device=c.device) - c[:, None])
            e, p1 = rvbem.iteration(xs.to(dtype), ms, rvbem.cast(p, dtype),
                                    h)
            if center:
                p1 = p1._replace(m=(p1.m.to(F64) + c[:, None]).to(dtype))
            bound[pos] = e
            for full, part in zip(new, p1):
                full[pos] = part
    return bound, new
