"""End-to-end demo: a fixation table -> per-subject VBEM -> VBHEM
clustering -> pruning -> plots, the path of the reference's
`demo/vbdemo_face.m`: the counterpart of the JAX package's
``examples/demo_fixations.py``.

Learn an HMM per subject from its fixation sequences with selection over
S = 1..3, cluster the subjects' HMMs with VBHEM over K = 1..5, prune the
empty clusters and states (``vbh3m_remove_empty``) and plot the group
models.  The reference's dataset (`demo/demodata.xls`) is not shipped;
without ``--xls`` the demo draws synthetic face-viewing data instead: two
viewer groups ("holistic" and "analytic") with different ROI dynamics on
a 512 x 384 image (:func:`synth_subjects`).  ``--xls`` reads a
SubjectID/TrialID/FixX/FixY[/FixD] table (CSV through the native loader
where it builds, legacy .xls through this package's BIFF8 reader, .xlsx
through pandas) and runs the reference demo's settings.

Plots need matplotlib and are skipped, with a note, where it is not
installed.  Example (a quick run on the CPU):

  python -m vbhem_tpu_torch.experiments.demo_fixations --quick \\
      --device cpu --out /tmp/demo
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..config import VBConfig, VBHEMConfig
from ..containers import HMM, SeqBatch

FACE = (512, 384)          # the synthetic face image, width x height
_EYE_L, _EYE_R, _MOUTH = [180.0, 140.0], [330.0, 140.0], [255.0, 280.0]


def face_hmms(device="cpu", dtype=torch.float64):
    """The two viewer groups' ground-truth HMMs on the synthetic face:
    'holistic' (center and both eyes) and 'analytic' (eyes and mouth),
    with ROIs of 28 pixels' standard deviation."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    cov = t(np.broadcast_to((28.0 ** 2) * np.eye(2), (3, 2, 2)).copy())
    holistic = HMM(prior=t([0.6, 0.2, 0.2]),
                   trans=t([[0.6, 0.2, 0.2], [0.5, 0.4, 0.1],
                            [0.5, 0.1, 0.4]]),
                   mean=t([[255.0, 170.0], _EYE_L, _EYE_R]), cov=cov)
    analytic = HMM(prior=t([0.45, 0.45, 0.1]),
                   trans=t([[0.5, 0.4, 0.1], [0.4, 0.5, 0.1],
                            [0.3, 0.3, 0.4]]),
                   mean=t([_EYE_L, _EYE_R, _MOUTH]), cov=cov)
    return holistic, analytic


def synth_subjects(gen: torch.Generator, n_per_group: int = 5,
                   n_trials: int = 12, t: int = 12, device="cuda",
                   dtype=torch.float64):
    """Two groups of ``n_per_group`` synthetic viewers, each ``n_trials``
    trials of ``t`` fixations drawn from its group's HMM
    (:func:`face_hmms`) with ``gen``.  Returns (per-subject SeqBatches on
    ``device``, group labels [2 * n_per_group])."""
    from ..models import hmm_tools
    batches, labels = [], []
    for gi, gt in enumerate(face_hmms(device, dtype)):
        for _ in range(n_per_group):
            _, x = hmm_tools.sample(gen, gt, t=t, n=n_trials)
            batches.append(SeqBatch(x=x, lengths=torch.full(
                (n_trials,), t, dtype=torch.int32, device=x.device)))
            labels.append(gi)
    return batches, np.asarray(labels)


def reference_vb_config(mu0=(160.0, 210.0), **kw) -> VBConfig:
    """The reference demo's VBEM settings (`vbdemo_face.m:21-40`):
    alpha0 = epsilon0 = beta0 = 1, v0 = 10, W0 = 0.001, mu0 the image
    center (the reference's 320 x 420 face: (160, 210)), hyps learned,
    50 restarts (the vbopt default)."""
    return VBConfig(**{**dict(alpha0=1.0, epsilon0=1.0, beta0=1.0, v0=10.0,
                              w0=0.001, mu0=tuple(mu0), learn_hyps=True),
                       **kw})


def reference_vbhem_config(m0=(160.0, 210.0), **kw) -> VBHEMConfig:
    """The reference demo's VBHEM settings (`vbdemo_face.m:46-67`):
    K = 1..5 x S = 1..3 (see REFERENCE_GRID), 'wtkmeans', Nv = 10,
    tau = 5, 50 restarts, alpha0 = eta0 = epsilon0 = lambda0 = 1, v0 = 10,
    W0 = 0.001, m0 the image center, hyps learned (the vbhemopt default,
    `vbhem_h3m_cluster.m:188`)."""
    return VBHEMConfig(**{**dict(alpha0=1.0, eta0=1.0, epsilon0=1.0,
                                 lambda0=1.0, v0=10.0, w0=0.001,
                                 m0=tuple(m0), trials=50, nv=10, tau=5,
                                 initmode="wtkmeans"), **kw})


REFERENCE_GRID = ([1, 2, 3, 4, 5], [1, 2, 3])


def synthetic_vbhem_config(vb_cfg: VBConfig, **kw) -> VBHEMConfig:
    """The VBHEM settings the demo runs on its synthetic data (the JAX
    package's ``examples/demo_fixations.py``): the VBEM stage's mu0 and
    W0 as m0 and W0, alpha0 = 1e6, which keeps weakly evidenced clusters
    alive as in the paper's synthetic experiment (`exprmt1_demo.m:72`),
    10 restarts, Nv = 50, tau = 10, 'auto', hyps off."""
    return VBHEMConfig(**{**dict(alpha0=1e6, m0=vb_cfg.mu0, w0=vb_cfg.w0,
                                 trials=10, nv=50, tau=10, initmode="auto",
                                 learn_hyps=False), **kw})


def learn_subjects(gen: torch.Generator, batches, s_grid, cfg: VBConfig):
    """Per-subject VBEM with selection over ``s_grid``
    (`vbdemo_face.m:21-40`): each subject keeps the S that maximizes its
    bound + lgamma(S+1), as ``vbhmm.learn`` selects over K (the float64
    bound where compute is float32).  One call of ``batch.learn_bank``,
    whose padded bank takes subjects of any shape.  Returns (results,
    selected S per subject)."""
    from ..models import batch as vbem_batch
    results, info = vbem_batch.learn_bank(gen, batches, list(s_grid), cfg)
    return results, info["model_best_k"]


def cluster_subjects(gen: torch.Generator, results, k_grid, s_grid,
                     cfg: VBHEMConfig):
    """VBHEM over the (K, S) grid on the subjects' HMMs
    (``cluster_batched``, `vbdemo_face.m:46-67`), then
    ``vbh3m_remove_empty`` (`:67`).  Returns (pruned result, per-cluster
    pruned HMMs, info)."""
    from ..models import vbhem
    base = vbhem.h3m_from_results(results, device=results[0].ll.device)
    res, info = vbhem.cluster_batched(gen, base, k_grid, s_grid, cfg)
    res, group_hmms = vbhem.vbh3m_remove_empty(res)
    return res, group_hmms, info


def demo_configs(batches, table: bool, quick: bool = False,
                 image_size=None, **vb_kw):
    """The settings of the demo's run, as :func:`main` picks them.

    With ``table`` (a fixation table, ``--xls``) and not ``quick``: the
    reference demo's VBEM settings (:func:`reference_vb_config`, mu0 and
    W0 from ``set_hyperparam`` mode 'c' on ``image_size`` where it is
    given) and VBHEM settings (:func:`reference_vbhem_config`).
    Otherwise the synthetic-data path of the JAX package's example:
    ``VBConfig(numtrials=10, learn_hyps=True)`` with mode 'd' hyps and
    :func:`synthetic_vbhem_config` (``quick``: 3 restarts, no hyps, 30
    iterations, 'baseem').  ``vb_kw`` overrides VBConfig fields.
    Returns (VBConfig, VBHEMConfig, the S grid of VBEM, the (K, S) grid
    of VBHEM)."""
    from ..models.hyp_heuristics import set_hyperparam
    if table and not quick:
        cfg = reference_vb_config(**vb_kw)
        if image_size is not None:
            cfg = set_hyperparam(cfg, batches, "c", image_size)
        return (cfg, reference_vbhem_config(m0=cfg.mu0), [1, 2, 3],
                REFERENCE_GRID)
    cfg = VBConfig(**{**(dict(numtrials=3, learn_hyps=False, max_iter=30)
                         if quick else dict(numtrials=10, learn_hyps=True)),
                      **vb_kw})
    cfg = set_hyperparam(cfg, batches, mode="d")
    vb_cfg = synthetic_vbhem_config(cfg)
    if quick:
        return (cfg, dataclasses.replace(vb_cfg, trials=3,
                                         initmode="baseem"),
                [1, 2], ([1, 2], [2]))
    return cfg, vb_cfg, [1, 2, 3], REFERENCE_GRID


def demo_path(gen: torch.Generator, batches, table: bool,
              quick: bool = False, image_size=None, stage_end=None,
              **vb_kw) -> dict:
    """The demo's run on the subjects' ``batches``: the settings of
    :func:`demo_configs`, per-subject VBEM (:func:`learn_subjects`), then
    VBHEM and pruning (:func:`cluster_subjects`).  ``stage_end(name)``,
    where given, is called as each stage ('vbem', 'vbhem') ends.
    Returns a dict: the configs ('vb_config', 'vbhem_config'), 'results'
    and 's_sel' of VBEM, the pruned 'res', 'group_hmms', the grid's
    'info' and each stage's wall seconds ('wall_s')."""
    cfg, vb_cfg, s_vb, grid = demo_configs(batches, table, quick,
                                           image_size, **vb_kw)
    wall = {}
    t0 = time.perf_counter()
    results, s_sel = learn_subjects(gen, batches, s_vb, cfg)
    if stage_end is not None:
        stage_end("vbem")
    wall["vbem"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, group_hmms, info = cluster_subjects(gen, results, *grid, vb_cfg)
    if stage_end is not None:
        stage_end("vbhem")
    wall["vbhem"] = time.perf_counter() - t0
    return {"vb_config": cfg, "vbhem_config": vb_cfg, "grid": grid,
            "results": results, "s_sel": s_sel, "res": res,
            "group_hmms": group_hmms, "info": info, "wall_s": wall}


def _plots(out, names, results, batches, res, info, image):
    """The demo's figures, where matplotlib is installed; returns the
    files written (none without matplotlib)."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no plots", flush=True)
        return []
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ..utils import plots
    written = []
    for name, r, b in zip(names, results, batches):
        fig = plots.plot_vbhmm(r, batch=b, image=image, title=name)
        written.append(os.path.join(out, f"{name}.png"))
        fig.savefig(written[-1], dpi=80)
        plt.close(fig)
    fig = plots.plot_vbhem_clusters(res, image=image)
    written.append(os.path.join(out, "clusters.png"))
    fig.savefig(written[-1], dpi=80)
    fig2, ax = plt.subplots(figsize=(5, 3.5))
    # per-K best over the S axis (vbdemo_face.m:78 plots model_LL vs K)
    plots.plot_model_selection(ax, np.max(info["model_ll"], axis=1),
                               info["model_k"])
    written.append(os.path.join(out, "model_selection.png"))
    fig2.savefig(written[-1], dpi=80)
    plt.close("all")
    return written


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--xls", default=None,
                    help="fixation table (.csv, .xls or .xlsx)")
    ap.add_argument("--image", default=None,
                    help="background image for the ROI plots (the "
                         "reference demo uses demo/ave_face120.png)")
    ap.add_argument("--out", default="demo_out", help="output directory")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    ap.add_argument("--quick", action="store_true",
                    help="tiny settings for smoke and integration tests")
    args = ap.parse_args(argv)
    from ..utils.metrics import rand_index
    from ..utils.native_io import read_fixations_auto

    os.makedirs(args.out, exist_ok=True)
    device = torch.device(args.device)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    image = None
    if args.image:
        import matplotlib.image as mpimg
        image = mpimg.imread(args.image)

    t0 = time.perf_counter()
    reader = None
    if args.xls:
        subjects, reader = read_fixations_auto(args.xls, device=device)
        names = list(subjects)
        batches = [subjects[n] for n in names]
        labels = None
    else:
        batches, labels = synth_subjects(gen, device=device)
        names = [f"subj{i:02d}" for i in range(len(batches))]
    t_read = time.perf_counter() - t0

    # per-subject VBEM over S (vbdemo_face.m:21-40), then VBHEM over the
    # (K, S) grid (:46-67): the reference's settings on a table, the
    # synthetic-data path of the JAX package's example otherwise
    run = demo_path(gen, batches, table=bool(args.xls), quick=args.quick)
    for n, s_, r in zip(names, run["s_sel"], run["results"]):
        print(f"{n}: best S={s_} LL={float(r.ll):.1f}", flush=True)
    res, group_hmms, info = run["res"], run["group_hmms"], run["info"]
    summary = {"reader": reader, "subjects": len(batches),
               "best_k": info["model_best_k"], "best_s": info["model_best_s"],
               "groups": [[int(i) for i in g] for g in res.groups],
               "states_per_cluster": [int(h.model.prior.shape[0])
                                      for h in group_hmms],
               "wall_s": {"read": t_read, **run["wall_s"]}}
    if labels is not None:
        ari, ri = rand_index(res.label.cpu().numpy(), labels)[:2]
        summary.update(rand_index=ri, adjusted_rand_index=ari)
    summary["plots"] = _plots(args.out, names, run["results"], batches, res,
                              info, image)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
