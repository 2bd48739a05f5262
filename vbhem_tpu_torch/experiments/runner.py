"""The full synthetic benchmark runner: seeded repeats of the multi-method
pipeline with per-stage checkpoints and aggregate recovery statistics —
the counterpart of :mod:`vbhem_tpu.experiments.runner`.

Parity map: `Synthetic_experiment/exprmt1_demo.m` (the staged pipeline,
with `.mat` checkpoints after every stage and repeat,
`exprmt1_demo.m:58-60,96-102,136-142,176-178,256-258`) and the
aggregation of `syn_evluate.m` / `evaluate_vbhem_jounarl.m:450-655`
(Rand index, purity, P(K correct/over/under), P(S correct/over/under)
per method/criterion).

Checkpoints are one pickle per (repeat, stage) in ``outdir``; a rerun
with the same outdir resumes after the last completed stage.  Tensors
are pickled on the CPU and put on the run's device when loaded, so a
checkpoint written on the card loads on the CPU and the other way round.
Checkpoints of the JAX package cannot be loaded here (unpickling them
needs JAX); :func:`load_checkpoint` refuses them with a
:class:`ForeignCheckpointError`.

Seeds: the JAX package derives each stage's key as
``fold_in(key(repeat), tag)``.  Here each stage draws from its own CPU
``torch.Generator`` seeded with :func:`stage_seed` (repeat, tag), NumPy's
``SeedSequence`` of the pair, with the JAX package's tags: 0 the data,
1 VBHEM, 2 VHEM, 3 CCFD, 4 PPK, 5 the Dunn index's distances, 100 + S the
VBEM bank of S states.  A repeat's draws are then the same on any device;
they differ from the JAX package's.
"""
from __future__ import annotations

import json
import os
import pickle
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import HEMConfig, VBConfig, VBHEMConfig
from ..containers import resolve_device
from . import synthetic as syn

GT_K, GT_S = 2, 2

STAGES = ("data", "vbem", "vbhem", "vhem", "ccfd", "ppk", "dist")


class ForeignCheckpointError(RuntimeError):
    """A checkpoint written by the JAX package (or holding JAX arrays),
    which this package cannot unpickle."""


def stage_seed(repeat: int, tag: int) -> int:
    """The seed of stage ``tag`` of repeat ``repeat``: this package's
    stand-in for ``fold_in(key(repeat), tag)``."""
    state = np.random.SeedSequence([int(repeat), int(tag)]).generate_state(
        1, np.uint64)[0]
    return int(state) & ((1 << 63) - 1)


def stage_generator(repeat: int, tag: int) -> torch.Generator:
    """A CPU generator seeded with :func:`stage_seed`."""
    return torch.Generator(device="cpu").manual_seed(stage_seed(repeat, tag))


def _map_tensors(obj, fn):
    """``fn`` applied to every tensor inside NamedTuples, dicts, lists and
    tuples."""
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_map_tensors(v, fn) for v in obj])
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _ckpt_path(outdir: str, repeat: int, stage: str) -> str:
    return os.path.join(outdir, f"r{repeat:03d}_{stage}.pkl")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in ("vbhem_tpu", "jax", "jaxlib"):
            raise ForeignCheckpointError(
                f"{self.path} holds {module}.{name}: it was written by the "
                f"JAX package, whose checkpoints this package cannot load; "
                f"use a fresh outdir")
        return super().find_class(module, name)


def _load(outdir: str, repeat: int, stage: str, device=None):
    p = _ckpt_path(outdir, repeat, stage)
    if not os.path.exists(p):
        return None
    with open(p, "rb") as f:
        up = _Unpickler(f)
        up.path = p
        obj = up.load()
    if device is not None:
        obj = _map_tensors(obj, lambda t: t.to(device))
    return obj


def load_checkpoint(outdir: str, repeat: int, stage: str, device=None):
    """Public checkpoint loader (one pickle per (repeat, stage)); returns
    None when that stage has not completed.  Tensors come back on the CPU,
    or on ``device`` when it is given."""
    return _load(outdir, repeat, stage, device)


def _save(outdir: str, repeat: int, stage: str, obj) -> None:
    p = _ckpt_path(outdir, repeat, stage)
    tmp = p + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_map_tensors(obj, lambda t: t.detach().cpu()), f)
    os.replace(tmp, p)


def _meta_path(outdir: str, repeat: int) -> str:
    return os.path.join(outdir, f"r{repeat:03d}_meta.json")


def _scale_meta(n_per_cluster, n_seqs, t, k_grid, s_grid, dtype) -> Dict:
    """Run-scale descriptor written alongside each repeat's checkpoints
    so aggregates can't silently pool repeats run at different scales.
    ``dtype`` is informational (cross-precision pooling of the SAME
    scale is an intentional consistency check); the scale keys are the
    grouping config."""
    return {"n_per_cluster": int(n_per_cluster), "n_seqs": int(n_seqs),
            "t": int(t), "k_grid": [int(k) for k in k_grid],
            "s_grid": [int(s) for s in s_grid], "dtype": dtype}


_NON_SCALE_KEYS = ("dtype", "provenance")


def _write_meta(outdir: str, repeat: int, meta: Dict) -> None:
    p = _meta_path(outdir, repeat)
    old = _load_meta(outdir, repeat)
    if old is not None:
        old_scale = {k: v for k, v in old.items() if k not in _NON_SCALE_KEYS}
        new_scale = {k: v for k, v in meta.items() if k not in _NON_SCALE_KEYS}
        if old_scale != new_scale:
            raise ValueError(
                f"repeat {repeat} in {outdir} was checkpointed at a "
                f"different scale ({old_scale} != {new_scale}); refusing "
                f"to mix — use a fresh outdir")
        if old.get("provenance") == meta.get("provenance"):
            return
        # upgrade in place: same scale, new/changed provenance stamp
        meta = dict(old, provenance=meta.get("provenance"))
    # tmp+rename: a worker killed mid-write must not truncate the meta
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, p)


def _load_meta(outdir: str, repeat: int) -> Optional[Dict]:
    p = _meta_path(outdir, repeat)
    if os.path.exists(p):
        try:
            with open(p) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            return None
    return None


def _bank_provenance(outdir: str, repeat: int, banks_obj) -> Dict:
    """Identity and creating-code version of a repeat's VBEM bank: the
    stage pickle's sha256 and the ``bank_version`` stored inside it."""
    import hashlib
    p = _ckpt_path(outdir, repeat, "vbem")
    h = None
    if os.path.exists(p):
        sha = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                sha.update(chunk)
        h = sha.hexdigest()[:16]
    return {"bank_sha256": h, "bank_version": banks_obj["bank_version"]}


def run_repeat(repeat: int, outdir: str,
               n_per_cluster: int = 20, n_seqs: int = 25, t: int = 50,
               k_grid=range(1, 7), s_grid=range(1, 6),
               vb_config: Optional[VBConfig] = None,
               vbhem_config: Optional[VBHEMConfig] = None,
               hem_config: Optional[HEMConfig] = None,
               methods=("vbhem", "vhem", "ccfd", "ppk"),
               verbose: bool = True, dtype: Optional[str] = None,
               device="cuda") -> Dict:
    """One repeat of the benchmark (`exprmt1_demo.m` outer iteration,
    seeded `rng(it)`-style by :func:`stage_seed`), on ``device`` (the card
    unless the caller names another).  ``dtype`` is "f32" or "f64": the
    compute precision, by default "f32" on the card and "f64" on the CPU;
    the data is drawn and stored in float64 and cast to it.

    Returns the scores, the stages' wall times (or ``<stage>_error``: a
    stage that raises is reported there and the others still run), the
    Dunn indices, and under ``work`` the kernel work of each stage run in
    this call (none for a stage loaded from its checkpoint): ``vbem``
    EM iterations and final E-steps of every bank (B2 each), ``vbhem`` the
    grid's EM iterations of every lane chunk and of the hyp objective and
    rerun, and its final E-steps (B1 each), its rescored cells and DIC
    cells (B3 each), ``vhem`` the grid's EM iterations (B3 each)."""
    device = resolve_device(device)
    dtype = dtype or ("f32" if device.type == "cuda" else "f64")
    if dtype not in ("f32", "f64"):
        raise ValueError(f"dtype must be 'f32' or 'f64', not {dtype!r}")
    scores: Dict[str, syn.RecoveryScore] = {}
    timings: Dict[str, float] = {}
    work: Dict[str, Dict] = {}
    _write_meta(outdir, repeat,
                _scale_meta(n_per_cluster, n_seqs, t, k_grid, s_grid,
                            dtype))

    def log(msg):
        if verbose:
            print(f"[repeat {repeat}] {msg}", flush=True)

    def load(stage):
        return _load(outdir, repeat, stage, device)

    def failed(stage, e):
        log(f"{stage} FAILED: {e!r}\n{traceback.format_exc()}")
        timings[f"{stage}_error"] = repr(e)

    # ---- data (exprmt1_sampledata.m), drawn in float64 on the CPU ----
    ds = load("data")
    if ds is None:
        ds = syn.sample_dataset(stage_generator(repeat, 0),
                                n_per_cluster=n_per_cluster,
                                n_seqs=n_seqs, t=t, device="cpu")
        _save(outdir, repeat, "data", ds)
    want = torch.float32 if dtype == "f32" else torch.float64
    ds = syn.SyntheticDataset(
        batches=[type(b)(x=b.x.to(device=device, dtype=want),
                         lengths=b.lengths.to(device)) for b in ds.batches],
        labels=ds.labels)
    labels = ds.labels

    # ---- per-subject VBEM, one bank per S for PPK (exprmt1_demo.m:47) ----
    banks_obj = load("vbem")
    if banks_obj is None:
        vb_cfg = vb_config or syn.default_vb_config()
        banks, vb_work = {}, {"em_iters": 0, "e_steps": 0}
        s_list = sorted(set([GT_S]) | set(s_grid)) if "ppk" in methods \
            else [GT_S]
        elapsed_by_s = {}
        for s in s_list:
            # per-S sub-checkpoints so a killed worker resumes mid-stage
            sub = load(f"vbem_s{s}")
            if sub is None:
                log(f"VBEM bank S={s}")
                t_s, info = time.time(), {}
                bank = syn.learn_subject_hmms(
                    stage_generator(repeat, 100 + s), ds, s=s,
                    config=vb_cfg, info=info)
                vb_work["em_iters"] += info["model_em_iters"] \
                    + info.get("hyp_em_iters", 0)
                vb_work["e_steps"] += info.get("hyp_e_steps", 0)
                sub = {"results": bank, "elapsed": time.time() - t_s}
                _save(outdir, repeat, f"vbem_s{s}", sub)
            banks[s] = sub["results"]
            elapsed_by_s[s] = sub["elapsed"]
        work["vbem"] = vb_work
        # bank provenance travels inside the stage pickle (the version
        # of the code that produced it), with each bank's learning time
        from .. import __version__
        banks_obj = {"banks": banks, "bank_version": __version__,
                     "elapsed_by_s": elapsed_by_s,
                     "elapsed": float(sum(elapsed_by_s.values()))}
        _save(outdir, repeat, "vbem", banks_obj)
        for s in s_list:   # sub-checkpoints subsumed by the stage pickle
            try:
                os.remove(_ckpt_path(outdir, repeat, f"vbem_s{s}"))
            except OSError:
                pass
    _write_meta(outdir, repeat,
                dict(_scale_meta(n_per_cluster, n_seqs, t, k_grid, s_grid,
                                 dtype),
                     provenance=_bank_provenance(outdir, repeat, banks_obj)))
    banks = banks_obj["banks"]
    timings["vbem"] = banks_obj["elapsed"]
    results = banks[GT_S]

    # ---- VBHEM over the (K,S) grid (exprmt1_demo.m:64-108) ----
    if "vbhem" in methods:
        try:
            st = load("vbhem")
            if st is None:
                t0 = time.time()
                log("VBHEM grid")
                cfg = vbhem_config or syn.default_vbhem_config()
                res, info, score = syn.run_vbhem(
                    stage_generator(repeat, 1), results, labels,
                    k_grid=k_grid, s_grid=s_grid, config=cfg)
                grid_elapsed = time.time() - t0  # ELBO-converged grid
                base = syn.vbhem.h3m_from_results(
                    results, use_post=cfg.use_post,
                    covar_type=cfg.covar_type, device=device)
                dic_out = syn.run_vbhem_dic(info, base, cfg.tau, labels)
                hyp_st = info.get("hyp", {})
                work["vbhem"] = {
                    "em_iters": int(sum(info["grid_chunk_iters"]))
                    + hyp_st.get("hyp_em_iters", 0),
                    "e_steps": hyp_st.get("hyp_e_steps", 0),
                    # cells rescored in float64 (float32 banks only)
                    "rescored": int(np.sum(np.isfinite(
                        info["model_ll_device"]))) if dtype == "f32" else 0,
                    "dic_cells": len(info["model_all"])}
                st = {"score": score, "dic_score": dic_out["score"],
                      "dic": dic_out["dic"], "model_ll": info["model_ll"],
                      "model_ll_device": info["model_ll_device"],
                      # restart budget this grid ran with (the reference
                      # default is 100, `vbhem_h3m_cluster.m:159`)
                      "trials": cfg.trials,
                      # pruned selected model (small) so checkpoints can
                      # be re-scored if scoring semantics evolve
                      "result": res, "work": work["vbhem"],
                      # grid sweep only; the DIC pass is timed apart
                      "elapsed": grid_elapsed,
                      "elapsed_with_dic": time.time() - t0}
                _save(outdir, repeat, "vbhem", st)
            scores["vbhem"] = st["score"]
            scores["vbhem_dic"] = st["dic_score"]
            timings["vbhem"] = st["elapsed"]
        except Exception as e:  # noqa: BLE001 — stage isolation
            failed("vbhem", e)
    # ---- VHEM grid + AIC/BIC (exprmt1_demo.m:114-148) ----
    if "vhem" in methods:
        try:
            st = load("vhem")
            if st is None:
                t0 = time.time()
                log("VHEM grid")
                out = syn.run_vhem_grid(stage_generator(repeat, 2), results,
                                        labels, k_grid=k_grid, s_grid=s_grid,
                                        config=hem_config)
                work["vhem"] = {"em_iters": int(sum(out["em_iters"].values()))}
                st = {"aic_score": out["aic_score"],
                      "bic_score": out["bic_score"], "aic": out["aic"],
                      "bic": out["bic"], "elapsed": time.time() - t0}
                _save(outdir, repeat, "vhem", st)
            scores["vhem_aic"] = st["aic_score"]
            scores["vhem_bic"] = st["bic_score"]
            timings["vhem"] = st["elapsed"]
        except Exception as e:  # noqa: BLE001 — stage isolation
            failed("vhem", e)
    # ---- CCFD (exprmt1_demo.m:155-178) ----
    if "ccfd" in methods:
        try:
            st = load("ccfd")
            if st is None:
                t0 = time.time()
                log("CCFD")
                out = syn.run_ccfd(stage_generator(repeat, 3), results,
                                   labels, ds=ds)
                st = {"score": out["score"], "elapsed": time.time() - t0}
                _save(outdir, repeat, "ccfd", st)
            scores["ccfd"] = st["score"]
            timings["ccfd"] = st["elapsed"]
        except Exception as e:  # noqa: BLE001 — stage isolation
            failed("ccfd", e)
    # ---- PPK grid + AIC/BIC (exprmt1_demo.m:180-258) ----
    if "ppk" in methods:
        try:
            st = load("ppk")
            if st is None:
                t0 = time.time()
                log("PPK grid")
                out = syn.run_ppk_grid(stage_generator(repeat, 4), banks, ds,
                                       labels, k_grid=k_grid)
                st = {"aic_score": out["aic_score"],
                      "bic_score": out["bic_score"], "ll": out["ll"],
                      "elapsed": time.time() - t0}
                _save(outdir, repeat, "ppk", st)
            scores["ppk_aic"] = st["aic_score"]
            scores["ppk_bic"] = st["bic_score"]
            timings["ppk"] = st["elapsed"]
        except Exception as e:  # noqa: BLE001 — stage isolation
            failed("ppk", e)

    # ---- Dunn index per method from SKLD distances between the subject
    # HMMs (`evaluate_vbhem_jounarl.m:107-113`) ----
    dunn = {}
    try:
        from ..models import ccfd as ccfd_mod
        dmat = load("dist")
        if dmat is None:
            t0 = time.time()
            dmat = ccfd_mod.skl_distance_matrix(
                stage_generator(repeat, 5), [r.model for r in results],
                data=ds.batches)
            timings["dist"] = time.time() - t0
            _save(outdir, repeat, "dist", dmat)
        dunn = _dunn(dmat, scores)
    except Exception as e:  # noqa: BLE001 — stage isolation
        failed("dunn", e)
    return {"scores": scores, "timings": timings, "dunn": dunn,
            "work": work}


def _dunn(dmat: np.ndarray, scores: Dict) -> Dict:
    """The Dunn index of every score that carries labels, where it is
    defined: more than one cluster and not all singletons (the maximal
    intra-cluster diameter is then 0, and inf is not valid JSON)."""
    from ..utils.metrics import dunn_index
    dunn = {}
    for m, sc in scores.items():
        lab = getattr(sc, "labels", None)
        if lab is None:
            continue
        lab = np.asarray(lab)
        if 1 < len(np.unique(lab)) < len(lab):
            d = float(dunn_index(dmat, lab))
            if np.isfinite(d):
                dunn[m] = d
    return dunn


def aggregate(per_repeat: List[Dict]) -> Dict:
    """Recovery statistics per method across repeats
    (`evaluate_vbhem_jounarl.m:450-655`)."""
    methods = sorted({m for r in per_repeat for m in r["scores"]})
    summary = {}
    for m in methods:
        ss = [r["scores"][m] for r in per_repeat if m in r["scores"]]
        ks = np.array([s.best_k for s in ss])

        def s_stat(op):
            # the reference's is_S_* are per-repeat FRACTIONS of
            # surviving clusters (`evaluate_vbhem_jounarl.m:104-106`)
            # when per-cluster pruned state counts are available
            vals = []
            for s in ss:
                sl = getattr(s, "s_list", None)
                if sl:
                    vals.append(float(np.mean(op(np.asarray(sl)))))
                else:
                    vals.append(float(op(np.asarray(s.best_s))))
            return float(np.mean(vals))

        summary[m] = {
            "rand_index_mean": float(np.mean([s.rand_index for s in ss])),
            "purity_mean": float(np.mean([s.purity for s in ss])),
            "p_k_correct": float(np.mean(ks == GT_K)),
            "p_k_over": float(np.mean(ks > GT_K)),
            "p_k_under": float(np.mean(ks < GT_K)),
            "p_s_correct": s_stat(lambda v: v == GT_S),
            "p_s_over": s_stat(lambda v: v > GT_S),
            "p_s_under": s_stat(lambda v: v < GT_S),
            "n_repeats": len(ss),
        }
        dunns = [r["dunn"][m] for r in per_repeat
                 if m in r.get("dunn", {})
                 and np.isfinite(r["dunn"][m])]
        if dunns:
            summary[m]["dunn_mean"] = float(np.mean(dunns))
    return summary


def aggregate_from_checkpoints(outdir: str, n_repeats: int = 10,
                               exclude_repeats=()) -> Dict:
    """Aggregate whatever (repeat, stage) checkpoints exist in ``outdir``
    without running anything — for summarizing a partially completed
    multi-worker run.  Repeats with no completed method stages are
    skipped.

    Repeats checkpointed at different scales (per their ``r*_meta.json``
    sidecars) are segregated: the result then maps each scale config to
    its own summary instead of pooling them into one recovery statistic.
    Repeats with no meta sidecar group under "unknown".  Mixed dtypes
    within one scale are pooled but reported.

    ``exclude_repeats`` removes known-bad repeats from every summary; they
    are still reported under ``"excluded"`` with their own statistics so
    nothing is silently dropped.  Each group also reports per-repeat bank
    provenance from the meta sidecars."""
    exclude = set(int(r) for r in exclude_repeats)
    groups: Dict[str, Dict] = {}
    excluded: Dict[str, Dict] = {}
    for r in range(n_repeats):
        scores_r = _collect_repeat_scores(outdir, r)
        if not scores_r:
            continue
        meta = _load_meta(outdir, r)
        if r in exclude:
            excluded[str(r)] = {
                "provenance": (meta or {}).get("provenance"),
                "summary": aggregate([scores_r])}
            continue
        key = ("unknown" if meta is None else json.dumps(
            {k: v for k, v in meta.items() if k not in _NON_SCALE_KEYS},
            sort_keys=True))
        g = groups.setdefault(key, {"per_repeat": [], "repeats": [],
                                    "dtypes": {}, "provenance": {}})
        g["per_repeat"].append(scores_r)
        g["repeats"].append(r)
        if meta is not None:
            g["dtypes"][str(r)] = meta.get("dtype")
            if meta.get("provenance") is not None:
                g["provenance"][str(r)] = meta["provenance"]
    if not groups:
        return {"excluded": excluded} if excluded else {}
    if len(groups) == 1:
        g = next(iter(groups.values()))
        out = aggregate(g["per_repeat"])
        if g["provenance"]:
            out["provenance"] = g["provenance"]
        if excluded:
            out["excluded"] = excluded
        return out
    out = {"mixed_configs": True,
           "groups": {k: {"repeats": g["repeats"],
                          "dtypes": g["dtypes"],
                          "provenance": g["provenance"],
                          "summary": aggregate(g["per_repeat"])}
                      for k, g in groups.items()}}
    if excluded:
        out["excluded"] = excluded
    return out


def _collect_repeat_scores(outdir: str, r: int) -> Optional[Dict]:
    """Scores + Dunn for one repeat from its stage checkpoints, or None
    when no method stage has completed."""
    scores = {}
    for stage, keys in (("vbhem", (("vbhem", "score"),
                                   ("vbhem_dic", "dic_score"))),
                        ("vhem", (("vhem_aic", "aic_score"),
                                  ("vhem_bic", "bic_score"))),
                        ("ccfd", (("ccfd", "score"),)),
                        ("ppk", (("ppk_aic", "aic_score"),
                                 ("ppk_bic", "bic_score")))):
        st = _load(outdir, r, stage)
        if st is not None:
            for method, field in keys:
                scores[method] = st[field]
    if not scores:
        return None
    dmat = _load(outdir, r, "dist")
    dunn = _dunn(dmat, scores) if dmat is not None else {}
    return {"scores": scores, "timings": {}, "dunn": dunn}


def run_experiment(outdir: str, n_repeats: int = 10,
                   repeat_ids: Optional[List[int]] = None, **kwargs) -> Dict:
    """All repeats + aggregation; resumable via the per-stage pickles.
    ``repeat_ids`` restricts to a subset (so several processes can split
    the repeats over one shared ``outdir``; a final full-range rerun, or
    :func:`aggregate_from_checkpoints`, aggregates everything from the
    checkpoints).  ``kwargs`` go to :func:`run_repeat`."""
    os.makedirs(outdir, exist_ok=True)
    ids = list(repeat_ids) if repeat_ids is not None else list(
        range(n_repeats))
    per_repeat = [run_repeat(r, outdir, **kwargs) for r in ids]
    summary = aggregate(per_repeat)
    with open(os.path.join(outdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary
