"""Heuristic hyperparameter setting and pretty-printing: the counterpart of
:mod:`vbhem_tpu.models.hyp_heuristics` (`src/hmm/vbhmm_set_hyperparam.m`,
image-center mode 'c' and data-driven mode 'd', `:47-88`; and
`src/hmm/vbhmm_print_hyps.m`).

Host functions in NumPy: the batches' valid observations (the mask comes
from their lengths, as :class:`..containers.SeqBatch` defines it) are
read once to the host, and the result is a new ``VBConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import VBConfig
from ..containers import SeqBatch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def set_hyperparam(config: VBConfig, batches: Sequence[SeqBatch],
                   mode: str = "d",
                   image_size: Optional[Tuple[int, int]] = None) -> VBConfig:
    """``config`` with mu0 and W0 set heuristically.

    mode 'c' (`vbhmm_set_hyperparam.m:47-66`): the image center; ROI width
    (4 standard deviations) 1/8 of the mean image side; for a third
    (duration) dimension mean 250 ms and standard deviation 25.
    mode 'd' (`:68-84`): the data mean; the standard deviation from the
    pooled variance of the first two dimensions (circular), the third's
    own."""
    x_all = np.concatenate([_host(b.x)[_host(b.mask)] for b in batches],
                           axis=0)
    d = x_all.shape[-1]
    if mode == "c":
        if image_size is None:
            raise ValueError("mode 'c' needs image_size=(width, height)")
        w_img, h_img = image_size
        mu = [0.5 * w_img, 0.5 * h_img]
        s = (0.5 * (w_img + h_img) / 8.0) / 4.0
        if d == 3:
            mu.append(250.0)
            w0 = (s ** -2, s ** -2, 25.0 ** -2)
        else:
            w0 = s ** -2
    elif mode == "d":
        mu = list(x_all.mean(axis=0))
        s = float(np.sqrt(x_all[:, :2].var(axis=0).mean()))
        if d == 3:
            w0 = (s ** -2, s ** -2, float(x_all[:, 2].std()) ** -2)
        else:
            w0 = s ** -2
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return dataclasses.replace(config, mu0=tuple(float(v) for v in mu),
                               w0=w0)


def format_hyps(hyps, names: Optional[Sequence[str]] = None) -> str:
    """The hyps as one line, ``name=value; ...`` (`vbhmm_print_hyps.m`)."""
    parts = []
    for n in names or list(hyps._fields):
        v = _host(getattr(hyps, n))
        if v.size == 1:
            parts.append(f"{n}={float(v):.4g}")
        else:
            parts.append(f"{n}=[" + ", ".join(f"{x:.4g}" for x in v.ravel())
                         + "]")
    return "; ".join(parts)
