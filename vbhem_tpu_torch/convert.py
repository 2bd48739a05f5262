"""Carry weights and state between the JAX package and this one.

:func:`to_torch` turns a container whose leaves are numpy (or any
array-like) values — ``H3M``, ``H3MPosterior``, ``HMM``, ``VBHEMHyps``,
``VHEMResult``, ``SyntheticDataset`` and the other NamedTuples the two
packages share — into this package's container of the same field names,
on a given device (the card by default) and dtype.  Lists inside a
container (a dataset's per-subject batches) are converted item by item;
fields that this package keeps in NumPy (a dataset's ``labels``) stay
NumPy.
:func:`to_numpy` turns one of this package's containers back into the
same container with numpy leaves.  Containers are matched by their field
names, so this module never imports the JAX package.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch

from .containers import resolve_device


@functools.lru_cache(maxsize=1)
def _registry() -> dict:
    from . import containers
    from .experiments import synthetic
    from .models import vbhem, vbhmm, vhem
    from .ops import fb, gmm, pair_estep
    classes = (containers.NIW, containers.HMM, containers.HMMPosterior,
               containers.H3M, containers.H3MPosterior,
               containers.VBHMMResult, containers.SeqBatch,
               pair_estep.PairStats, vbhem.VBHEMHyps,
               vbhem.ReducedExpectations, vbhem.ClusterStats,
               vbhem.VBHEMState, vbhem.VBHEMResult, fb.FBStats, gmm.GMM,
               vbhmm.VBHyps, vbhmm.SuffStats, vbhmm.EMState,
               vhem.VHEMState, vhem.VHEMResult, synthetic.SyntheticDataset)
    return {tuple(c._fields): c for c in classes}


# fields this package keeps on the host, as NumPy arrays
_HOST_FIELDS = {"SyntheticDataset": ("labels",)}


def _is_container(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _port_class(obj):
    cls = _registry().get(tuple(obj._fields))
    if cls is None:
        raise TypeError(f"no vbhem_tpu_torch container has the fields "
                        f"{obj._fields} of {type(obj).__name__}")
    return cls


def to_torch(obj: Any, device="cuda",
             dtype: Optional[torch.dtype] = None):
    """Container (or single array) -> this package's container of tensors
    on ``device`` (the card unless the caller names another).

    Floating leaves are cast to ``dtype`` when it is given; integer and
    boolean leaves keep their type.  ``None`` leaves stay ``None``."""
    device = resolve_device(device)
    if obj is None:
        return None
    if _is_container(obj):
        cls = _port_class(obj)
        host = _HOST_FIELDS.get(cls.__name__, ())
        return cls(*[np.asarray(getattr(obj, f)) if f in host
                     else to_torch(getattr(obj, f), device, dtype)
                     for f in obj._fields])
    if isinstance(obj, list):
        return [to_torch(v, device, dtype) for v in obj]
    t = torch.as_tensor(np.array(obj), device=device)  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def to_numpy(obj: Any):
    """This package's container (or a single tensor) -> the same container
    with numpy leaves."""
    if obj is None:
        return None
    if _is_container(obj):
        return type(obj)(*[to_numpy(getattr(obj, f)) for f in obj._fields])
    if isinstance(obj, list):
        return [to_numpy(v) for v in obj]
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)
