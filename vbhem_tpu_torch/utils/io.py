"""Fixation-table ingest: the counterpart of :mod:`vbhem_tpu.utils.io`
(`src/util/read_xls_fixations.m`).  A table with the columns SubjectID,
TrialID, FixX, FixY and optionally FixD becomes one padded
:class:`~vbhem_tpu_torch.containers.SeqBatch` per subject, on the device
that :func:`~vbhem_tpu_torch.containers.pack_sequences` puts it on (the
card unless the caller names another).

Without pandas: CSV is parsed with the standard library, legacy ``.xls``
with this package's BIFF8 reader (:mod:`.xls`); only ``.xlsx`` needs
pandas, and raises an ImportError naming it where pandas is missing.
Subjects and trials keep their order of first appearance, and a subject
key is the ID as pandas would print it (a column of whole numbers gives
"1", a numeric column "1.5", anything else the text), so both readers and
the JAX package key a table alike.
"""
from __future__ import annotations

import csv
import math
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..containers import SeqBatch, pack_sequences

COLUMNS = ("SubjectID", "TrialID", "FixX", "FixY")


def _table(path: str):
    """(header, rows) of the fixation table at ``path``."""
    if path.endswith(".xlsx"):
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError(f"reading {path}: .xlsx tables need pandas, "
                              f"which is not installed (CSV and legacy .xls "
                              f"need nothing)") from e
        df = pd.read_excel(path)
        return [str(c) for c in df.columns], df.values.tolist()
    if path.endswith(".xls"):
        from .xls import read_xls_table
        return read_xls_table(path)
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if any(c.strip() for c in r)]
    return (rows[0], rows[1:]) if rows else ([], [])


def _empty(v) -> bool:
    return v is None or (isinstance(v, str) and not v.strip()) or (
        isinstance(v, float) and math.isnan(v))


def _number(v) -> float:
    return math.nan if _empty(v) else float(v)


def _is_int(v) -> bool:
    if isinstance(v, str):
        return re.fullmatch(r"\s*[+-]?\d+\s*", v) is not None
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def _is_number(v) -> bool:
    try:
        float(v)
    except (TypeError, ValueError):
        return False
    return True


def _keys(values: list) -> List[Optional[str]]:
    """Group keys of an ID column as pandas prints the column it infers:
    all whole numbers -> "1", all numbers -> "1.5", else the text; empty
    cells (pandas' NaN, dropped from the groups) -> None."""
    present = [v for v in values if not _empty(v)]
    if all(_is_int(v) for v in present):
        text = lambda v: str(int(v))                     # noqa: E731
    elif all(_is_number(v) for v in present):
        text = lambda v: str(float(v))                   # noqa: E731
    else:
        text = str
    return [None if _empty(v) else text(v) for v in values]


def read_fixations(path: str, t_max: Optional[int] = None,
                   dtype=np.float64, device="cuda") -> Dict[str, SeqBatch]:
    """Read a fixation table (.csv, .xls or .xlsx) into per-subject
    SeqBatches on ``device``.

    Columns (matched case-insensitively, `read_xls_fixations.m:6-34`):
    SubjectID, TrialID, FixX, FixY and optionally FixD (the duration, a
    third data dimension).  Returns {subject_id: SeqBatch}."""
    header, rows = _table(path)
    cols = {str(c).lower().strip(): i for i, c in enumerate(header)}

    def col(name):
        if name.lower() not in cols:
            raise ValueError(f"missing column {name!r}; found {header}")
        return cols[name.lower()]

    subj_c, trial_c = col("SubjectID"), col("TrialID")
    val_cols = [col("FixX"), col("FixY")]
    if "fixd" in cols:
        val_cols.append(cols["fixd"])
    width = max([subj_c, trial_c] + val_cols) + 1
    rows = [list(r) + [None] * (width - len(r)) for r in rows]
    subjects = _keys([r[subj_c] for r in rows])
    trials = _keys([r[trial_c] for r in rows])

    grouped: Dict[str, Dict[str, list]] = {}
    for r, s, t in zip(rows, subjects, trials):
        if s is None or t is None:
            continue
        grouped.setdefault(s, {}).setdefault(t, []).append(
            [_number(r[c]) for c in val_cols])
    return {s: pack_sequences([np.asarray(v, dtype=dtype)
                               for v in by_trial.values()],
                              dtype=dtype, t_max=t_max, device=device)
            for s, by_trial in grouped.items()}


def write_fixations(path: str, subjects: Dict[str, SeqBatch]):
    """Write per-subject SeqBatches as a fixation CSV (SubjectID, TrialID,
    FixX, FixY, and FixD for 3-D data), trials numbered from 1 in order,
    padding left out; :func:`read_fixations` reads it back."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        d = next(iter(subjects.values())).x.shape[-1]
        w.writerow(list(COLUMNS) + (["FixD"] if d == 3 else []))
        for name, b in subjects.items():
            x = b.x.detach().cpu().numpy()
            lengths = b.lengths.cpu().numpy()
            for n in range(x.shape[0]):
                for step in x[n, :lengths[n]]:
                    w.writerow([name, n + 1] + [repr(float(v))
                                                for v in step])


def batches_from_nested(data: Sequence[Sequence[np.ndarray]],
                        t_max: Optional[int] = None, dtype=np.float64,
                        device="cuda") -> List[SeqBatch]:
    """Nested [subject][trial] arrays (the reference's `data{subj}{trial}`
    cell layout) -> one SeqBatch per subject on ``device``."""
    return [pack_sequences([np.asarray(s) for s in subj], dtype=dtype,
                           t_max=t_max, device=device) for subj in data]


def get_median_length(data) -> float:
    """Median sequence length over nested data (`get_median_length.m`):
    SeqBatches, arrays [..., T, D], or nested lists of them.  Used to pick
    the virtual length tau."""
    lengths: List[int] = []

    def walk(obj):
        if isinstance(obj, SeqBatch):
            lengths.extend(int(v) for v in obj.lengths.reshape(-1).tolist())
        elif (torch.is_tensor(obj) or hasattr(obj, "shape")) and \
                len(obj.shape) >= 2:
            lengths.append(int(obj.shape[-2]))
        elif isinstance(obj, (list, tuple)):
            for o in obj:
                walk(o)
        else:
            raise TypeError(f"cannot get lengths from {type(obj)}")

    walk(data)
    return float(np.median(lengths))
