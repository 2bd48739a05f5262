"""ctypes binding of the native C++ fixation loader
(``csrc/fixation_loader.cc``, this package's own copy, with the C ABI of
:mod:`vbhem_tpu.utils.native_io`): the counterpart of that module.

The library is built at first use by the host C++ compiler into the
ignored ``build/vbhem_tpu_torch/`` (:func:`..ops._build.build_host`, under
a hash of the source and flags); the JAX package's checked-in
``native/libvbhem_io.so`` is never loaded.  The native path parses and
packs a CSV in one pass with no per-row Python work.
:func:`read_fixations_auto` keeps the JAX package's contract (native for
CSV when the library is there, the Python reader otherwise) and says
which reader ran.
"""
from __future__ import annotations

import ctypes
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..containers import SeqBatch, resolve_device
from ..ops import _build

SOURCE = _build.CSRC_DIR / "fixation_loader.cc"
_lib = None
_error: Optional[str] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the signatures of the loader's C ABI."""
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    sigs = {"vbhem_parse_fixations": (vp, [ctypes.c_char_p]),
            "vbhem_error": (ctypes.c_char_p, [vp]),
            "vbhem_num_subjects": (i64, [vp]),
            "vbhem_dim": (i64, [vp]),
            "vbhem_subject_name": (ctypes.c_char_p, [vp, i64]),
            "vbhem_num_trials": (i64, [vp, i64]),
            "vbhem_max_len": (i64, [vp, i64]),
            "vbhem_fill_subject": (ctypes.c_int, [
                vp, i64, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64), i64]),
            "vbhem_free": (None, [vp])}
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _load_library():
    """The loaded library, building it on first use; None where it cannot
    be built (the reason in :func:`unavailable_reason`)."""
    global _lib, _error
    if _lib is None and _error is None:
        try:
            _lib = _bind(ctypes.CDLL(str(_build.build_host(SOURCE))))
        except (_build.HostBuildError, OSError) as e:
            _error = str(e)
    return _lib


def native_available() -> bool:
    return _load_library() is not None


def unavailable_reason() -> Optional[str]:
    """Why the native loader could not be built or loaded, or None."""
    _load_library()
    return _error


def read_fixations_native(path: str, t_max: Optional[int] = None,
                          dtype=np.float64,
                          device="cuda") -> Dict[str, SeqBatch]:
    """Native CSV parse and pack, with the output contract of
    :func:`.io.read_fixations`.  Raises RuntimeError if the library cannot
    be built or the file cannot be parsed."""
    device = resolve_device(device)
    lib = _load_library()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    handle = lib.vbhem_parse_fixations(str(path).encode())
    try:
        err = lib.vbhem_error(handle).decode()
        if err:
            raise RuntimeError(f"native loader: {err}: {path}")
        dim = int(lib.vbhem_dim(handle))
        out: Dict[str, SeqBatch] = {}
        for i in range(int(lib.vbhem_num_subjects(handle))):
            name = lib.vbhem_subject_name(handle, i).decode()
            n = int(lib.vbhem_num_trials(handle, i))
            tm = int(lib.vbhem_max_len(handle, i)) if t_max is None \
                else t_max
            data = np.zeros((n, tm, dim), np.float64)
            lengths = np.zeros((n,), np.int64)
            rc = lib.vbhem_fill_subject(
                handle, i,
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), tm)
            if rc != 0:
                raise RuntimeError(f"native loader: fill failed ({rc})")
            out[name] = SeqBatch(
                x=torch.as_tensor(data.astype(dtype), device=device),
                lengths=torch.as_tensor(lengths.astype(np.int32),
                                        device=device))
        return out
    finally:
        lib.vbhem_free(handle)


def read_fixations_auto(path: str, t_max: Optional[int] = None,
                        dtype=np.float64, device="cuda"
                        ) -> Tuple[Dict[str, SeqBatch], str]:
    """The native loader for CSV when it is available, the Python reader
    (:func:`.io.read_fixations`) otherwise and for Excel formats, as in
    the JAX package.  Returns (subjects, reader): ``reader`` is 'native'
    or 'python', the one that ran; a native parse that fails falls back
    to the Python reader with a warning naming the failure."""
    from .io import read_fixations
    if str(path).endswith(".csv") and native_available():
        try:
            return read_fixations_native(path, t_max, dtype,
                                         device), "native"
        except RuntimeError as e:
            warnings.warn(f"{e}; reading {path} with the Python reader")
    return read_fixations(path, t_max, dtype, device), "python"
