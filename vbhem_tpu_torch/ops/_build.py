"""Build the package's CUDA kernels at first use and load them with ctypes.

The ``.cu`` sources under ``vbhem_tpu_torch/csrc/`` export a plain C
interface and are compiled by ``nvcc`` for ``sm_90a``, each in its own
process and all at once, and linked into one shared library in
``build/vbhem_tpu_torch/`` beside the package (a directory the repository
ignores).  The library's file name carries a hash of every file under
``csrc/`` and of the flags, so an edited source or header builds anew.
Host-only sources (the fixation loader, ``csrc/fixation_loader.cc``) are
built by the host C++ compiler into the same directory by
:func:`build_host`, under a hash of their own.  Nothing here runs at
import time: this module imports on machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "vbhem_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall",
                  "-Wextra")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources; carries the compiler's
    output."""


class HostBuildError(RuntimeError):
    """The host C++ compiler is missing or refused a host source; carries
    the compiler's output."""


def find_nvcc() -> Optional[str]:
    """Path of nvcc: on PATH, else under the CUDA home PyTorch detects."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    return None


def sources() -> list:
    """The translation units: one nvcc process each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives.  The
    hash covers every file under ``csrc/``, headers included, so an edit
    to a header the kernels share builds anew too."""
    h = hashlib.sha256()
    for src in sorted(p for p in CSRC_DIR.rglob("*") if p.is_file()):
        h.update(str(src.relative_to(CSRC_DIR)).encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvbhem_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path.  Every source compiles in its own ``nvcc`` process, all started
    together, and one more links the objects.  The compilers' output
    (with the ptxas register and spill report) is kept beside the library
    as ``<name>.log``."""
    lib_path = library_path()
    if lib_path.is_file():
        return lib_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (not on PATH and no CUDA home): the CUDA "
            "kernels of vbhem_tpu_torch cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename the library: a
    # concurrent build or an interrupted one never leaves a half-written
    # library in place
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        jobs = []
        for src in sources():
            obj = tmp / f"{src.stem}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log += f"== {src.name}\n{out}"
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit code {proc.returncode})")
        if failed:
            raise KernelBuildError(f"nvcc failed on {', '.join(failed)}:\n"
                                   f"{log}")
        so = tmp / lib_path.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(so),
                               *[str(obj) for _, obj, _ in jobs]],
                              capture_output=True, text=True)
        log += f"== link\n{proc.stdout}{proc.stderr}"
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed to link, exit code {proc.returncode}:\n{log}")
        lib_path.with_suffix(".log").write_text(log)
        os.replace(so, lib_path)
    return lib_path


def ptxas_report(lib_path: Optional[Path] = None) -> dict:
    """ptxas's report of each kernel in the build log beside the library
    (``<name>.log``, the ``-Xptxas -v`` output :func:`build` keeps):
    {mangled name: {'registers', 'stack', 'spill_stores', 'spill_loads'}}
    (bytes for the last three), for the library of the current sources
    unless ``lib_path`` names another."""
    log = (lib_path or library_path()).with_suffix(".log")
    report, cur = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            cur = report.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return report


def load() -> ctypes.CDLL:
    """Build if needed and load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


_fns: dict = {}


def c_function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The library's entry point ``name``, with its ctypes signature (an
    ``int`` cudaError_t result) set once per process."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def find_cxx() -> Optional[str]:
    """Path of the host C++ compiler: $CXX, else c++ or g++ on PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    return None


def host_library_path(source: Path) -> Path:
    """Where the host library built from ``source`` lives: its name
    carries a hash of the source and of the flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(HOST_CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build_host(source: Path) -> Path:
    """Compile the host-only ``source`` into a shared library with the host
    C++ compiler unless the library for it exists; returns its path.
    Raises HostBuildError without a compiler or when it fails."""
    lib_path = host_library_path(source)
    if lib_path.is_file():
        return lib_path
    cxx = find_cxx()
    if cxx is None:
        raise HostBuildError(f"no host C++ compiler ($CXX, c++ or g++) to "
                             f"build {source.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = Path(tmp) / lib_path.name
        proc = subprocess.run([cxx, *HOST_CXX_FLAGS, "-o", str(so),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise HostBuildError(
                f"{cxx} failed on {source.name}, exit code "
                f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
        os.replace(so, lib_path)
    return lib_path
