"""Builds and loads the port's CUDA kernels.

Each source in ``bigdl_tpu_torch/csrc/`` is compiled by its own
``nvcc`` process, all started together, into a shared library with a
plain ``extern "C"`` interface for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The libraries land in ``bigdl_tpu_torch/build/`` (ignored by git),
named by a hash of the source, the shared header and the flags, so an
edited source rebuilds and an unchanged one is reused.  They are loaded
with ``ctypes``: every pointer and the stream travel as ``c_void_p``.
A build or launch error raises with the compiler's or the runtime's
message; nothing falls back to the plain versions.

Nothing here runs at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "build", "library", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
#: kernel sources, one shared library each
SOURCES = ("lrn_fwd", "lrn_bwd", "avg_pool_fwd", "avg_pool_bwd", "flash_fwd",
           "flash_dq", "flash_dkv", "maxpool_fwd", "maxpool_tie_bwd",
           "maxpool_argmax_bwd", "wcl_fwd", "wcl_bwd", "smooth2d")
_HEADERS = ("common.cuh", "flash.cuh", "pool_stage.cuh", "window.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signature of each library's launcher
_SIGNATURES = {
    "lrn_fwd": ("bigdl_cml_fwd",
                [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P]),
    "lrn_bwd": ("bigdl_cml_bwd",
                [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P]),
    "avg_pool_fwd": ("bigdl_avg_pool_fwd",
                     [_P, _P, _P] + [_I] * 12 + [_P]),
    "avg_pool_bwd": ("bigdl_avg_pool_bwd",
                     [_P, _P] + [_I] * 12 + [_P]),
    "flash_fwd": ("bigdl_flash_fwd", [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P]),
    "flash_dq": ("bigdl_flash_dq", [_P] * 7 + [_I] * 4 + [_F, _I, _I, _P]),
    "flash_dkv": ("bigdl_flash_dkv", [_P] * 8 + [_I] * 4 + [_F, _I, _I, _P]),
    "maxpool_fwd": ("bigdl_maxpool_fwd", [_P] * 3 + [_I] * 12 + [_P]),
    "maxpool_tie_bwd": ("bigdl_maxpool_tie_bwd", [_P] * 4 + [_I] * 12 + [_P]),
    "maxpool_argmax_bwd": ("bigdl_maxpool_argmax_bwd",
                           [_P] * 3 + [_I] * 12 + [_P]),
    "wcl_fwd": ("bigdl_wcl_fwd", [_P] * 3 + [_I] * 5 + [_F] * 2 + [_I, _P]),
    "wcl_bwd": ("bigdl_wcl_bwd", [_P] * 4 + [_I] * 5 + [_F] * 3 + [_I, _P]),
    "smooth2d": ("bigdl_smooth2d", [_P] * 3 + [_I] * 11 + [_P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)"
                           ": the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in (f"{name}.cu",) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> Dict[str, dict]:
    """Compile every named source that has no current library, one
    ``nvcc`` each, all in parallel.  Returns ``{name: {"path", "seconds",
    "ptxas"}}`` (``seconds`` 0 and ``ptxas`` None for a library that was
    already built).  Raises RuntimeError with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    procs = {}
    for name in names:
        target = _target(name)
        out[name] = {"path": str(target), "seconds": 0.0, "ptxas": None}
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["ptxas"] = log
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building every source
    on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if not _libs:
            paths = build()
            for n, info in paths.items():
                lib = ctypes.CDLL(info["path"])
                fn_name, argtypes = _SIGNATURES[n]
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                lib.bigdl_error_string.argtypes = [ctypes.c_int]
                lib.bigdl_error_string.restype = ctypes.c_char_p
                _libs[n] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise with the CUDA runtime's message when a launcher returned an
    error (``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        msg = lib.bigdl_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{err}: {msg}")
