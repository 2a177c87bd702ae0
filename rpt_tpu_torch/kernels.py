"""Build and load the package's CUDA kernels (`csrc/*.cu`).

Each source `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own
shared library `_build/lib<name>.so` with a plain C interface, at first use,
and loaded with ctypes. The nvcc processes of all stale sources run at once.
A library is stale when its source or any shared header (`csrc/*.cuh`) is
newer. A missing nvcc or a failed build raises; there is no stand-in. The
build runs only where kernels are launched (a machine with a CUDA card):
importing this module compiles nothing.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

__all__ = ["build", "load_library", "sources", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
# -fmad=false: no multiply-add contraction, so the kernels agree bit for
# bit with their plain torch versions (see csrc/walk.cuh).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# argtypes of every entry point, by library: c_void_p for each pointer and
# the stream, so ctypes never cuts a pointer to 32 bits.
_SIGNATURES = {
    "bvh8": {
        "rpt_bvh8_closest": [_P, _P, _I32] + [_P] * 4 + [_I64, _F32] + [_P] * 3,
        "rpt_bvh8_occluded": [_P, _P, _I32] + [_P] * 5 + [_I64, _F32] + [_P] * 2,
    },
    "tlas8": {
        "rpt_tlas8_closest": [_P, _P, _I32, _I32] + [_P] * 6 + [_I64, _F32] + [_P] * 4,
        "rpt_tlas8_occluded": [_P, _P, _I32, _I32] + [_P] * 7 + [_I64, _F32] + [_P] * 2,
    },
    "bvh2": {
        "rpt_bvh2_closest": [_P] * 5 + [_I64, _F32] + [_P] * 2 + [_I32, _I32, _P, _P],
        "rpt_bvh2_occluded": [_P] * 6 + [_I64, _F32, _P, _I32, _I32, _P, _P],
    },
    "tlas2": {
        "rpt_tlas2_closest": [_P, _I32] + [_P] * 5 + [_I64, _F32] + [_P] * 3 + [_I32, _I32, _P, _P],
        "rpt_tlas2_occluded": [_P, _I32] + [_P] * 6 + [_I64, _F32, _P, _I32, _I32, _P, _P],
    },
}
_lock = threading.Lock()
_libs: dict = {}


def sources() -> dict:
    """{name: path} of every csrc/<name>.cu."""
    paths = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    return {os.path.splitext(os.path.basename(p))[0]: p for p in paths}


def _lib_path(name: str) -> str:
    return os.path.join(_BUILD, f"lib{name}.so")


def _stale(name: str, src: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(p) for p in [src, *glob.glob(os.path.join(_CSRC, "*.cuh"))])
    return os.path.getmtime(lib) < newest


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(force: bool = False) -> dict:
    """Compile every stale csrc/*.cu (all when `force`) into _build/, one
    nvcc process per source, all started together. Returns {name:
    {"seconds": build time, "log": ptxas register/spill report}}, with
    seconds 0.0 and log "cached" for a library that was fresh."""
    todo = {n: s for n, s in sources().items() if force or _stale(n, s)}
    out = {n: {"seconds": 0.0, "log": "cached"} for n in sources() if n not in todo}
    if not todo:
        return out
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, src in todo.items():
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, t0, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {todo[name]}:\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, _lib_path(name))
        out[name] = {"seconds": seconds, "log": (stdout + stderr).strip()}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load_library(name: str):
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build()
        lib = ctypes.CDLL(_lib_path(name))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
        return lib
