"""Build and load the package's CUDA kernels (`csrc/*.cu`).

Each source `csrc/<name>.cu` is compiled by nvcc for sm_90a into its own
shared library `_build/lib<name>.so` with a plain C interface, at first use,
and loaded with ctypes. The nvcc processes of all stale sources run at once.
A library is stale when its source or any shared header (`csrc/*.cuh`) is
newer. A missing nvcc or a failed build raises; there is no stand-in. The
build runs only where kernels are launched (a machine with a CUDA card):
importing this module compiles nothing.

Launch counts live on the device. Every counted wrapper hands its kernel
the address of an int64 in a per-device table (`launch_counter`), and one
thread of the kernel adds one to it when the kernel runs (`csrc/count.cuh`).
So a launch recorded in a CUDA graph is counted each time the graph is
replayed, by the device, and a launch made around the wrappers (a kernel
compared with its plain version) passes no address and is not counted.

The table holds lane counts as well as launch counts: a counted function
that launches no kernel of its own adds a number of lanes to its slot with
a torch op on the device (`add_count`), which a CUDA graph records like any
other, so every replay counts and the host never waits. The integrator's
`shadow_lanes` and `shadow_live_lanes` count the lanes handed to each
any-hit query and the live ones among them, on the CPU too (in a CPU table).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

from . import profiling

__all__ = [
    "build", "load_library", "sources", "NVCC_FLAGS", "counted", "launch_counter", "add_count", "launch_counts",
    "reset_launch_counts",
]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
# -fmad=false: no multiply-add contraction, so the kernels agree bit for
# bit with their plain torch versions (see csrc/walk.cuh).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
_P, _I32, _I64, _F32, _F64, _U32, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_double,
                                          ctypes.c_uint32, ctypes.c_uint64)
# argtypes of every entry point, by library: c_void_p for each pointer and
# the stream, so ctypes never cuts a pointer to 32 bits.
_SIGNATURES = {
    "bvh8": {
        "rpt_bvh8_closest": [_P, _P, _I32] + [_P] * 4 + [_I64, _F32] + [_P] * 4,
        "rpt_bvh8_occluded": [_P, _P, _I32] + [_P] * 5 + [_I64, _F32] + [_P] * 3,
        "rpt_bvh8_closest_f64": [_P, _P, _I32] + [_P] * 4 + [_I64, _F64] + [_P] * 4,
        "rpt_bvh8_occluded_f64": [_P, _P, _I32] + [_P] * 5 + [_I64, _F64] + [_P] * 3,
        "rpt_bvh8_occupancy": [_I32, _I32, _P],
    },
    "tlas8": {
        "rpt_tlas8_closest": [_P, _P, _I32, _I32] + [_P] * 5 + [_I64, _F32] + [_P] * 5,
        "rpt_tlas8_occluded": [_P, _P, _I32, _I32] + [_P] * 6 + [_I64, _F32] + [_P] * 3,
        "rpt_tlas8_closest_f64": [_P, _P, _I32, _I32] + [_P] * 5 + [_I64, _F64] + [_P] * 5,
        "rpt_tlas8_occluded_f64": [_P, _P, _I32, _I32] + [_P] * 6 + [_I64, _F64] + [_P] * 3,
        "rpt_tlas8_occupancy": [_I32, _I32, _P],
    },
    "bvh2": {
        "rpt_bvh2_closest": [_P] * 5 + [_I64, _F32] + [_P] * 2 + [_I32, _I32, _P, _P, _P],
        "rpt_bvh2_occluded": [_P] * 6 + [_I64, _F32, _P, _I32, _I32, _P, _P, _P],
        "rpt_bvh2_closest_f64": [_P] * 5 + [_I64, _F64] + [_P] * 2 + [_I32, _I32, _P, _P, _P],
        "rpt_bvh2_occluded_f64": [_P] * 6 + [_I64, _F64, _P, _I32, _I32, _P, _P, _P],
        "rpt_bvh2_occupancy": [_I32, _I32, _I32, _P],
    },
    "tlas2": {
        "rpt_tlas2_closest": [_P, _I32] + [_P] * 5 + [_I64, _F32] + [_P] * 3 + [_I32, _I32, _P, _P, _P],
        "rpt_tlas2_occluded": [_P, _I32] + [_P] * 6 + [_I64, _F32, _P, _I32, _I32, _P, _P, _P],
        "rpt_tlas2_closest_f64": [_P, _I32] + [_P] * 5 + [_I64, _F64] + [_P] * 3 + [_I32, _I32, _P, _P, _P],
        "rpt_tlas2_occluded_f64": [_P, _I32] + [_P] * 6 + [_I64, _F64, _P, _I32, _I32, _P, _P, _P],
        "rpt_tlas2_occupancy": [_I32, _I32, _I32, _P],
    },
    "threefry": {
        "rpt_threefry": [_I32, _P, _U32, _U32, _P, _U32, _I64, _P, _F64, _F64, _I64, _U64, _U64, _U64, _I32, _I32,
                         _P, _P],
    },
    "scatter": {
        "rpt_scatter": [_I64, _P, _I64, _P, _I64, _P, _P, _I64] + [_P] * 9 + [_F32] + [_P] * 6,
        "rpt_scatter_f64": [_I64, _P, _I64, _P, _I64, _P, _P, _I64] + [_P] * 9 + [_F64] + [_P] * 6,
    },
}
_lock = threading.Lock()
_libs: dict = {}
# The counted wrappers: {wrapper: (its first slot in a device's table, its
# slot count)}, and the table of each device that launched one.
_COUNTED: dict = {}
_TABLE_SLOTS = 64
_tables: dict = {}


def counted(wrapper=None, *, slots: int = 1):
    """Register a kernel's wrapper, with `slots` launch counts of its own
    (one per variant it launches, e.g. a mode), or a function that counts
    lanes (`add_count`). Use as `@counted` or `@counted(slots=n)`."""
    def register(fn):
        first = sum(n for _, n in _COUNTED.values())
        if first + slots > _TABLE_SLOTS:
            raise RuntimeError("too many counted kernels for the launch-count table")
        _COUNTED[fn] = (first, slots)
        return fn

    return register if wrapper is None else register(wrapper)


def _table(device) -> torch.Tensor:
    """The launch-count table of `device`, made at its first use, which must
    not be inside a CUDA graph capture (a capture's warm-up comes first)."""
    device = torch.device(device)
    table = _tables.get(device)
    if table is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the launch-count table is made at a kernel's first launch, not inside a capture")
        table = _tables[device] = torch.zeros(_TABLE_SLOTS, dtype=torch.int64, device=device)
    return table


def _slot(wrapper, slot: int) -> int:
    first, n = _COUNTED[wrapper]
    if not 0 <= slot < n:
        raise ValueError(f"{wrapper.__name__} has {n} launch counts, not slot {slot}")
    return first + slot


def launch_counter(wrapper, device, slot: int = 0) -> ctypes.c_void_p:
    """The device address of `wrapper`'s launch count `slot` on `device`,
    for its kernel to add one to."""
    table = _table(device)
    return ctypes.c_void_p(table.data_ptr() + table.element_size() * _slot(wrapper, slot))


def add_count(wrapper, device, amount, slot: int = 0) -> None:
    """Add `amount` (an int, or an int64 tensor of one element on `device`)
    to `wrapper`'s count `slot` on `device`, as one op on the device."""
    _table(device)[_slot(wrapper, slot)].add_(amount)


def _wait(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts(by_slot: bool = False) -> dict:
    """{wrapper: launches} of every counted wrapper, summed over devices,
    or with `by_slot` {wrapper: [launches of each slot]}; read from the
    devices after waiting for them."""
    total = torch.zeros(_TABLE_SLOTS, dtype=torch.int64)
    for device, table in _tables.items():
        _wait(device)
        total += table.cpu()
    counts = {fn: total[first:first + n].tolist() for fn, (first, n) in _COUNTED.items()}
    return counts if by_slot else {fn: sum(c) for fn, c in counts.items()}


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    for device, table in _tables.items():
        _wait(device)
        table.zero_()


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
        with profiling.rare_span("rpt.kernels.load") as span:
            span.set(built=any(b["seconds"] > 0 for b in build().values()))
            lib = ctypes.CDLL(_lib_path(name))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
        return lib
