"""Native host-side code, compiled with g++ at first use and loaded via ctypes.

`bvh_builder.cpp` (the binned-SAH BVH builder) and `obj_parser.cpp` (the
Wavefront .OBJ parser) are copies of the JAX package's, so both packages
build array-identical trees and load identical triangles from the same
input. `digest.cpp` hashes the scene digest's large leaves
(MurmurHash3_x64_128). Each source becomes its own shared library in the
package's git-ignored `_build/` directory. A missing compiler or a failed
build raises: there is no slower stand-in, because it would give other
results.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import types

import numpy as np

__all__ = ["get_lib", "native_available", "build_bvh_sah", "parse_obj", "hash128", "BUILD_DIR"]

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_PP, _PI64 = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)
# name -> (source, {entry point: (restype, argtypes)})
_LIBS = {
    "bvh": ("bvh_builder.cpp", {
        "rpt_build_bvh_sah": (ctypes.c_int, [_P, _P, _I64, ctypes.c_int] + [_P] * 7 + [_I64, _I64, _P, _P]),
    }),
    "obj": ("obj_parser.cpp", {
        "rpt_parse_obj": (ctypes.c_int, [ctypes.c_char_p, _I64, _PP, _PP, _PP, _PP, _PI64, _PI64]),
        "rpt_obj_free": (None, [_P]),
    }),
    "digest": ("digest.cpp", {
        "rpt_murmur3_x64_128": (None, [_P, _I64, _P]),
    }),
}
_lock = threading.Lock()
_loaded: dict = {}


def _load(name: str):
    """The loaded library `_build/librpt_<name>.so`, built first when it is
    missing or older than its source."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src_name, entries = _LIBS[name]
        src = os.path.join(_DIR, src_name)
        path = os.path.join(BUILD_DIR, f"librpt_{name}.so")
        if not (os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(src)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed building {src}:\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in entries.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
        return lib


def get_lib():
    """The native entry points (`rpt_build_bvh_sah`, `rpt_parse_obj`,
    `rpt_obj_free`, `rpt_murmur3_x64_128`) as attributes of one object, as
    the reference's one library holds its own, or None if a library cannot
    be built or loaded here (no g++, a failed build, an unwritable build
    directory)."""
    try:
        libs = [_load(name) for name in _LIBS]
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    return types.SimpleNamespace(**{fn: getattr(lib, fn) for lib, (_, entries) in zip(libs, _LIBS.values())
                                    for fn in entries})


def native_available() -> bool:
    """Whether the native libraries build and load here. Where they do
    not, `build_bvh_sah`, `parse_obj` and `hash128` still raise: the port
    has no slower stand-in."""
    return get_lib() is not None


def build_bvh_sah(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int):
    """Binned-SAH skip-link preorder BVH over triangle AABBs.

    Returns (node_min (M,3) f32, node_max, is_leaf (M,) i32, skip i32,
    leaf_start i32, leaf_count i32, perm (P,) i64), where perm is the
    leaf-contiguous, leaf_size-padded triangle permutation.
    """
    lib = _load("bvh")
    T = int(tri_min.shape[0])
    if T <= 0:
        raise ValueError("build_bvh_sah needs at least one triangle")
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    cap_nodes = 2 * T + 1
    cap_perm = leaf_size * T + leaf_size
    node_min = np.empty((cap_nodes, 3), np.float32)
    node_max = np.empty((cap_nodes, 3), np.float32)
    is_leaf = np.empty(cap_nodes, np.int32)
    skip = np.empty(cap_nodes, np.int32)
    leaf_start = np.empty(cap_nodes, np.int32)
    leaf_count = np.empty(cap_nodes, np.int32)
    perm = np.empty(cap_perm, np.int64)
    out_nodes = np.zeros(1, np.int64)
    out_perm = np.zeros(1, np.int64)
    rc = lib.rpt_build_bvh_sah(
        tri_min.ctypes.data, tri_max.ctypes.data, T, leaf_size,
        node_min.ctypes.data, node_max.ctypes.data, is_leaf.ctypes.data,
        skip.ctypes.data, leaf_start.ctypes.data, leaf_count.ctypes.data,
        perm.ctypes.data, cap_nodes, cap_perm,
        out_nodes.ctypes.data, out_perm.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"rpt_build_bvh_sah failed (rc={rc})")
    M, P = int(out_nodes[0]), int(out_perm[0])
    return (
        node_min[:M], node_max[:M], is_leaf[:M], skip[:M],
        leaf_start[:M], leaf_count[:M], perm[:P],
    )


def parse_obj(data: bytes):
    """Parse OBJ text -> (verts (T,3,3) f64, norms (T,3,3) f64, run (T,)
    i32, names list[str]): fan triangulation, negative indices, flat-normal
    fill, usemtl runs (run 0 = before any usemtl; names[i] is run i+1's
    material). Raises ValueError on malformed input."""
    lib = _load("obj")
    pv, pn, pr, pnm = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    n_tris, n_runs = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.rpt_parse_obj(
        data, len(data), ctypes.byref(pv), ctypes.byref(pn), ctypes.byref(pr),
        ctypes.byref(pnm), ctypes.byref(n_tris), ctypes.byref(n_runs),
    )
    if rc != 0:
        raise ValueError(f"malformed .OBJ (native parser rc={rc})")
    try:
        T = n_tris.value

        def doubles(p):
            arr = np.ctypeslib.as_array(ctypes.cast(p, ctypes.POINTER(ctypes.c_double)), (max(T, 1) * 9,))
            return arr[: T * 9].reshape(T, 3, 3).copy()

        verts, norms = doubles(pv), doubles(pn)
        run = np.ctypeslib.as_array(ctypes.cast(pr, ctypes.POINTER(ctypes.c_int32)), (max(T, 1),))[:T].copy()
        names_raw = ctypes.cast(pnm, ctypes.c_char_p).value or b""
        names = names_raw.decode("utf-8").split("\n") if names_raw else []
    finally:
        for p in (pv, pn, pr, pnm):
            lib.rpt_obj_free(p)
    if len(names) != n_runs.value:
        raise RuntimeError(f"native OBJ parser returned {len(names)} run names for {n_runs.value} runs")
    return verts, norms, run, names


def hash128(arr: np.ndarray) -> bytes:
    """MurmurHash3_x64_128 (seed 0) of a C-contiguous array's bytes, read
    in place: 16 bytes, h1 then h2, each a little-endian 64-bit word."""
    if not isinstance(arr, np.ndarray) or not arr.flags.c_contiguous:
        raise ValueError("hash128 takes a C-contiguous numpy array")
    lib = _load("digest")
    out = ctypes.create_string_buffer(16)
    lib.rpt_murmur3_x64_128(arr.ctypes.data, arr.nbytes, out)
    return out.raw
