"""Wavefront .OBJ / .MTL loading (`rpt_tpu/io/obj.py`).

Parsing happens on the host in numpy, with the Rust renderer's semantics
(its src/io.rs:27-254): v/vn/f with 1-based and negative indices, fan
triangulation of polygons, per-vertex normals when `v//vn` indices are
present, `vt` skipped, and the best-effort MTL -> PBR conversion heuristics
(Kd -> albedo; Ns -> roughness (2/(Ns+2))^(1/4); Ni -> IOR clamped > 1;
d < 0.8 -> transparent).

`load_obj` and `load_obj_with_mtl` parse with the native parser
(`native/obj_parser.cpp`, a copy of the JAX package's). The Python parser
below is the semantics oracle the native one is tested against, as in the
reference; unlike the reference, a missing compiler raises instead of
falling back to it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, TextIO

import numpy as np

from ..materials import Material
from ..scene import Object
from ..shapes import Mesh

__all__ = ["load_obj", "load_obj_with_mtl", "load_mtl"]


def _open(f) -> TextIO:
    if hasattr(f, "read"):
        return f
    return open(f, "r")


def _parse_index(token: str, length: int) -> Optional[int]:
    if not token:
        return None
    try:
        idx = int(token)
    except ValueError:
        return None
    return idx - 1 if idx > 0 else length + idx


def _parse_point(tokens: List[str]) -> np.ndarray:
    return np.array([float(tokens[1]), float(tokens[2]), float(tokens[3])])


def _face_triangles(tokens, vertices, normals):
    """Fan-triangulate one `f` line."""
    vi, vni = [], []
    for vert in tokens[1:]:
        args = (vert.split("/") + ["", "", ""])[:3]
        v_idx = _parse_index(args[0], len(vertices))
        if v_idx is None:
            raise ValueError(f"Invalid vertex index in .OBJ face: {vert}")
        vi.append(v_idx)
        vni.append(_parse_index(args[2], len(normals)))
    tris, tri_norms = [], []
    for i in range(1, len(vi) - 1):
        a, b, c = 0, i, i + 1
        tris.append(np.stack([vertices[vi[a]], vertices[vi[b]], vertices[vi[c]]]))
        if vni[a] is None or vni[b] is None or vni[c] is None:
            tri_norms.append(None)
        else:
            tri_norms.append(np.stack([normals[vni[a]], normals[vni[b]], normals[vni[c]]]))
    return tris, tri_norms


def _build_mesh(tris, tri_norms) -> Mesh:
    verts = np.stack(tris)
    # Explicit normals where a face has them, flat normals elsewhere.
    norms = np.empty_like(verts)
    for i, tn in enumerate(tri_norms):
        if tn is None:
            fn = np.cross(verts[i, 1] - verts[i, 0], verts[i, 2] - verts[i, 0])
            ln = np.linalg.norm(fn)
            fn = fn / (ln if ln > 0 else 1.0)
            norms[i] = fn[None, :].repeat(3, axis=0)
        else:
            norms[i] = tn
    return Mesh(verts, norms)


def _read_bytes(f) -> bytes:
    if hasattr(f, "read"):
        data = f.read()
        return data.encode() if isinstance(data, str) else data
    with open(f, "rb") as fh:
        return fh.read()


def load_obj(file) -> Mesh:
    """Load mesh geometry from a .OBJ file (a path or a file object)."""
    from ..native import parse_obj

    verts, norms, _run, _names = parse_obj(_read_bytes(file))
    return Mesh(verts, norms)


def _load_obj_py(text: str) -> Mesh:
    vertices: List[np.ndarray] = []
    normals: List[np.ndarray] = []
    tris, tri_norms = [], []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tokens = line.split()
        if tokens[0] == "v":
            vertices.append(_parse_point(tokens))
        elif tokens[0] == "vn":
            normals.append(_parse_point(tokens))
        elif tokens[0] == "f":
            t, tn = _face_triangles(tokens, vertices, normals)
            tris.extend(t)
            tri_norms.extend(tn)
    return _build_mesh(tris, tri_norms)


def load_obj_with_mtl(obj_file, mtl_file) -> List[Object]:
    """Load an object split by `usemtl` runs, one Object per run with its
    material from the .MTL library (the default material before the first
    `usemtl`)."""
    from ..native import parse_obj

    materials = load_mtl(mtl_file)
    verts, norms, run, names = parse_obj(_read_bytes(obj_file))
    objects: List[Object] = []
    for r in range(int(run.max()) + 1 if run.size else 0):
        sel = run == r
        if not sel.any():
            continue
        if r == 0:
            mat = Material.default()
        else:
            name = names[r - 1]
            if name not in materials:
                raise ValueError(f"`usemtl {name}` not in library")
            mat = materials[name]
        objects.append(Object(Mesh(verts[sel], norms[sel]), mat))
    return objects


def _load_obj_with_mtl_py(text: str, materials) -> List[Object]:
    vertices: List[np.ndarray] = []
    normals: List[np.ndarray] = []
    objects: List[Object] = []
    cur_tris, cur_norms = [], []
    cur_material = Material.default()
    last_usemtl = None

    def flush():
        nonlocal cur_tris, cur_norms
        if cur_tris:
            objects.append(Object(_build_mesh(cur_tris, cur_norms), cur_material))
            cur_tris, cur_norms = [], []

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tokens = line.split()
        if tokens[0] == "v":
            vertices.append(_parse_point(tokens))
        elif tokens[0] == "vn":
            normals.append(_parse_point(tokens))
        elif tokens[0] == "f":
            t, tn = _face_triangles(tokens, vertices, normals)
            cur_tris.extend(t)
            cur_norms.extend(tn)
        elif tokens[0] == "usemtl":
            if last_usemtl is None or last_usemtl != tokens[1]:
                flush()
                if tokens[1] not in materials:
                    raise ValueError(f"`usemtl {tokens[1]}` not in library")
                cur_material = materials[tokens[1]]
                last_usemtl = tokens[1]
    flush()
    return objects


def load_mtl(file) -> Dict[str, Material]:
    """Best-effort Ka/Kd/Ks -> PBR conversion of a .MTL library."""
    materials: Dict[str, dict] = {}
    current = None
    with _open(file) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.split()
            if tokens[0] == "newmtl":
                current = tokens[1]
                materials.setdefault(current, _material_fields(Material.default()))
            elif current is not None:
                mat = materials[current]
                if tokens[0] == "Kd":
                    mat["color"] = tuple(_parse_point(tokens))
                elif tokens[0] == "Ns":
                    mat["roughness"] = (2.0 / (float(tokens[1]) + 2.0)) ** 0.25
                elif tokens[0] == "Ni":
                    mat["index"] = max(float(tokens[1]), 1.0 + 1e-4)
                elif tokens[0] == "d":
                    if float(tokens[1]) < 0.8:
                        mat["transparent"] = True
    return {k: Material(**v) for k, v in materials.items()}


def _material_fields(m: Material) -> dict:
    return dict(color=m.color, index=m.index, roughness=m.roughness, metallic=m.metallic,
                emittance=m.emittance, transparent=m.transparent)
