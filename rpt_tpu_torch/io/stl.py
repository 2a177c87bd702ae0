"""STL mesh loading, binary and ASCII (`rpt_tpu/io/stl.py`).

The binary format is recognised by its size (84 + 50 * triangles bytes);
otherwise a `solid ` prefix selects the ASCII parser. The facet normal is
every vertex's normal, as in the reference.
"""

from __future__ import annotations

import struct

import numpy as np

from ..shapes import Mesh

__all__ = ["load_stl"]


def load_stl(path) -> Mesh:
    """A Mesh from an .stl file, given as a path or a binary file object."""
    if hasattr(path, "read"):
        data = path.read()
    else:
        with open(path, "rb") as fh:
            data = fh.read()
    size = len(data)
    if size < 15:
        raise ValueError("Loaded .STL file is too short")
    if size >= 84:
        (num_triangles,) = struct.unpack_from("<I", data, 80)
        if size == 84 + num_triangles * 50:
            return _load_binary(data, num_triangles)
    if data[:6] == b"solid ":
        return _load_ascii(data.decode("utf-8", errors="replace"))
    raise ValueError("Loaded .STL file, but could not determine format")


def _load_binary(data: bytes, num_triangles: int) -> Mesh:
    # Each record: normal (3f), v1 (3f), v2 (3f), v3 (3f), u16 attribute.
    rec = np.frombuffer(data[84:84 + num_triangles * 50], dtype=np.uint8).reshape(num_triangles, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(num_triangles, 4, 3).astype(np.float64)
    norms = np.repeat(floats[:, 0][:, None, :], 3, axis=1)
    return Mesh(floats[:, 1:4], norms)


def _load_ascii(text: str) -> Mesh:
    lines = iter(text.splitlines()[1:])
    verts, norms = [], []
    for line in lines:
        line = line.strip()
        if not line.startswith("facet normal "):
            if line.startswith("endsolid"):
                break
            continue
        vn = np.array([float(t) for t in line[len("facet normal "):].split()])
        next(lines)  # outer loop
        vs = []
        for _ in range(3):
            vline = next(lines).strip()
            if not vline.startswith("vertex "):
                raise ValueError(f"STL facet: expected a vertex line, not {vline!r}")
            vs.append(np.array([float(t) for t in vline[len("vertex "):].split()]))
        next(lines)  # endloop
        next(lines)  # endfacet
        verts.append(np.stack(vs))
        norms.append(np.repeat(vn[None, :], 3, axis=0))
    return Mesh(np.stack(verts), np.stack(norms))
