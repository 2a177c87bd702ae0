"""Stand-in files for the examples that read an asset.

The meshes and maps the examples default to (each module's `DEFAULT_*`, the
script's own path) are not part of this repository. `write_stand_ins(directory)` writes files
of the same formats in their place, each read through the path its example
takes, and returns the flags that point each example at them:

- `teapot.obj`: the trefoil cut to about the teapot's 2.2k triangles
  (`scenes.TEAPOT_KNOT`, 2,256 triangles), for `teapot`, `metal` and
  `fractal_teapots`; `cylinder.stl`, the same mesh as a binary STL;
- `rustacean.obj`: the toy brick plane's OBJ text (`scenes.toy_plane_obj`);
- `wine_glass.obj` and `pegasus.zip` (member `pegasus.obj`): the
  120,000-triangle trefoil, also the mesh of `dragon --obj`;
- `lego.zip`: the toy plane's OBJ and MTL under one folder;
- `sky.hdr`: `scenes.procedural_sky` written as Radiance RGBE, for the
  `--hdr` of `metal` and `monomial_glass`.
"""

from __future__ import annotations

import os
import struct
import zipfile

import numpy as np

from ..io.image import save_hdr
from ..scenes import TEAPOT_KNOT, TOY_MTL, procedural_sky, toy_plane_obj, trefoil_mesh

__all__ = ["obj_text", "write_binary_stl", "write_stand_ins"]


def obj_text(mesh) -> str:
    """OBJ text of a mesh: its distinct vertices and shading normals, one
    `f v//vn` line per triangle."""
    verts, vi = np.unique(mesh.vertices.reshape(-1, 3), axis=0, return_inverse=True)
    norms, ni = np.unique(mesh.normals.reshape(-1, 3), axis=0, return_inverse=True)
    faces = np.stack([vi.reshape(-1, 3) + 1, ni.reshape(-1, 3) + 1], -1).reshape(-1, 6)
    return "".join(("v %.9g %.9g %.9g\n" * len(verts)) % tuple(verts.ravel().tolist())
                   + ("vn %.9g %.9g %.9g\n" * len(norms)) % tuple(norms.ravel().tolist())
                   + ("f %d//%d %d//%d %d//%d\n" * len(faces)) % tuple(faces.ravel().tolist()))


def write_binary_stl(path, mesh) -> None:
    """A binary STL of a mesh: each triangle's face normal and its corners
    in float32."""
    v = np.asarray(mesh.vertices, np.float64)
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
    rec = np.zeros(v.shape[0], np.dtype([("f", "<f4", (12,)), ("attr", "<u2")]))
    rec["f"] = np.concatenate([fn, v.reshape(-1, 9)], axis=1)
    with open(path, "wb") as f:
        f.write(b"stand-in mesh".ljust(80, b"\0"))
        f.write(struct.pack("<I", v.shape[0]))
        f.write(rec.tobytes())


def write_stand_ins(directory, glass_knot=(600, 100), sky_height: int = 256) -> dict:
    """Write the stand-in files into `directory` and return {example name:
    its flags}. `glass_knot` is the (segments, sides) of the larger trefoil,
    `sky_height` the map's height."""
    def path(name):
        return os.path.join(directory, name)

    teapot = trefoil_mesh(*TEAPOT_KNOT)
    with open(path("teapot.obj"), "w") as f:
        f.write(obj_text(teapot))
    write_binary_stl(path("cylinder.stl"), teapot)
    with open(path("rustacean.obj"), "w") as f:
        f.write(toy_plane_obj())
    glass = obj_text(trefoil_mesh(*glass_knot))
    with open(path("wine_glass.obj"), "w") as f:
        f.write(glass)
    with zipfile.ZipFile(path("pegasus.zip"), "w", zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
        zf.writestr("pegasus.obj", glass)
    with zipfile.ZipFile(path("lego.zip"), "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("toy_plane/toy_plane.obj", toy_plane_obj())
        zf.writestr("toy_plane/toy_plane.mtl", TOY_MTL)
    save_hdr(path("sky.hdr"), procedural_sky(sky_height))
    return {
        "teapot": ["--obj", path("teapot.obj")],
        "cylinder": ["--stl", path("cylinder.stl")],
        "metal": ["--obj", path("teapot.obj"), "--hdr", path("sky.hdr")],
        "rustacean": ["--obj", path("rustacean.obj")],
        "fractal_teapots": ["--obj", path("teapot.obj")],
        "pegasus": ["--zip", path("pegasus.zip")],
        "wine_glass": ["--obj", path("wine_glass.obj")],
        "dragon": ["--obj", path("wine_glass.obj")],
        "lego": ["--zip", path("lego.zip")],
        "monomial_glass": ["--hdr", path("sky.hdr")],
    }
