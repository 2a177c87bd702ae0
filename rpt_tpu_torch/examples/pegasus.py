"""An ice sculpture of a winged horse under an HDRI, rendered progressively.

`examples/pegasus.py` on the port (1200x1200, 10 spp, 8 bounces, EV -1.5,
the variance printed after every sample). The mesh is `pegasus.obj` read
straight out of `--zip`; the map is `--hdr`'s file or the procedural sky.
The scene is `scenes.build_pegasus_scene` around the mesh scaled by 1.4:

    python -m rpt_tpu_torch.examples.pegasus [--zip PATH] [--hdr PATH] [--spp N] [--size N] [--bounces N] [--out PATH] [--device DEVICE]
"""

import argparse
import io
import zipfile

import numpy as np

from .. import Environment, Renderer, Scene
from ..io.image import load_hdr
from ..io.obj import load_obj
from ..scenes import build_pegasus_scene, pegasus_camera, procedural_sky
from ..shapes import Mesh
from . import _cli

DEFAULT_ZIP = "/root/reference/examples/pegasus.zip"


def load_pegasus(zip_path):
    with zipfile.ZipFile(zip_path) as zf:
        with zf.open("pegasus.obj") as f:
            return load_obj(io.TextIOWrapper(f, encoding="utf-8"))


def _split_all(v, n):
    """Every triangle split 1:4 at its edge midpoints; the shading normals
    at a midpoint are the sum of the edge's two, normalized."""
    m01v, m12v, m20v = 0.5 * (v[:, 0] + v[:, 1]), 0.5 * (v[:, 1] + v[:, 2]), 0.5 * (v[:, 2] + v[:, 0])
    m01n, m12n, m20n = n[:, 0] + n[:, 1], n[:, 1] + n[:, 2], n[:, 2] + n[:, 0]
    tv = np.stack([np.stack([v[:, 0], m01v, m20v], 1), np.stack([m01v, v[:, 1], m12v], 1),
                   np.stack([m20v, m12v, v[:, 2]], 1), np.stack([m01v, m12v, m20v], 1)], 1).reshape(-1, 3, 3)
    tn = np.stack([np.stack([n[:, 0], m01n, m20n], 1), np.stack([m01n, n[:, 1], m12n], 1),
                   np.stack([m20n, m12n, n[:, 2]], 1), np.stack([m01n, m12n, m20n], 1)], 1).reshape(-1, 3, 3)
    ln = np.linalg.norm(tn, axis=-1, keepdims=True)
    return tv, tn / np.where(ln > 1e-30, ln, 1.0)


def subdivide_to(mesh, target_tris: int):
    """Midpoint-subdivide a mesh to about `target_tris` triangles: a full
    1:4 pass while four times the count stays within the target, then the
    largest triangles split 1:4 until it is reached (each split adds 3)."""
    v = np.asarray(mesh.vertices, np.float64)
    n = np.asarray(mesh.normals, np.float64)
    while v.shape[0] * 4 <= target_tris:
        v, n = _split_all(v, n)
    if v.shape[0] < target_tris:
        k = (target_tris - v.shape[0]) // 3
        areas = 0.5 * np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
        big = np.argsort(areas)[-k:] if k else np.zeros(0, np.int64)
        keep = np.ones(v.shape[0], bool)
        keep[big] = False
        sv, sn = _split_all(v[big], n[big])
        v = np.concatenate([v[keep], sv])
        n = np.concatenate([n[keep], sn])
    return Mesh(v, n)


def build_scene(zip_path, hdr_path=None, target_tris=None) -> Scene:
    if hdr_path:
        env = Environment.from_hdri(load_hdr(hdr_path))
    else:
        env = Environment.from_hdri(procedural_sky())
    pegasus = load_pegasus(zip_path)
    if target_tris:
        pegasus = subdivide_to(pegasus, target_tris)
    print(f"Loaded {pegasus.num_triangles} triangles")
    return build_pegasus_scene(pegasus.scale([1.4, 1.4, 1.4]), env)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--zip", default=DEFAULT_ZIP)
    parser.add_argument("--hdr", default=None)
    parser.add_argument("--spp", type=int, default=10)
    parser.add_argument("--size", type=int, default=1200)
    parser.add_argument("--bounces", type=int, default=8)
    parser.add_argument("--out", default="pegasus.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(args.zip, args.hdr), pegasus_camera(), width=args.size, height=args.size,
                        exposure_value=-1.5, max_bounces=args.bounces, num_samples=args.spp, device=args.device)
    buffer = _cli.progressive(renderer, 1)
    return _cli.save(args.out, buffer.image())


if __name__ == "__main__":
    main()
