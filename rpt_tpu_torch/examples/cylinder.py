"""An STL mesh under an ambient, a point and a directional light.

`examples/cylinder.py` on the port (512x512, 1 spp, no bounce), reading the
same STL file (`--stl`, the reference's asset by default):

    python -m rpt_tpu_torch.examples.cylinder [--stl PATH] [--spp N] [--out PATH] [--device DEVICE]
"""

import argparse
import math
import os

import numpy as np

from .. import (AmbientLight, Camera, DirectionalLight, Material, Object, PointLight, Renderer, Scene, hex_color,
                load_stl, plane)
from . import _cli

DEFAULT_STL = "/root/reference/examples/cylinder.stl"


def build_scene(stl_path: str = DEFAULT_STL) -> Scene:
    scene = Scene()
    scene.add(Object(load_stl(stl_path).translate([-15.0, -15.0, -25.0]).scale([1.0 / 15.0, 1.0 / 15.0, 1.0 / 25.0])
                     .rotate_y(math.pi / 4)))
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.diffuse(hex_color(0xAAAAAA))))
    scene.add(AmbientLight((0.02, 0.02, 0.02)))
    scene.add(PointLight((80.0, 80.0, 80.0), (0.0, 5.0, 5.0)))
    d = np.array([1.0, -1.0, 0.0])
    scene.add(DirectionalLight((2.0, 2.0, 2.0), d / np.linalg.norm(d)))
    return scene


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--stl", default=DEFAULT_STL)
    parser.add_argument("--spp", type=int, default=1)
    parser.add_argument("--out", default="cylinder.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    if not os.path.exists(args.stl):
        raise SystemExit(f"Mesh not found: {args.stl} (pass --stl PATH)")
    renderer = Renderer(build_scene(args.stl), Camera(), width=512, height=512, num_samples=args.spp,
                        device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
