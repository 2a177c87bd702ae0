"""Basic primitives: spheres, a cube and a floor under an ambient and a point light.

`examples/basic.py` on the port (800x600, 1 spp, no bounce):

    python -m rpt_tpu_torch.examples.basic [--spp N] [--out PATH] [--device DEVICE]
"""

import argparse
import math

from .. import AmbientLight, Camera, Material, Object, PointLight, Renderer, Scene, cube, hex_color, plane, sphere
from . import _cli


def build_scene() -> Scene:
    scene = Scene()
    scene.add(Object(sphere()))
    scene.add(Object(cube().rotate_y(math.pi / 6.0).scale([0.5, 0.3, 0.4]).translate([0.4, -0.8, 4.0]))
              .material(Material.specular(hex_color(0xFF00FF), 0.5)))
    scene.add(Object(sphere().scale([0.5] * 3).translate([1.5, -0.5, 1.0]))
              .material(Material.specular(hex_color(0x0000FF), 0.1)))
    scene.add(Object(sphere().scale([0.5] * 3).translate([-1.5, -0.5, 1.0]))
              .material(Material.specular(hex_color(0x00FF00), 0.1)))
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.specular(hex_color(0xAAAAAA), 0.5)))
    scene.add(AmbientLight((0.01, 0.01, 0.01)))
    scene.add(PointLight((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--spp", type=int, default=1)
    parser.add_argument("--out", default="basic.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(), Camera(), width=800, height=600, num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
