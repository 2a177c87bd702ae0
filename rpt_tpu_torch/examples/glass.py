"""A clear glass sphere over a floor, 6 bounces, so light passes both its faces.

`examples/glass.py` on the port (800x600, 200 spp):

    python -m rpt_tpu_torch.examples.glass [--spp N] [--out PATH] [--device DEVICE]
"""

import argparse
import math

from .. import Camera, Environment, Material, Object, ObjectLight, Renderer, Scene, hex_color, plane, sphere
from . import _cli


def build_scene() -> Scene:
    scene = Scene()
    scene.add(Object(sphere()).material(Material.clear(1.5, 0.0001)))
    scene.add(Object(sphere().scale([0.4] * 3).translate([-2.0, -0.6, -1.5]))
              .material(Material.diffuse(hex_color(0xBC0000))))
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.diffuse(hex_color(0xAAAAAA))))
    scene.add(ObjectLight(Object(sphere().scale([2.0] * 3).translate([4.0, 10.0, 4.0]))
                          .material(Material.light(hex_color(0xFFFFFF), 50.0))))
    scene.set_environment(Environment.from_color((0.1, 0.12, 0.15)))
    return scene


def make_camera() -> Camera:
    return Camera.look_at([0.0, 1.2, 5.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], math.pi / 5)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--spp", type=int, default=200)
    parser.add_argument("--out", default="glass.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(), make_camera(), width=800, height=600, max_bounces=6, num_samples=args.spp,
                        device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
