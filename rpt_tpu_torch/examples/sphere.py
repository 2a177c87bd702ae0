"""The README scene: a red sphere on a gray floor under a spherical area light.

`examples/sphere.py` on the port (960x540, 100 spp, 2 bounces):

    python -m rpt_tpu_torch.examples.sphere [--spp N] [--width W] [--height H] [--out PATH] [--device DEVICE]
"""

import argparse
import math

from .. import Camera, Material, Object, ObjectLight, Renderer, Scene, hex_color, plane, sphere
from . import _cli


def build_scene() -> Scene:
    scene = Scene()
    scene.add(Object(sphere()))  # the default red material
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.diffuse(hex_color(0xAAAAAA))))
    scene.add(ObjectLight(Object(sphere().scale([2.0, 2.0, 2.0]).translate([0.0, 12.0, 0.0]))
                          .material(Material.light(hex_color(0xFFFFFF), 40.0))))
    return scene


def make_camera() -> Camera:
    return Camera.look_at([-2.5, 4.0, 6.5], [0.0, -0.25, 0.0], [0.0, 1.0, 0.0], math.pi / 4)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--spp", type=int, default=100)
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=540)
    parser.add_argument("--out", default="output.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(), make_camera(), width=args.width, height=args.height, max_bounces=2,
                        num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
