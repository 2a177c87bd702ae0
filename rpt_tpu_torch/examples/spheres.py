"""A row of glossy spheres through a thin lens focused on the middle one.

`examples/spheres.py` on the port (960x540, 100 spp, 2 bounces):

    python -m rpt_tpu_torch.examples.spheres [--spp N] [--out PATH] [--device DEVICE]
"""

import argparse
import math

from .. import Camera, Material, Object, ObjectLight, Renderer, Scene, hex_color, plane, sphere
from . import _cli


def build_scene() -> Scene:
    scene = Scene()
    colors = [0xFF6F61, 0xFFD700, 0x6B8E23, 0x4169E1, 0x9370DB]
    for i, c in enumerate(colors):
        x = (i - 2) * 2.2
        scene.add(Object(sphere().translate([x, 0.0, -abs(i - 2) * 1.5])).material(Material.specular(hex_color(c), 0.2)))
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.diffuse(hex_color(0xAAAAAA))))
    scene.add(ObjectLight(Object(sphere().scale([3.0, 3.0, 3.0]).translate([0.0, 14.0, 2.0]))
                          .material(Material.light(hex_color(0xFFFFFF), 30.0))))
    return scene


def make_camera() -> Camera:
    return Camera.look_at([0.0, 2.5, 9.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], math.pi / 5).focus([0.0, 0.0, 0.0], 0.25)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--spp", type=int, default=100)
    parser.add_argument("--out", default="spheres.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(), make_camera(), width=960, height=540, max_bounces=2, num_samples=args.spp,
                        device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
