"""Ferris the crab with glass and metal beads.

`examples/rustacean.py` on the port (800x800, 10 spp, 4 bounces; a specular
orange crab mesh from `--obj`, six small spheres alternating clear glass
and metal, one spherical area light):

    python -m rpt_tpu_torch.examples.rustacean [--obj PATH] [--spp N] [--size N] [--bounces N] [--out PATH] [--device DEVICE]
"""

import argparse
import math

from .. import Camera, Material, Object, ObjectLight, Renderer, Scene, hex_color, load_obj, plane, sphere
from . import _cli

DEFAULT_OBJ = "/root/reference/examples/rustacean.obj"


def build_scene(obj_path) -> Scene:
    scene = Scene()
    crab_scale = (2.0, 2.4, 2.0)
    scene.add(Object(load_obj(obj_path).translate([0.0, 0.134649, 0.0]).scale(list(crab_scale)))
              .material(Material.specular(hex_color(0xF84C00), 0.2)))
    scene.add(Object(plane([0.0, 1.0, 0.0], 0.0)).material(Material.diffuse(hex_color(0xAAAA77))))

    balls = [
        (True, 0.2, (-0.81, 1.02, 0.47)),
        (True, 0.3, (-0.86, 1.10, 0.36)),
        (True, 0.4, (-0.75, 1.12, 0.34)),
        (False, 0.2, (0.87, 1.03, 0.41)),
        (False, 0.3, (0.75, 1.09, 0.36)),
        (False, 0.4, (0.85, 1.15, 0.45)),
    ]
    for glass, roughness, pos in balls:
        p = [pos[i] * crab_scale[i] for i in range(3)]
        mat = Material.clear(1.5, roughness) if glass else Material.metallic_mat(hex_color(0xFFFFFF), roughness)
        scene.add(Object(sphere().scale([0.1, 0.1, 0.1]).translate(p)).material(mat))

    scene.add(ObjectLight(Object(sphere().scale([2.0, 2.0, 2.0]).translate([0.0, 20.0, 3.0]))
                          .material(Material.light((1.0, 1.0, 1.0), 160.0))))
    return scene


def make_camera() -> Camera:
    return Camera.look_at((-2.5, 4.0, 8.5), (0.0, 0.9, 0.0), (0.0, 1.0, 0.0), math.pi / 6)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--obj", default=DEFAULT_OBJ)
    parser.add_argument("--spp", type=int, default=10)
    parser.add_argument("--size", type=int, default=800)
    parser.add_argument("--bounces", type=int, default=4)
    parser.add_argument("--out", default="rustacean.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(args.obj), make_camera(), width=args.size, height=args.size,
                        max_bounces=args.bounces, num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
