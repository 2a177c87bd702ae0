"""A metallic teapot mesh on a diffuse floor (a baked BVH).

`examples/teapot.py` on the port (800x800, 1 spp, no bounce; an ambient and
a point light), reading the same OBJ file (`--obj`, the reference's asset
by default):

    python -m rpt_tpu_torch.examples.teapot [--obj PATH] [--spp N] [--size N] [--out PATH] [--device DEVICE]
"""

import argparse
import os

from .. import AmbientLight, Camera, Material, Object, PointLight, Renderer, Scene, hex_color, load_obj, plane
from . import _cli

DEFAULT_OBJ = "/root/reference/examples/teapot.obj"


def build_scene(obj_path: str = DEFAULT_OBJ) -> Scene:
    """A metallic teapot, a gray floor, an ambient and a point light."""
    if not os.path.exists(obj_path):
        raise SystemExit(f"Mesh not found: {obj_path} (pass --obj PATH)")
    scene = Scene()
    mesh = load_obj(obj_path)
    print(f"Loaded {mesh.num_triangles} triangles")
    scene.add(Object(mesh.scale([0.5, 0.5, 0.5]).translate([0.0, -1.0, 0.0]))
              .material(Material.metallic_mat(hex_color(0xFF0000), 0.4)))
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.diffuse(hex_color(0xAAAAAA))))
    scene.add(AmbientLight((0.02, 0.02, 0.02)))
    scene.add(PointLight((60.0, 60.0, 60.0), (0.0, 5.0, 5.0)))
    return scene


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--obj", default=DEFAULT_OBJ)
    parser.add_argument("--spp", type=int, default=1)
    parser.add_argument("--size", type=int, default=800)
    parser.add_argument("--out", default="teapot.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    scene = build_scene(args.obj)
    renderer = Renderer(scene, Camera(), width=args.size, height=args.size, num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
