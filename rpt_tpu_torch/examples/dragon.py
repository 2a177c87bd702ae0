"""The dragon: a large mesh under two spherical area lights.

`examples/dragon.py` on the port (800x600, 1 spp, 2 bounces). `--obj` reads
a mesh; without it the scene holds the procedural trefoil knot of 120,000
triangles (`scenes.trefoil_mesh`) in the dragon's place. Either way the
scene is `scenes.build_dragon_scene` around the mesh:

    python -m rpt_tpu_torch.examples.dragon [--obj PATH] [--spp N] [--width W] [--height H] [--out PATH] [--device DEVICE]
"""

import argparse

from .. import Renderer, Scene, load_obj
from ..scenes import build_dragon_scene, dragon_camera, dragon_knot_size, trefoil_mesh
from . import _cli

__all__ = ["trefoil_mesh", "build_scene", "main"]


def build_scene(obj_path=None, target_tris: int | None = None) -> Scene:
    """The dragon scene around the mesh of `obj_path`, or a trefoil of at
    least `target_tris` triangles, or the default 120,000-triangle one."""
    if obj_path:
        mesh = load_obj(obj_path)
    elif target_tris:
        segments, sides = dragon_knot_size(target_tris)
        mesh = trefoil_mesh(segments=segments, sides=sides)
    else:
        print("No --obj given; using the procedural high-poly stand-in")
        mesh = trefoil_mesh()
    print(f"Mesh: {mesh.num_triangles} triangles")
    return build_dragon_scene(mesh=mesh)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--obj", default=None)
    parser.add_argument("--spp", type=int, default=1)
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=600)
    parser.add_argument("--out", default="dragon.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(args.obj), dragon_camera(), width=args.width, height=args.height, max_bounces=2,
                        num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
