"""A recursive fractal of 937 instances of one teapot mesh.

`examples/fractal_teapots.py` on the port (800x600, 1 spp, no bounce): every
placement of `scenes.fractal_placements` takes the one mesh of `--obj`,
so the compile takes the two-level path (one bottom-level tree, 937
instances at 5 levels). The scene is `scenes.build_fractal_teapots_scene`:

    python -m rpt_tpu_torch.examples.fractal_teapots [--obj PATH] [--levels N] [--spp N] [--width W] [--height H] [--out PATH] [--device DEVICE]
"""

import argparse

from .. import Renderer, Scene, load_obj
from ..scenes import build_fractal_teapots_scene, fractal_placements, fractal_spheres_camera
from . import _cli

DEFAULT_OBJ = "/root/reference/examples/teapot.obj"


def build_scene(obj_path, levels: int = 5) -> Scene:
    teapot = load_obj(obj_path)  # one mesh shared by every instance
    counts = [len(level) for level in fractal_placements(levels)]
    print(f"Loaded {teapot.num_triangles} triangles (shared); teapots per level: {counts}, total: {sum(counts)}")
    return build_fractal_teapots_scene(teapot, levels)


def make_camera():
    return fractal_spheres_camera()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--obj", default=DEFAULT_OBJ)
    parser.add_argument("--levels", type=int, default=5)
    parser.add_argument("--spp", type=int, default=1)
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=600)
    parser.add_argument("--out", default="fractal_teapots.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(args.obj, args.levels), make_camera(), width=args.width, height=args.height,
                        num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
