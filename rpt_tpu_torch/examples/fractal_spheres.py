"""A recursive fractal of 937 spheres in five colored levels.

`examples/fractal_spheres.py` on the port (800x600, 1 spp, no bounce; an
ambient, a directional and a point light). The scene is
`scenes.build_fractal_spheres_scene`; its spheres are tested in chunks of
`scene.PRIM_CHUNK`:

    python -m rpt_tpu_torch.examples.fractal_spheres [--levels N] [--spp N] [--width W] [--height H] [--out PATH] [--device DEVICE]
"""

import argparse

from .. import Renderer, Scene
from ..scenes import LEVEL_COLORS, build_fractal_spheres_scene, fractal_placements, fractal_spheres_camera
from . import _cli

__all__ = ["LEVEL_COLORS", "fractal_placements", "build_scene", "make_camera", "main"]


def build_scene(levels: int = 5) -> Scene:
    counts = [len(level) for level in fractal_placements(levels)]
    print(f"Spheres per level: {counts}, total: {sum(counts)}")
    return build_fractal_spheres_scene(levels)


def make_camera():
    return fractal_spheres_camera()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--levels", type=int, default=5)
    parser.add_argument("--spp", type=int, default=1)
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=600)
    parser.add_argument("--out", default="fractal_spheres.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(args.levels), make_camera(), width=args.width, height=args.height,
                        num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
