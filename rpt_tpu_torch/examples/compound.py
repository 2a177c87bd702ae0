"""A compound of five cubes under three spherical lamps.

`examples/compound.py` on the port (1024x1024, 5 bounces, 50 spp): the
cubes turned by the magic angle about (1, 1, 1), three of them mirrored
(a transform of negative determinant), on a white floor. The scene is
`scenes.build_compound_scene`:

    python -m rpt_tpu_torch.examples.compound [--spp N] [--size N] [--out PATH] [--device DEVICE]
"""

import argparse

from .. import Camera, ObjectLight, Renderer, Scene
from ..scenes import build_compound_scene, compound_camera, compound_lamp
from . import _cli

__all__ = ["lamp", "build_scene", "make_camera", "main"]


def lamp(x, y, z, r, e) -> ObjectLight:
    return compound_lamp(x, y, z, r, e)


def build_scene() -> Scene:
    return build_compound_scene()


def make_camera() -> Camera:
    return compound_camera()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--spp", type=int, default=50)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--out", default="compound.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(), make_camera(), width=args.size, height=args.size, max_bounces=5,
                        num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
