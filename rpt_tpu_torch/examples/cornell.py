"""The Cornell box (its literal data), rendered progressively.

`examples/cornell.py` on the port (1024x1024, 100 spp, 2 bounces, a box
filter of radius 1, the variance printed every `--interval` samples). The
scene is `scenes.build_cornell_scene`:

    python -m rpt_tpu_torch.examples.cornell [--spp N] [--size N] [--interval N] [--out PATH] [--device DEVICE]
"""

import argparse

from .. import Camera, Filter, Renderer, Scene
from ..scenes import CORNELL_EPSILON, build_cornell_scene, cornell_camera
from . import _cli


def build_scene() -> Scene:
    return build_cornell_scene()


def make_camera() -> Camera:
    return cornell_camera()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--spp", type=int, default=100)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--interval", type=int, default=10)
    parser.add_argument("--out", default="cornell.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(), make_camera(), width=args.size, height=args.size, filter=Filter.box(1),
                        max_bounces=2, num_samples=args.spp,
                        # The box is ~550 units across: the float32 ray offset scaled to it.
                        epsilon=CORNELL_EPSILON, device=args.device)
    buffer = _cli.progressive(renderer, args.interval)
    return _cli.save(args.out, buffer.image(renderer.filter))


if __name__ == "__main__":
    main()
