"""A dielectric wine glass on a table under an area light, rendered progressively.

`examples/wine_glass.py` on the port (1920x1080, 1000 spp, 6 bounces, the
variance printed every `--interval` samples), reading the glass from
`--obj` and, with `--hdr`, the environment map (else a solid one). The
scene is `scenes.build_wine_glass_scene` around the loaded mesh:

    python -m rpt_tpu_torch.examples.wine_glass [--obj PATH] [--hdr PATH] [--spp N] [--width W] [--height H] [--interval N] [--out PATH] [--device DEVICE]
"""

import argparse
import os

from .. import Environment, Renderer, Scene, load_obj
from ..io.image import load_hdr
from ..scenes import build_wine_glass_scene, wine_glass_camera
from . import _cli

DEFAULT_OBJ = "/root/reference/examples/wine_glass.obj"


def build_scene(obj_path, hdr_path=None) -> Scene:
    if hdr_path:
        env = Environment.from_hdri(load_hdr(hdr_path))
    else:
        env = Environment.from_color((0.25, 0.25, 0.28))
    return build_wine_glass_scene(load_obj(obj_path), env)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--obj", default=DEFAULT_OBJ)
    parser.add_argument("--hdr", default=None)
    parser.add_argument("--spp", type=int, default=1000)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--interval", type=int, default=10)
    parser.add_argument("--out", default="wine_glass.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    if not os.path.exists(args.obj):
        raise SystemExit(f"Mesh not found: {args.obj} (pass --obj PATH)")
    renderer = Renderer(build_scene(args.obj, args.hdr), wine_glass_camera(), width=args.width, height=args.height,
                        max_bounces=6, num_samples=args.spp, device=args.device)
    buffer = _cli.progressive(renderer, args.interval)
    return _cli.save(args.out, buffer.image(renderer.filter))


if __name__ == "__main__":
    main()
