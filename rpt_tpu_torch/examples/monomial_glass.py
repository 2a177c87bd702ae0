"""A metallic monomial surface among primitives.

`examples/monomial_glass.py` on the port (800x600, 1 bounce, 100 spp),
under a solid environment or, with `--hdr`, an equirectangular .hdr map.
The scene is `scenes.build_monomial_glass_scene`:

    python -m rpt_tpu_torch.examples.monomial_glass [--spp N] [--hdr PATH] [--out PATH] [--device DEVICE]
"""

import argparse

from .. import Camera, Environment, Renderer, Scene
from ..io.image import load_hdr
from ..scenes import build_monomial_glass_scene
from . import _cli


def build_scene(hdr_path=None) -> Scene:
    if hdr_path:
        env = Environment.from_hdri(load_hdr(hdr_path))
    else:
        env = Environment.from_color((0.4, 0.45, 0.5))
    return build_monomial_glass_scene(environment=env)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--spp", type=int, default=100)
    parser.add_argument("--hdr", default=None)
    parser.add_argument("--out", default="monomial_glass.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(args.hdr), Camera(), width=800, height=600, max_bounces=1,
                        num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
