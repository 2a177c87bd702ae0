"""Two metallic teapots, one mirror-shiny and one brushed, under an HDRI.

`examples/metal.py` on the port (1200x900, 20 spp, 5 bounces). The map is
`--hdr`'s file or, without it, the procedural sky (`scenes.procedural_sky`);
the mesh is `--obj`'s, the reference's teapot by default. The two teapots
share one mesh, so the compile takes the two-level path:

    python -m rpt_tpu_torch.examples.metal [--obj PATH] [--hdr PATH] [--spp N] [--width W] [--height H] [--bounces N] [--out PATH] [--device DEVICE]
"""

import argparse

from .. import Camera, Environment, Material, Object, Renderer, Scene, hex_color, load_obj
from ..io.image import load_hdr
from ..scenes import procedural_sky
from . import _cli

DEFAULT_OBJ = "/root/reference/examples/teapot.obj"


def build_scene(obj_path, hdr_path=None) -> Scene:
    scene = Scene()
    if hdr_path:
        scene.set_environment(Environment.from_hdri(load_hdr(hdr_path)))
    else:
        scene.set_environment(Environment.from_hdri(procedural_sky()))

    teapot = load_obj(obj_path)
    scene.add(Object(teapot.scale([0.5, 0.5, 0.5]).translate([0.0, -1.7, 0.0]))
              .material(Material.metallic_mat(hex_color(0xFFFFFF), 0.1)))
    scene.add(Object(teapot.scale([0.5, 0.5, 0.5]).translate([0.0, 0.2, 0.0]))
              .material(Material.metallic_mat(hex_color(0xFFFFFF), 0.0001)))
    return scene


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--obj", default=DEFAULT_OBJ)
    parser.add_argument("--hdr", default=None)
    parser.add_argument("--spp", type=int, default=20)
    parser.add_argument("--width", type=int, default=1200)
    parser.add_argument("--height", type=int, default=900)
    parser.add_argument("--bounces", type=int, default=5)
    parser.add_argument("--out", default="metal.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    scene = build_scene(args.obj, args.hdr)
    renderer = Renderer(scene, Camera(), width=args.width, height=args.height, max_bounces=args.bounces,
                        num_samples=args.spp, device=args.device)
    return _cli.save(args.out, _cli.render(renderer))


if __name__ == "__main__":
    main()
