"""A Lego model through the OBJ+MTL path (a mesh of many materials).

`examples/lego.py` on the port (960x540, 20 spp, 5 bounces, the variance
printed every 5 samples). `--zip` reads the first .obj and the first .mtl
of a zip; without it the procedural toy brick plane (`scenes.toy_plane_obj`,
`scenes.TOY_MTL`) takes the same path. The scene is
`scenes.build_lego_scene` of the loaded objects. `build_brick_city` is the
instanced scene of the `lego` benchmark row:

    python -m rpt_tpu_torch.examples.lego [--zip PATH] [--spp N] [--width W] [--height H] [--bounces N] [--out PATH] [--device DEVICE]
"""

import argparse
import io
import zipfile

from .. import Renderer, Scene
from ..io.obj import load_obj_with_mtl
from ..scenes import TOY_MTL, build_brick_city, build_lego_scene, toy_plane_camera, toy_plane_obj
from . import _cli

__all__ = ["TOY_MTL", "toy_plane_obj", "load_lego", "build_scene", "build_brick_city", "main"]


def load_lego(zip_path=None):
    """The objects of the zip's first .obj and .mtl, or of the toy plane."""
    if zip_path:
        with zipfile.ZipFile(zip_path) as zf:
            names = zf.namelist()
            print(f"Zip has contents: {names}")
            obj_name = next(n for n in names if n.lower().endswith(".obj"))
            mtl_name = next(n for n in names if n.lower().endswith(".mtl"))
            with zf.open(obj_name) as fo, zf.open(mtl_name) as fm:
                return load_obj_with_mtl(io.TextIOWrapper(fo, encoding="utf-8", errors="replace"),
                                         io.TextIOWrapper(fm, encoding="utf-8", errors="replace"))
    print("No --zip given; using the procedural toy plane (same OBJ+MTL path)")
    return load_obj_with_mtl(io.StringIO(toy_plane_obj()), io.StringIO(TOY_MTL))


def build_scene(zip_path=None) -> Scene:
    return build_lego_scene(load_lego(zip_path))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--zip", default=None)
    parser.add_argument("--spp", type=int, default=20)
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=540)
    parser.add_argument("--bounces", type=int, default=5)
    parser.add_argument("--out", default="lego.png")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    renderer = Renderer(build_scene(args.zip), toy_plane_camera(), width=args.width, height=args.height,
                        max_bounces=args.bounces, num_samples=args.spp, device=args.device)
    buffer = _cli.progressive(renderer, 5)
    return _cli.save(args.out, buffer.image())


if __name__ == "__main__":
    main()
