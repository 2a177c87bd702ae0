"""A frame loop: a cube slides while the scene is rendered anew every frame.

`examples/simple_video.py` on the port: 10 frames at 800x600, 10 spp, 1
bounce by default, `--full` for the Rust original's 60 frames at 100 spp.
Every frame is `Renderer(..., seed=i, dynamic=True)`: the scene keeps its
topology, so one captured graph serves the whole loop. The frames are
muxed with ffmpeg where it is installed:

    python -m rpt_tpu_torch.examples.simple_video [--frames N] [--spp N] [--full] [--outdir DIR] [--device DEVICE]
"""

import argparse
import math
import os
import subprocess
import time

from .. import AmbientLight, Camera, Material, Object, PointLight, Renderer, Scene, cube, hex_color, plane, sphere
from . import _cli


def build_scene(i: int) -> Scene:
    scene = Scene()
    scene.add(Object(sphere()))
    scene.add(Object(cube().rotate_y(math.pi / 6.0).scale([0.5, 0.3, 0.4]).translate([0.4, -0.8, 4.0 + 0.01 * i]))
              .material(Material.specular(hex_color(0xFF00FF), 0.5)))
    scene.add(Object(sphere().scale([0.5] * 3).translate([1.5, -0.5, 1.0]))
              .material(Material.specular(hex_color(0x0000FF), 0.1)))
    scene.add(Object(sphere().scale([0.5] * 3).translate([-1.5, -0.5, 1.0]))
              .material(Material.specular(hex_color(0x00FF00), 0.1)))
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.specular(hex_color(0xAAAAAA), 0.5)))
    scene.add(AmbientLight((0.01, 0.01, 0.01)))
    scene.add(PointLight((100.0, 100.0, 100.0), (0.0, 5.0, 5.0)))
    return scene


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--spp", type=int, default=10)
    parser.add_argument("--full", action="store_true", help="reference config")
    parser.add_argument("--outdir", default="video")
    _cli.add_device(parser)
    args = parser.parse_args(argv)
    frames, spp = (60, 100) if args.full else (args.frames, args.spp)

    os.makedirs(args.outdir, exist_ok=True)
    img = None
    for i in range(frames):
        t0 = time.time()
        img = Renderer(build_scene(i), Camera(), width=800, height=600, max_bounces=1, num_samples=spp, seed=i,
                       dynamic=True,  # the same topology every frame: one graph
                       device=args.device).render()
        _cli.save(f"{args.outdir}/image_{i}.png", img)
        print(f"frame {i} in {time.time() - t0:.2f}s")

    try:
        subprocess.run(["ffmpeg", "-y", "-i", f"{args.outdir}/image_%d.png", "-vcodec", "libx264", "-s", "800x600",
                        "-pix_fmt", "yuv420p", "video.mp4"], check=True)
        print("Saved video.mp4")
    except FileNotFoundError:
        print("ffmpeg not available; frames are in", args.outdir)
    return img


if __name__ == "__main__":
    main()
