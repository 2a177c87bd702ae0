"""Marbles falling into a glass: RK4 physics between per-frame renders.

`examples/marbles.py` on the port: 25 marbles (`ode.MarblesSystem`) in a
clear monomial glass. By default the quick test configuration (8 frames at
200x150, 1 spp, 7 bounces, an ambient light); `--full` takes the Rust
original's 180 frames at 800x600, 2000 spp and 9 bounces under a sphere
light. Every frame is `Renderer(..., seed=frame, dynamic=True)`; the state
advances 1/16 s between frames. The scene is `scenes.build_marbles_scene`:

    python -m rpt_tpu_torch.examples.marbles [--frames N] [--full] [--outdir DIR] [--device DEVICE]
"""

import argparse
import os
import subprocess
import time

from .. import Renderer, Scene
from ..ode import MarblesSystem, ParticleState
from ..scenes import MARBLE_COLORS, MARBLE_RADIUS, MARBLES, build_marbles_scene, marbles_camera, marbles_initial_state
from . import _cli

COLORS = list(MARBLE_COLORS)
N = MARBLES
R = MARBLE_RADIUS


def initial_state(seed=123, device=None) -> ParticleState:
    """The marbles at rest above the glass, on `device` (the card when None)."""
    return marbles_initial_state(seed, device=device)


def build_scene(state: ParticleState, test_mode: bool) -> Scene:
    return build_marbles_scene(state, test_mode)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--full", action="store_true")
    parser.add_argument("--outdir", default="video")
    _cli.add_device(parser)
    args = parser.parse_args(argv)

    if args.full:
        frames, width, height, spp, bounces = 180, 800, 600, 2000, 9
    else:
        frames, width, height, spp, bounces = args.frames, 200, 150, 1, 7

    os.makedirs(args.outdir, exist_ok=True)
    camera = marbles_camera()
    state = initial_state(device=args.device)
    system = MarblesSystem(radius=R)
    img = None
    for frame in range(frames):
        t0 = time.time()
        img = Renderer(build_scene(state, not args.full), camera, width=width, height=height, max_bounces=bounces,
                       num_samples=spp, seed=frame,
                       dynamic=True,  # the same topology every frame: one graph
                       device=args.device).render()
        _cli.save(f"{args.outdir}/image_{frame}.png", img)
        state = system.rk4_integrate(state, 1.0 / 16.0, 1.0 / 10000.0)
        print(f"frame {frame} in {time.time() - t0:.2f}s")

    try:
        subprocess.run(["ffmpeg", "-y", "-i", f"{args.outdir}/image_%d.png", "-vcodec", "libx264", "-s",
                        f"{width}x{height}", "-pix_fmt", "yuv420p", "marbles.mp4"], check=True)
        print("Saved marbles.mp4")
    except FileNotFoundError:
        print("ffmpeg not available; frames are in", args.outdir)
    return img


if __name__ == "__main__":
    main()
