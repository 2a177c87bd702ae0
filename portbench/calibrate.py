"""The readings that the limits of a cell's check are set from, on the card
at the cell's own size, in one process (set-up once):

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

- the program, for each seed of `--seeds`: the frames a run of that seed
  checks (`frames` of them, keyed as the window keys its frames 0, 1, ...),
  through the traffic's own entry, compared with the plain reference at the
  pixels that seed draws, as a run compares them;
- the control, for each seed of `--control-seeds`: the plain reference
  computed in bfloat16 (the precision below the float32 the configuration
  states) in the program's place, compared the same way.

One JSON line per reading on standard output. The benchmark's runs do not
run this; `PERF.md` keeps what it read and the limits set from it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_frames(spec, seeds: list, pixels, device, dtype, with_sums: bool) -> list:
    """Frames as the reference in `dtype` renders them, in the program's
    place; with their sums where the cell's entry returns its buffer."""
    from portbench import check
    from portbench.frames import Frame
    from portbench.reference.trace import image_bytes

    out = []
    for (s, ss), seed in zip(check.reference_renders(spec, seeds, pixels, device, dtype), seeds):
        sums = (s, ss) if with_sums else (None, None)
        out.append(Frame(0, seed, 0.0, 0.0, [], image_bytes(s / spec.spp), *sums, spec.spp))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, CHECKOUT)
    import torch

    from portbench import check, frames as fr, harness

    harness.set_cache_dirs()
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = [int(x) for x in args.control_seeds.split(",") if x]
    c = harness.prepare(args.workload, (seeds or controls)[0], CHECKOUT, "cuda")
    c.driver.frame(-1, fr.frame_seed(0, -1))
    spec, limits, n = c.spec, c.limits, c.limits["frames"]
    for seed in seeds:
        t0 = time.perf_counter()
        pixels = check.sample_pixels(seed, spec.width, spec.height, limits["pixels"])
        c.driver.keep(pixels)
        frames = [c.driver.frame(k, fr.frame_seed(seed, k)) for k in range(n)]
        refs = check.reference_renders(spec, [f.seed for f in frames], pixels, "cuda")
        print(json.dumps({"workload": args.workload, "side": "program", "seed": seed,
                          "numbers": check.numbers(frames, refs, frames[0].count),
                          "seconds": time.perf_counter() - t0}), flush=True)
    for seed in controls:
        t0 = time.perf_counter()
        pixels = check.sample_pixels(seed, spec.width, spec.height, limits["pixels"])
        keyed = [fr.frame_seed(seed, k) for k in range(n)]
        frames = control_frames(spec, keyed, pixels, "cuda", torch.bfloat16, c.driver.entry != "render")
        refs = check.reference_renders(spec, keyed, pixels, "cuda")
        print(json.dumps({"workload": args.workload, "side": "control bfloat16", "seed": seed,
                          "numbers": check.numbers(frames, refs, spec.spp),
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
