"""Rays per second of whole renders of the port on one CUDA card, measured
as the JAX package's `bench.py` measures it.

    python3 -m rpt_tpu_torch.bench [--workloads cornell,dragon,dragon871k,lego,lego_toy]

Workloads, `bench.py`'s rows whose inputs exist in this repository
(width x height, bounces, shadow rays per vertex, warm-up samples, timed
samples):

- `cornell`   960x540, 2, 1, 2, 40: the Cornell box, analytic primitives
              and small brute-force meshes, no traversal kernel;
- `dragon`    960x540, 2, 2, 1, 10: the 120k-triangle trefoil, bvh8;
- `dragon871k` 960x540, 2, 2, 1, 5: the same scene at the real dragon's
              871,022 triangles, bvh8;
- `lego`      960x540, 5, 2, 1, 5: the 768-instance brick city, tlas8;
- `lego_toy`  960x540, 5, 1, 1, 10: the OBJ+MTL toy brick plane, bvh2,
              the asset-free stand-in for `teapot`.

Before timing, each workload passes two gates, as `bench.py`'s children
do: every kernel of its path (the threefry draw and the traversal kernels)
equals its plain torch version on the camera wavefront of sample 0, bit for
bit; and a 1-spp render through the captured graph equals one run eagerly,
bit for bit. A failed gate prints FAIL and exits nonzero with no line.

Timing: the warm-up samples (which capture the graph), then the median of
three runs of the timed samples through `make_render_many_fn` (one graph
replay per sample), each ending in `torch.cuda.synchronize()`, with the
relative spread (max - min) / median. Rays counted as `bench.py` counts
them: (bounces + 1) x (1 + shadow rays) x width x height x samples.

Output: one JSON line per workload with `bench.py`'s keys (metric, value,
unit, spread, device, resolution), plus the card's name and power limit
(nvidia-smi), the three times and the gates' verdicts. It runs on the card
unless given `--device cpu` (the tests use that, with WORKLOADS cut to a
tiny size); it writes no file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# name -> (width, height, max_bounces, shadow_rays_per_vertex, warmup, passes)
WORKLOADS = {
    "cornell": (960, 540, 2, 1, 2, 40),
    "dragon": (960, 540, 2, 2, 1, 10),
    "dragon871k": (960, 540, 2, 2, 1, 5),
    "lego": (960, 540, 5, 2, 1, 5),
    "lego_toy": (960, 540, 5, 1, 1, 10),
}
_FAMILIES = ("bvh8", "bvh2", "tlas8", "tlas2")


class GateFailed(RuntimeError):
    pass


def card_line():
    """nvidia-smi's `name, power.limit` of the first card, or None without
    a card."""
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else f"nvidia-smi failed: {out.stderr.strip()}"


def scene_and_camera(name: str):
    """(scene, camera, ray offset) of a workload: the rows of WORKLOADS, and
    the scenes `chip_smoke.py` drives besides (`monomial_glass`,
    `pegasus_trefoil`, `wine_glass_trefoil`, `fractal_spheres`, `compound`,
    `fractal_teapots_trefoil`
    (`examples.fractal_teapots`' 937 instances of the trefoil cut to the
    teapot's size, `scenes.TEAPOT_KNOT`); the ray offset of `bench.py`'s
    rows, the renderer's default for the example)."""
    from . import scenes

    if name == "cornell":
        return scenes.build_cornell_scene(), scenes.cornell_camera(), scenes.CORNELL_EPSILON
    if name == "dragon":
        return scenes.build_dragon_scene(), scenes.dragon_camera(), 1e-3
    if name == "dragon871k":
        return scenes.build_dragon_scene(target_tris=871_000), scenes.dragon_camera(), 1e-3
    if name == "lego":
        return scenes.build_brick_city(), scenes.lego_camera(), 1e-3
    if name == "monomial_glass":
        return scenes.build_monomial_glass_scene(sky_height=1024), scenes.monomial_glass_camera(), 1e-3
    if name == "pegasus_trefoil":
        return scenes.build_pegasus_trefoil_scene(), scenes.pegasus_camera(), 1e-3
    if name == "wine_glass_trefoil":
        return scenes.build_wine_glass_trefoil_scene(), scenes.wine_glass_camera(), 1e-3
    if name == "fractal_spheres":
        return scenes.build_fractal_spheres_scene(), scenes.fractal_spheres_camera(), 1e-3
    if name == "compound":
        return scenes.build_compound_scene(), scenes.compound_camera(), 1e-3
    if name == "fractal_teapots_trefoil":
        teapot = scenes.trefoil_mesh(*scenes.TEAPOT_KNOT)
        return scenes.build_fractal_teapots_scene(teapot), scenes.fractal_spheres_camera(), 1e-3
    return scenes.build_toy_plane_scene(), scenes.toy_plane_camera(), 1e-3


def kernel_gate(renderer) -> str:
    """Every kernel of the path against its plain version on the camera
    wavefront of sample 0: the threefry draw of the pixel jitter, and the
    closest and any hit of the scene's traversal pack (any hit with t_max
    the plain closest t, halved on every other ray)."""
    from . import random as rnd
    from .ops import bvh2, bvh8, tlas2, tlas8
    from .renderer import camera_rays_tiled, pixel_ndc_tiled

    sd, t_min, _ = renderer._pass_args()
    if sd.device.type != "cuda":
        return "cpu: plain versions only"
    ndc = pixel_ndc_tiled(renderer.width, renderer.height, sd.device)
    key = rnd.split(rnd.fold_in(rnd.PRNGKey(renderer.seed), 0), 3)[0]
    n = 2 * ndc[0].shape[0]
    dim = ndc[2]
    kw = dict(lo=float(np.float32(-1.0 / dim)), span=float(np.float32(1.0 / dim) - np.float32(-1.0 / dim)))
    if not torch.equal(rnd.threefry_kernel(rnd.UNIFORM, key, n, sd.device, **kw),
                       rnd.threefry_plain(rnd.UNIFORM, key, n, sd.device, **kw)):
        raise GateFailed("the threefry kernel differs from its plain version")
    checked = ["threefry"]
    o, d, _ = camera_rays_tiled(renderer.camera.to(sd.device), rnd.fold_in(rnd.PRNGKey(renderer.seed), 0), ndc)
    mods = dict(bvh8=bvh8, bvh2=bvh2, tlas8=tlas8, tlas2=tlas2)
    for fam in _FAMILIES:
        pack = getattr(sd, fam)
        if pack is None:
            continue
        mod = mods[fam]
        out_k = getattr(mod, f"{fam}_closest_kernel")(pack, o, d, t_min)
        out_p = getattr(mod, f"{fam}_closest_plain")(pack, o, d, t_min)
        if not all(torch.equal(a, b) for a, b in zip(out_k, out_p)):
            raise GateFailed(f"the {fam} closest-hit kernel differs from its plain walk")
        t_p = out_p[0]
        t_max = torch.where(t_p < 1e38, t_p, torch.full_like(t_p, 1e3))
        t_max[1::2] *= 0.5
        occ_k = getattr(mod, f"{fam}_occluded_kernel")(pack, o, d, t_min, t_max)
        occ_p = getattr(mod, f"{fam}_occluded_plain")(pack, o, d, t_min, t_max)
        if not torch.equal(occ_k, occ_p):
            raise GateFailed(f"the {fam} any-hit kernel differs from its plain walk")
        checked += [f"{fam}_closest", f"{fam}_occluded"]
    return "bit_equal: " + ",".join(checked)


def graph_gate(renderer) -> str:
    """A 1-spp render through make_render_many_fn against one run eagerly."""
    from .buffer import Buffer

    a = renderer.sample_into(Buffer.new(renderer.width, renderer.height, device=renderer.device), 1)
    b = renderer._sample_into_eager(Buffer.new(renderer.width, renderer.height, device=renderer.device), 1)
    if not (torch.equal(a.sum, b.sum) and torch.equal(a.sum_sq, b.sum_sq)):
        raise GateFailed("the graphed render differs from the eager one")
    return "bit_equal" if renderer.device.type == "cuda" else "cpu: both eager, bit_equal"


def run_workload(name: str, device, card=None) -> dict:
    from . import random as rnd
    from .profiling import rays_per_sample
    from .renderer import Renderer, make_render_many_fn

    width, height, bounces, shadow, warmup, passes = WORKLOADS[name]
    scene, camera, eps = scene_and_camera(name)
    renderer = Renderer(scene, camera, width=width, height=height, max_bounces=bounces, num_samples=1,
                        epsilon=eps, device=device)
    sd, t_min, ev_scale = renderer._pass_args()
    if rays_per_sample(sd, bounces) != (bounces + 1) * (1 + shadow):
        raise GateFailed(f"{name} casts {rays_per_sample(sd, bounces)} rays per sample, not bench.py's count")
    gates = {"kernels": kernel_gate(renderer), "graph_vs_eager": graph_gate(renderer)}

    fn = make_render_many_fn(sd, width, height, bounces)
    base = rnd.PRNGKey(renderer.seed)

    def run(start, n):
        out = fn(renderer.camera, base, start, n, t_min, ev_scale)
        if sd.device.type == "cuda":
            torch.cuda.synchronize(sd.device)
        return out

    run(0, warmup)
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        s, _ = run(warmup + rep * passes, passes)
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(s).all()):
        raise GateFailed(f"the {name} render is not finite")
    dt = sorted(times)[1]
    rays = (bounces + 1) * (1 + shadow) * width * height * passes
    on_card = sd.device.type == "cuda"
    return {
        "metric": f"{name}_rays_per_sec", "value": rays / dt, "unit": "rays/s",
        "spread": (max(times) - min(times)) / dt, "device": "gpu" if on_card else "cpu",
        "resolution": f"{width}x{height}", "card": card, "kind": torch.cuda.get_device_name(0) if on_card else None,
        "bounces": bounces, "shadow_rays": shadow, "warmup": warmup, "passes": passes, "seconds": times,
        "gates": gates,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workloads", default=",".join(WORKLOADS))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    unknown = [w for w in args.workloads.split(",") if w not in WORKLOADS]
    if unknown:
        p.error(f"unknown workloads {unknown}; known: {sorted(WORKLOADS)}")
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else None
    for name in args.workloads.split(","):
        try:
            row = run_workload(name, device, card)
        except GateFailed as e:
            print(f"FAIL: {name}: {e}", flush=True)
            return 1
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
