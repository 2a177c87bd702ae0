"""Profiling and observability (`rpt_tpu/profiling.py`): device traces, rays/s
counters, wavefront occupancy.

- `device_trace(logdir)`: a `torch.profiler` trace of everything inside the
  block (the host's ops and, on a CUDA card, its kernels), written where
  TensorBoard (`tensorboard --logdir <logdir>`) or Perfetto opens it.
- `rays_per_sample`: the ray accounting of every rays/s number: one camera
  or bounce ray per depth plus one shadow ray per shadow-casting light per
  path vertex.
- `measure_rays_per_sec`: time full-frame samples through the renderer's
  many-sample function (on the card, one CUDA graph replay per sample).
- `depth_stats`: per-depth live-lane occupancy of one 1-spp pass, in the
  32x32-tile ray order the kernels see.

Each takes the renderer's real type, as the reference's take the scene's:
a float64 renderer times and counts float64 passes.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

__all__ = ["device_trace", "rays_per_sample", "measure_rays_per_sec", "depth_stats"]


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace everything inside the block into `logdir` (a Chrome trace JSON
    file that TensorBoard's profile plugin and Perfetto open):

        with rpt_tpu_torch.profiling.device_trace("traces"):
            renderer.render()
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _n_shadow_lights(scene_data) -> int:
    """Lights that cost a shadow ray per path vertex (all but ambient)."""
    from .lights import AmbientLightData

    return sum(0 if isinstance(light, AmbientLightData) else 1 for light in scene_data.lights)


def rays_per_sample(scene_data, max_bounces: int) -> int:
    """Rays traced per pixel per sample: one closest hit per depth plus one
    shadow ray per shadow-casting light per depth."""
    return (max_bounces + 1) * (1 + _n_shadow_lights(scene_data))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_rays_per_sec(renderer, warmup: int = 2, passes: int = 8) -> dict:
    """Time `passes` full-frame samples through `make_render_many_fn` (after
    `warmup` samples, which also capture its graph on the card), ending in a
    device synchronize. Returns {"rays_per_sec", "samples_per_sec",
    "seconds", "rays"}."""
    from .renderer import make_render_many_fn

    scene_data, t_min, ev_scale = renderer._pass_args()
    fn = make_render_many_fn(scene_data, renderer.width, renderer.height, renderer.max_bounces)
    base = renderer.base_key()

    def run(start, n):
        out = fn(renderer.camera, base, start, n, t_min, ev_scale)
        _sync(scene_data.device)
        return out

    run(0, warmup)
    t0 = time.perf_counter()
    run(warmup, passes)
    dt = time.perf_counter() - t0
    rays = renderer.width * renderer.height * rays_per_sample(scene_data, renderer.max_bounces) * passes
    return {"rays_per_sec": rays / dt, "samples_per_sec": passes / dt, "seconds": dt, "rays": rays}


def depth_stats(renderer, seed: int | None = None) -> dict:
    """Per-depth wavefront occupancy of one 1-spp pass, as numpy arrays:
    found_frac[d], the share of lanes that hit a surface at depth d, and
    cont_frac[d], the share still alive entering depth d+1 (the lanes every
    deeper traversal carries). Keyed by PRNGKey(seed) itself, as the
    reference's is (the renderer's seed when None), in the renderer's type."""
    from . import random as rnd
    from .integrator import trace_paths
    from .renderer import camera_rays_tiled, pixel_ndc_tiled

    scene_data, t_min, _ = renderer._pass_args()
    ndc = pixel_ndc_tiled(renderer.width, renderer.height, scene_data.device, scene_data.dtype)
    key = rnd.PRNGKey(renderer.seed if seed is None else seed, x64=scene_data.dtype == torch.float64)
    o, d, k_trace = camera_rays_tiled(renderer.camera.to(scene_data.device), key, ndc)
    _, stats = trace_paths(scene_data, o, d, k_trace, renderer.max_bounces, t_min, want_stats=True)
    return {k: np.asarray(v.cpu().numpy()) for k, v in stats.items()}
