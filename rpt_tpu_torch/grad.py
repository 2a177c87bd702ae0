"""Differentiable rendering: gradients of pixels with respect to scene
parameters (`rpt_tpu/grad.py`), on torch autograd.

Pixel gradients with respect to the material table (albedo, roughness,
emittance, IOR, metallic) and the camera flow through the path-integral
estimator with detached sampling: `trace_paths` treats each sampled
direction and its pdf as constants, which is unbiased for the continuous
integrand. The traversal kernels return a hit time and a triangle id with
no gradient; material gradients never need one (their rays do not depend on
the materials), and a ray that requires grad raises at the walk, as the
reference's while loop cannot be reversed either. So camera gradients exist
for scenes without a BVH, as in the reference.

The path is eager: each sample is one pass of torch ops and kernel launches
under `torch.utils.checkpoint` (the counterpart of the reference's
`lax.scan` of a `jax.checkpoint`ed body), so memory stays O(1) in spp. The
backward pass runs each sample's forward again, launches included; the
recompute is exact because every draw comes from an explicit threefry key.

Typical use:

    img_fn, mats0 = make_diff_render(scene, camera, width=32, height=32, spp=4)
    mats = MaterialTable(**{f: v.clone().requires_grad_() for f, v in vars(mats0).items()})
    torch.mean((img_fn(mats) - target) ** 2).backward()
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from . import random as rnd
from .materials import MaterialTable
from .renderer import SceneCache, pixel_ndc_tiled, render_pass_tiled, scene_cache_key
from .utils.vmath import real_value

__all__ = ["make_material_render_fn", "render_with_materials", "render_with_camera", "make_diff_render"]

# Keyed by the compiled scene's digest, bounded, pinning each scene: see
# renderer.SceneCache.
_DIFF_CACHE = SceneCache()


def make_material_render_fn(scene_data, width: int, height: int, max_bounces: int, spp: int):
    """(materials, camera, key, t_min, ev_scale) -> (H, W, 3) image, the mean
    of `spp` samples on the compiled scene's device; differentiable in the
    materials and the camera. Sample i is keyed by fold_in(key, i) and the
    frames are summed left to right, as the reference does. Cached per
    (scene, width, height, max_bounces, spp)."""
    cache_key = (scene_cache_key(scene_data), width, height, max_bounces, spp)
    fn = _DIFF_CACHE.get(cache_key)
    if fn is None:
        device, dtype = scene_data.device, scene_data.dtype
        ndc = pixel_ndc_tiled(width, height, device, dtype)
        inv = ndc[3]

        def fn(materials, camera, key, t_min, ev_scale):
            if materials.color.dtype != dtype:
                raise TypeError(f"a {dtype} scene cannot take {materials.color.dtype} materials")
            sd = dataclasses.replace(scene_data, materials=materials)
            cam = camera.to(device)
            t = real_value(float(t_min), dtype)

            def sample(i):
                return render_pass_tiled(sd, cam, rnd.fold_in(key, i), ndc, max_bounces, t, ev_scale)

            acc = torch.zeros((width * height, 3), dtype=dtype, device=device)
            for i in range(spp):
                acc = acc + checkpoint(sample, i, use_reentrant=False, preserve_rng_state=False)
            return acc[inv].reshape(height, width, 3) / spp

        _DIFF_CACHE.put(cache_key, fn, scene_data)
    return fn


def render_with_materials(
    materials: MaterialTable,
    scene_data,
    camera,
    key,
    width,
    height,
    max_bounces,
    t_min,
    ev_scale,
    spp: int = 1,
):
    """An spp-averaged frame as a differentiable function of the material
    table (and the camera). The estimator and the keys are Renderer's, so
    the values match a forward render of the same samples."""
    fn = make_material_render_fn(scene_data, width, height, max_bounces, spp)
    return fn(materials, camera, key, t_min, ev_scale)


def render_with_camera(
    camera,
    scene_data,
    key,
    width,
    height,
    max_bounces,
    t_min,
    ev_scale,
    spp: int = 1,
):
    """Differentiable in the camera's fields (eye, direction, fov, ...);
    the scene must have no BVH (see the module docstring)."""
    fn = make_material_render_fn(scene_data, width, height, max_bounces, spp)
    return fn(scene_data.materials, camera, key, t_min, ev_scale)


def make_diff_render(
    scene,
    camera,
    width: int,
    height: int,
    max_bounces: int = 2,
    spp: int = 1,
    epsilon: float = 1e-3,
    exposure_value: float = 0.0,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
):
    """Build `materials -> (H, W, 3) image`, differentiable, on `device` (the
    CUDA card when None; raises without one) in `dtype`, keyed by
    PRNGKey(seed) (the x64 key in float64, as Renderer's). Returns it and
    the compiled scene's material table."""
    scene_data = scene.compile(dtype, device=device)
    t_min = real_value(epsilon, dtype)
    ev_scale = real_value(2.0 ** exposure_value, dtype)
    key = rnd.PRNGKey(seed, x64=dtype == torch.float64)
    fn = make_material_render_fn(scene_data, width, height, max_bounces, spp)

    def img_fn(materials: MaterialTable):
        return fn(materials, camera, key, t_min, ev_scale)

    return img_fn, scene_data.materials
