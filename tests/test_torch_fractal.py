"""`examples/fractal_spheres.py` (937 spheres in five levels) through the
port against the JAX package, on the CPU: the chunked sphere path.

The scene's spheres compile into one batch of 937, past `PRIM_CHUNK` (256),
so every closest hit and shadow query takes them in four chunks
(`scene._maybe_chunked` / `_maybe_chunked_occl`; the reference's
`rpt_tpu/scene.py:530-570`). The level of 750 spheres alone spans three.

- On the reference's own camera rays, the port's depth-0 hits equal the
  reference's run eagerly (`jax.disable_jit()`: its chunk loop and sphere
  test op by op): the hit mask and `mat_id` exact, `t` bit for bit, and the
  shadow query bit for bit; and the radiance of those rays at the example's
  0 bounces agrees on every ray to the port's render tolerance (rtol 1e-3,
  atol 1e-4).
- The image against the reference's jitted render is held to a lower bar,
  FRACTAL_SHARE of pixels and the mean to FRACTAL_MEAN_RTOL (measured at
  64x48, 1 spp, seed 7, 0 bounces: 0.9635 of pixels, the mean 1.015e-3
  apart). Two roundings make it, neither a fault of the port
  (`ROADMAP.md` §3): the reference's jitted sphere test rounds apart from
  its eager one on the small, distant spheres of the last levels, and,
  likely, its camera rays lie an ulp from the port's (XLA contracts the
  camera's products into FMAs; `tests/test_torch_grad.py` `level_cam`),
  which on a sphere of radius 0.0256 can change the hit. On the same rays the two agree on every ray
  (the tests above).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch
import rpt_tpu_torch.scene as scene_mod
from rpt_tpu.integrator import trace_paths as ref_trace_paths
from rpt_tpu.renderer import pixel_ndc_tiled as ref_pixel_ndc_tiled
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch.integrator import trace_paths
from rpt_tpu_torch.ops import intersect as ops
from rpt_tpu_torch.scenes import build_fractal_spheres_scene, fractal_placements, fractal_spheres_camera

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)
import fractal_spheres  # noqa: E402
from _fractal import LEVEL_COLORS, fractal_placements as ref_fractal_placements  # noqa: E402

W, H = 64, 48
SEED = 7
EPS = 1e-3
FRACTAL_SHARE = 0.95
FRACTAL_MEAN_RTOL = 2e-3


@pytest.fixture(scope="module")
def scenes():
    """(reference scene, its compiled data, its camera, port scene, its
    compiled data, its camera)."""
    ref_scene = fractal_spheres.build_scene()
    port_scene = build_fractal_spheres_scene()
    return (ref_scene, ref_scene.compile(), fractal_spheres.make_camera(), port_scene,
            port_scene.compile(device="cpu"), fractal_spheres_camera())


@pytest.fixture(scope="module")
def camera_rays(scenes):
    """The reference's camera rays of sample 0 at W x H (tile order)."""
    ref_cam = scenes[2]
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    xg, yg, dim, _ = ref_pixel_ndc_tiled(W, H)
    k_jit, k_cam, _ = jax.random.split(key, 3)
    jitter = jax.random.uniform(k_jit, (2, xg.shape[0]), jnp.float32, -1.0 / dim, 1.0 / dim)
    o, d = ref_cam.cast_rays(xg + jitter[0], yg + jitter[1], k_cam)
    return o, d, torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d))


def test_placements_and_compiled_spheres_match_reference(scenes):
    """The recursion's copy gives the reference's placements and colors, and
    both packages compile the same 937 spheres (1 + 6 + 30 + 150 + 750)."""
    assert fractal_placements(5) == ref_fractal_placements(5)
    assert list(rpt_tpu_torch.scenes.LEVEL_COLORS) == list(LEVEL_COLORS)
    assert [len(level) for level in fractal_placements(5)] == [1, 6, 30, 150, 750]
    _, ref_sd, _, _, sd, _ = scenes
    assert sd.spheres.inv_tf.shape[0] == 937 > scene_mod.PRIM_CHUNK
    for f in ("inv_tf", "nmat", "mat_id"):
        np.testing.assert_array_equal(getattr(sd.spheres, f).numpy(), np.asarray(getattr(ref_sd.spheres, f)))


def _chunk_sizes(monkeypatch, name):
    sizes = []
    orig = getattr(ops, name)

    def counted(o, d, t_min, *rest):
        sizes.append(rest[-1].shape[0])
        return orig(o, d, t_min, *rest)

    monkeypatch.setattr(ops, name, counted)
    return sizes


def test_depth0_hits_equal_the_eager_reference(scenes, camera_rays, monkeypatch):
    """Hit mask and `mat_id` exact, `t` bit for bit, against the reference's
    `SceneData.intersect` run eagerly; the port's closest hit takes the 937
    spheres in chunks of 256, 256, 256 and 169."""
    _, ref_sd, _, _, sd, _ = scenes
    o, d, o_t, d_t = camera_rays
    with jax.disable_jit():
        ref = ref_sd.intersect(o, d, jnp.float32(EPS))
    sizes = _chunk_sizes(monkeypatch, "intersect_spheres")
    got = sd.intersect(o_t, d_t, EPS)
    assert sizes == [256, 256, 256, 169]
    t_ref = np.asarray(ref.t)
    hit = np.isfinite(t_ref)
    spheres = hit & (np.asarray(ref.mat_id) < 5)  # the plane is material 5
    assert 0.2 < spheres.mean() < 0.9
    np.testing.assert_array_equal(np.isfinite(got.t.numpy()), hit)
    np.testing.assert_array_equal(got.mat_id.numpy()[hit], np.asarray(ref.mat_id)[hit])
    assert len(set(got.mat_id.numpy()[hit].tolist())) == 6  # five levels and the plane
    np.testing.assert_array_equal(got.t.numpy(), t_ref)


def test_shadow_query_equals_the_eager_reference(scenes, camera_rays, monkeypatch):
    """The any hit over the chunks (an OR), bit for bit with the reference's
    `SceneData.occluded` run eagerly, at t_max the closest t (closed, so
    every hit counts) on even rays and half of it on odd ones."""
    _, ref_sd, _, _, sd, _ = scenes
    o, d, o_t, d_t = camera_rays
    t = sd.intersect(o_t, d_t, EPS).t
    t_max = torch.where(torch.isfinite(t), t, torch.full_like(t, 100.0))
    t_max[1::2] *= 0.5
    with jax.disable_jit():
        want = np.asarray(ref_sd.occluded(o, d, jnp.float32(EPS), jnp.asarray(t_max.numpy())))
    sizes = _chunk_sizes(monkeypatch, "occluded_spheres")
    got = sd.occluded(o_t, d_t, EPS, t_max)
    assert sizes == [256, 256, 256, 169]
    assert 0.2 < want.mean() < 0.8
    np.testing.assert_array_equal(got.numpy(), want)


def test_radiance_of_the_same_rays_matches_the_eager_reference(scenes, camera_rays):
    """0 bounces (the example's): emitted, ambient and the point light's
    shadowed term on every ray, against the reference's `trace_paths` run
    eagerly on the same rays and key."""
    _, ref_sd, _, _, sd, _ = scenes
    o, d, o_t, d_t = camera_rays
    with jax.disable_jit():
        want = np.asarray(ref_trace_paths(ref_sd, o, d, jax.random.PRNGKey(3), 0, jnp.float32(EPS)))
    got = trace_paths(sd, o_t, d_t, rnd.PRNGKey(3), 0, EPS).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.0
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    assert close.all(), f"{(~close).sum()} rays differ"


def test_image_matches_the_jitted_reference(scenes):
    """The example's render (0 bounces, 1 spp) at 64x48 against the
    reference's jitted one, at the bar stated in the module docstring."""
    ref_scene, _, ref_cam, port_scene, _, cam = scenes
    want = np.asarray(rpt_tpu.Renderer(ref_scene, ref_cam, width=W, height=H, seed=SEED).render_buffer().mean_image())
    got = rpt_tpu_torch.Renderer(port_scene, cam, width=W, height=H, seed=SEED, device="cpu").render_buffer()
    got = got.mean_image().numpy()
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    print(f"pixels agreeing: {close.mean():.4f}, mean apart {abs(got.mean() - want.mean()) / want.mean():.3e}")
    assert close.mean() >= FRACTAL_SHARE, f"only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= FRACTAL_MEAN_RTOL * abs(want.mean())
