"""Monomial surfaces and their lights in the port against the JAX package.

`ops.intersect.intersect_monomials` (the Newton bracket and the 60-step
bisection) and the scene's shadow query over it are held to the reference
on random rays at two transformed surfaces: hit mask and material exact,
`t` to rtol/atol 2e-5 on at least 99.9% of the hits (the bar of
`assert_depth0_agrees`), normals to rtol 1e-4, the shadow query exact on
the same 99.9%. `MonomialLightData.illuminate` draws the reference's
numbers from the same key: its normal flips exactly, intensity, direction
and distance to rtol 1e-5 (atol 1e-5: where the light's cosine is near
zero, a float32 ulp of the dot product is a large share of it; intensities
here reach 50). Each runs in float32 and, under
`jax.enable_x64`, in float64. Whole renders of the `monomial_glass` scene
(under a small procedural sky) and of the monomial light's scene go
through each package's own `Scene.compile` and through
`convert.scene_data_from_arrays`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch
from rpt_tpu.ops import intersect as ref_ops
from rpt_tpu.scene import compile_scene as ref_compile_scene
from rpt_tpu_torch import convert
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch.ops import intersect as ops
from rpt_tpu_torch.scenes import (
    build_monomial_glass_scene,
    build_monomial_light_scene,
    monomial_glass_camera,
    monomial_light_camera,
)
from test_monomial_light import _light_scene as ref_light_scene
from test_torch_f64 import assert_f64_images_agree
from test_torch_reference_native import reference_native
from test_torch_render import assert_images_agree, reference_camera, reference_tree

reference_native()

T_MIN = 1e-3
SEED = 7
DTYPES = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64)}


def x64(on: bool):
    return jax.enable_x64(on)


def _surfaces(pkg):
    """Two transformed monomial surfaces of different heights."""
    scene = pkg.Scene()
    scene.add(pkg.Object(pkg.monomial_surface(2.0, 4.0).translate([0.0, -1.0, 0.0]))
              .material(pkg.Material.metallic_mat(pkg.hex_color(0xFFFFFF), 0.0001)))
    scene.add(pkg.Object(pkg.monomial_surface(0.5, 4.0).scale([1.5, 2.0, 0.8]).rotate_x(0.6)
                         .translate([2.5, 0.5, -1.0]))
              .material(pkg.Material.diffuse(pkg.hex_color(0x884422))))
    return scene


def _rays(n=4000, seed=0):
    """Rays from a sphere of radius 7 aimed at points around both surfaces."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 7.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    centers = np.array([[0.0, 0.0, 0.0], [2.5, 1.0, -1.0]])
    target = centers[rng.integers(0, 2, n)] + rng.uniform(-1.3, 1.3, (n, 3))
    d = target - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _hits(dtype_name):
    """Both packages' closest hits and shadow queries on the same rays."""
    tdt, jdt = DTYPES[dtype_name]
    o, d = _rays()
    with x64(dtype_name == "f64"):
        ref_sd = _surfaces(rpt_tpu).compile(jdt)
        m = ref_sd.monomials
        oj, dj = jnp.asarray(o, jdt), jnp.asarray(d, jdt)
        ref = ref_ops.intersect_monomials(oj, dj, T_MIN, m.inv_tf, m.nmat, m.height, m.mat_id)
        t_ref = np.asarray(ref.t)
        t_max = np.where(np.arange(len(o)) % 2 == 0, np.where(np.isfinite(t_ref), t_ref * 0.5, 20.0), 20.0)
        occ_ref = np.asarray(ref_sd.occluded(oj, dj, T_MIN, jnp.asarray(t_max, jdt)))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    sd = _surfaces(rpt_tpu_torch).compile(tdt, device="cpu")
    ot, dt = torch.as_tensor(o, dtype=tdt), torch.as_tensor(d, dtype=tdt)
    got = ops.intersect_monomials(ot, dt, T_MIN, sd.monomials.inv_tf, sd.monomials.nmat, sd.monomials.height,
                                  sd.monomials.mat_id)
    occ = sd.occluded(ot, dt, T_MIN, torch.as_tensor(t_max, dtype=tdt)).numpy()
    scene_hit = sd.intersect(ot, dt, T_MIN)
    return ref, occ_ref, got, occ, scene_hit, sd


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_intersect_monomials_matches_reference(dtype_name):
    ref, occ_ref, got, occ, scene_hit, sd = _hits(dtype_name)
    tdt = DTYPES[dtype_name][0]
    assert got.t.dtype == tdt and got.normal.dtype == tdt
    hit_ref = np.isfinite(ref.t)
    assert 0.2 < hit_ref.mean() < 0.95, hit_ref.mean()
    np.testing.assert_array_equal(np.isfinite(got.t.numpy()), hit_ref)
    np.testing.assert_array_equal(got.mat_id.numpy()[hit_ref], ref.mat_id[hit_ref])
    # Both surfaces are hit.
    assert set(ref.mat_id[hit_ref].tolist()) == {0, 1}
    t_ok = np.isclose(got.t.numpy()[hit_ref], ref.t[hit_ref], rtol=2e-5, atol=2e-5)
    assert t_ok.mean() >= 0.999, f"t agrees on only {t_ok.mean():.5f} of the hits"
    np.testing.assert_allclose(got.normal.numpy()[hit_ref][t_ok], ref.normal[hit_ref][t_ok], rtol=1e-4, atol=1e-4)
    # The shadow query: exact wherever t agrees.
    ok_rays = np.ones_like(hit_ref)
    ok_rays[np.flatnonzero(hit_ref)[~t_ok]] = False
    np.testing.assert_array_equal(occ[ok_rays], occ_ref[ok_rays])
    assert occ.any() and not occ.all()
    # The scene dispatches to the same function.
    assert sd.monomials.height.dtype == tdt
    torch.testing.assert_close(scene_hit.t, got.t, rtol=0, atol=0)


def test_monomial_exp_other_than_4_is_refused():
    for pkg in (rpt_tpu, rpt_tpu_torch):
        scene = pkg.Scene()
        scene.add(pkg.Object(pkg.monomial_surface(2.0, 3.0)))
        with pytest.raises(ValueError):
            scene.compile(device="cpu") if pkg is rpt_tpu_torch else scene.compile()
        light = pkg.Scene()
        light.add(pkg.ObjectLight(pkg.Object(pkg.monomial_surface(2.0, 2.0)).material(pkg.Material.light((1, 1, 1), 1.0))))
        with pytest.raises(ValueError):
            light.compile(device="cpu") if pkg is rpt_tpu_torch else light.compile()


# ---------------------------------------------------------------------------
# The monomial light
# ---------------------------------------------------------------------------


def _light_scene_pair():
    return ref_light_scene(emittance=50.0), build_monomial_light_scene()


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_monomial_light_illuminate_matches_reference(dtype_name):
    tdt, jdt = DTYPES[dtype_name]
    ref_scene, port_scene = _light_scene_pair()
    rng = np.random.default_rng(3)
    pos = rng.uniform(-4.0, 4.0, (2048, 3))
    key = rnd.PRNGKey(11, x64=dtype_name == "f64")
    with x64(dtype_name == "f64"):
        light = ref_compile_scene(ref_scene, jdt).lights[0]
        assert type(light).__name__ == "MonomialLightData"
        k_flip = jax.random.split(jnp.asarray(key))[1]
        want_flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (2048,)))
        want = [np.asarray(a) for a in light.illuminate(jnp.asarray(key), jnp.asarray(pos, jdt))]
    port_light = port_scene.compile(tdt, device="cpu").lights[0]
    assert type(port_light).__name__ == "MonomialLightData"
    got = [a.numpy() for a in port_light.illuminate(key, torch.as_tensor(pos, dtype=tdt))]
    got_flip = rnd.bernoulli(rnd.split(key)[1], 0.5, (2048,), dtype=tdt).numpy()
    np.testing.assert_array_equal(got_flip, want_flip)
    assert 0.3 < got_flip.mean() < 0.7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.dtype(jdt)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_monomial_light_matches_reference_formula():
    """The reference's quadrature check (`tests/test_monomial_light.py`)
    run on the port: the Monte Carlo mean of illuminate() against a dense
    quadrature of the rim sample with its two normals."""
    light = build_monomial_light_scene().compile(device="cpu").lights[0]
    n = 8192
    target = np.array([0.0, -7.0, 0.0])
    pos = torch.as_tensor(np.tile(target[None, :], (n, 1)), dtype=torch.float32)
    intensity, wi, dist = light.illuminate(rnd.PRNGKey(0), pos)
    mc_mean = float(intensity[:, 0].mean())

    theta = np.linspace(0.0, 2.0 * np.pi, 20001)[:-1]
    x, z = np.cos(theta), np.sin(theta)
    h = 2.0
    p = np.stack([x, np.full_like(x, h + 3.0), z], -1)
    nrm = np.stack([h * 4.0 * x, -np.ones_like(x), h * 4.0 * z], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    area = 6.3406654362
    disp = p - target
    ln = np.linalg.norm(disp, axis=-1)
    expect = 0.0
    for sign in (1.0, -1.0):
        cosine = np.maximum(-(disp * sign * nrm).sum(-1), 0.0) / ln
        expect += 0.5 * np.mean(50.0 * (cosine / (ln * ln)) / (1.0 / (2.0 * area)))
    np.testing.assert_allclose(mc_mean, expect, rtol=0.05)
    assert float(wi[:, 1].mean()) > 0.9
    np.testing.assert_allclose(dist.numpy(), np.sqrt((h + 3.0 + 7.0) ** 2 + 1.0), rtol=1e-3)


# ---------------------------------------------------------------------------
# Whole renders
# ---------------------------------------------------------------------------


SKY = 16  # a 16x32 procedural sky: the quad form


def _glass_pair():
    import sys

    from test_torch_render import EXAMPLES

    sys.path.insert(0, EXAMPLES)
    import monomial_glass
    from _sky import procedural_sky

    ref = monomial_glass.build_scene()
    ref.set_environment(rpt_tpu.Environment.from_hdri(procedural_sky(SKY)))
    return (ref, rpt_tpu.Camera(), 1e-3), (build_monomial_glass_scene(SKY), monomial_glass_camera(), 1e-3)


def _light_pair():
    ref_scene, port_scene = _light_scene_pair()
    ref_cam = rpt_tpu.Camera.look_at([0.0, 2.0, 8.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0], math.pi / 4)
    return (ref_scene, ref_cam, 1e-3), (port_scene, monomial_light_camera(), 1e-3)


PAIRS = {"monomial_glass": (_glass_pair, 1), "monomial_light": (_light_pair, 0)}


# The render sizes of the two bars: `assert_images_agree` (64x48) and
# `assert_f64_images_agree` (32x24).
SIZE = {"f32": (64, 48), "f64": (32, 24)}


def _render_ref(scene, cam, eps, bounces, dtype_name):
    rpt_tpu.renderer._MANY_CACHE = rpt_tpu.renderer.SceneCache()
    jdt = DTYPES[dtype_name][1]
    W, H = SIZE[dtype_name]
    with x64(dtype_name == "f64"):
        r = rpt_tpu.Renderer(scene, cam, width=W, height=H, max_bounces=bounces, num_samples=1, epsilon=eps,
                             seed=SEED, dtype=jdt)
        return np.asarray(r.render_buffer().mean_image())


def _render_port(scene, cam, eps, bounces, dtype_name, scene_data=None):
    W, H = SIZE[dtype_name]
    r = rpt_tpu_torch.Renderer(scene, cam, width=W, height=H, max_bounces=bounces, num_samples=1, epsilon=eps,
                               seed=SEED, device="cpu", dtype=DTYPES[dtype_name][0])
    return r.render_buffer(scene_data=scene_data).mean_image().numpy()


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("name", list(PAIRS))
def test_render_matches_reference(name, dtype_name):
    """Each package's own compile, then the reference's compiled scene
    carried into the port, against the reference's image."""
    make, bounces = PAIRS[name]
    (ref_scene, ref_cam, eps), (port_scene, port_cam, _) = make()
    agree = assert_images_agree if dtype_name == "f32" else assert_f64_images_agree
    want = _render_ref(ref_scene, ref_cam, eps, bounces, dtype_name)
    port_sd = port_scene.compile(DTYPES[dtype_name][0], device="cpu")
    assert port_sd.monomials is not None or any(type(l).__name__ == "MonomialLightData" for l in port_sd.lights)
    got = _render_port(port_scene, port_cam, eps, bounces, dtype_name)
    agree(got, want)
    assert got.mean() > 1e-3
    with x64(dtype_name == "f64"):
        tree = reference_tree(ref_scene.compile(DTYPES[dtype_name][1]))
    converted = convert.scene_data_from_arrays(tree, device="cpu")
    assert converted.dtype == DTYPES[dtype_name][0]
    if name == "monomial_glass":
        assert converted.monomials is not None and converted.env_quad is not None
        torch.testing.assert_close(converted.env_quad, port_sd.env_quad, rtol=0, atol=0)
        torch.testing.assert_close(converted.monomials.inv_tf, port_sd.monomials.inv_tf, rtol=0, atol=0)
    cam = convert.camera_from_arrays(reference_camera(ref_cam))
    agree(_render_port(port_scene, cam, eps, bounces, dtype_name, scene_data=converted), want)
