"""HDRI environments in the port against the JAX package.

The quad table `from_hdri` bakes on the host equals the reference's bit for
bit (the port's 13th column is a zero pad). `get_color` and the compiled
scene's lookup match the reference to rtol/atol 2e-4 in float32 (the bar of
`tests/test_hdri.py`) and to rtol 1e-10 / atol 1e-12 in float64 (under
`jax.enable_x64`), on random, seam and pole directions, in both of the
reference's forms (the quad table, and four gathers for a map above
`_QUAD_MAX_TEXELS`, forced here by lowering the limit in both packages);
the padded table, the unpadded one and the four gathers read the same
values, bit for bit.
Renders under an HDRI go through each package's own compile and through
`convert.scene_data_from_arrays`. The compile digest hashes the map's
bytes, so two maps one texel apart get separate cached graphs. An in-place
edit of `Environment.hdri` changes the digest but reaches only the 4-gather
form, since the quad table was baked once: both packages do so.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import rpt_tpu
import rpt_tpu.environment as ref_env_mod
import rpt_tpu_torch
import rpt_tpu_torch.environment as env_mod
from rpt_tpu_torch import convert
from rpt_tpu_torch import renderer as renderer_mod
from rpt_tpu_torch.scene import _scene_digest
from rpt_tpu_torch.scenes import procedural_sky
from test_hdri import _numpy_env_lookup, _test_image
from test_torch_reference_native import reference_native
from test_torch_render import H, W, assert_images_agree, reference_camera, reference_tree, sphere_scene

reference_native()

SEED = 7
DTYPES = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64)}
# The lookup's bar against the reference and the numpy oracle: float32's is
# `tests/test_hdri.py`'s; float64's is tight enough that a lookup computed
# in float32 fails it.
LOOKUP_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "f64": dict(rtol=1e-10, atol=1e-12)}


def _dirs(n=500, seed=1):
    """Random unit directions, then the azimuth seam (the -x axis, either
    side) and both poles."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return np.concatenate([dirs, [[-1, 0, 1e-8], [-1, 0, -1e-8], [0, 1, 0], [0, -1, 0], [-1, 0, 0]]])


@pytest.fixture(params=["quad", "gather"])
def form(request, monkeypatch):
    """The lookup form: the quad table, or four gathers (both packages'
    limit lowered below every map here)."""
    if request.param == "gather":
        monkeypatch.setattr(ref_env_mod, "_QUAD_MAX_TEXELS", 0)
        monkeypatch.setattr(env_mod, "_QUAD_MAX_TEXELS", 0)
    return request.param


@pytest.mark.parametrize("image", ["random", "sky"])
def test_quad_table_matches_reference(image):
    img = _test_image(h=12, w=24, seed=3) if image == "random" else procedural_sky(16)
    want = rpt_tpu.Environment.from_hdri(img)
    got = rpt_tpu_torch.Environment.from_hdri(img)
    assert got.hdri_quad.dtype == np.float32 and got.hdri_quad.shape == (img.shape[0] * img.shape[1], 13)
    np.testing.assert_array_equal(got.hdri_quad[:, :12], want.hdri_quad)
    assert not got.hdri_quad[:, 12].any()
    np.testing.assert_array_equal(got.hdri, want.hdri)
    np.testing.assert_array_equal(env_mod.pad_quad(want.hdri_quad), got.hdri_quad)


def test_oversized_map_has_no_quad_table(monkeypatch):
    monkeypatch.setattr(env_mod, "_QUAD_MAX_TEXELS", 12 * 24 - 1)
    assert rpt_tpu_torch.Environment.from_hdri(_test_image(h=12, w=24)).hdri_quad is None
    monkeypatch.setattr(env_mod, "_QUAD_MAX_TEXELS", 12 * 24)
    assert rpt_tpu_torch.Environment.from_hdri(_test_image(h=12, w=24)).hdri_quad is not None


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_lookup_matches_reference(form, dtype_name):
    tdt, jdt = DTYPES[dtype_name]
    img = _test_image(h=12, w=24, seed=3)
    dirs = _dirs()
    with jax.enable_x64(dtype_name == "f64"):
        ref_env = rpt_tpu.Environment.from_hdri(img)
        want = np.asarray(ref_env.get_color(jnp.asarray(dirs, jdt)))
    env = rpt_tpu_torch.Environment.from_hdri(img)
    assert (env.hdri_quad is None) == (ref_env.hdri_quad is None) == (form == "gather")
    got = env.get_color(torch.as_tensor(dirs, dtype=tdt))
    assert got.dtype == tdt and want.dtype == np.dtype(jdt)
    np.testing.assert_allclose(got.numpy(), want, **LOOKUP_TOL[dtype_name])
    np.testing.assert_allclose(got.numpy(), _numpy_env_lookup(img, dirs), **LOOKUP_TOL[dtype_name])
    # The compiled scene reads its own device copies: the same values.
    scene = rpt_tpu_torch.Scene()
    scene.set_environment(env)
    sd = scene.compile(tdt, device="cpu")
    assert sd.env_hdri.dtype == torch.float32 and (sd.env_quad is None) == (form == "gather")
    assert torch.equal(sd.environment_color(torch.as_tensor(dirs, dtype=tdt)), got)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_every_layout_reads_the_same_values(dtype_name):
    """The padded quad, the reference's 12-column one and four gathers of
    the map give the same lookup, bit for bit."""
    tdt = DTYPES[dtype_name][0]
    env = rpt_tpu_torch.Environment.from_hdri(procedural_sky(16))
    color, hdri, quad = env.tensors("cpu", tdt)
    d = torch.as_tensor(_dirs(2000, seed=4), dtype=tdt)
    padded = env_mod.lookup(d, color, hdri, quad)
    assert torch.equal(padded, env_mod.lookup(d, color, hdri, quad[:, :12].contiguous()))
    assert torch.equal(padded, env_mod.lookup(d, color, hdri, None))


class _Ops(TorchDispatchMode):
    """Records the aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_solid_color_lookup_is_a_broadcast():
    """Without a map the compiled scene's lookup is one broadcast view of
    its color, as before HDRIs were ported: no kernel is added to a pass."""
    env = rpt_tpu_torch.Environment.from_color((0.1, 0.2, 0.3))
    d = torch.as_tensor(_dirs(7), dtype=torch.float32)
    got = env.get_color(d)
    assert got.shape == d.shape and torch.equal(got[3], torch.tensor([0.1, 0.2, 0.3]))
    scene = rpt_tpu_torch.Scene()
    scene.set_environment(env)
    sd = scene.compile(device="cpu")
    assert sd.env_hdri is None and sd.env_quad is None
    with _Ops() as rec:
        got = sd.environment_color(d)
    assert rec.ops == ["aten.expand.default"] and got.shape == d.shape


# ---------------------------------------------------------------------------
# Renders under an HDRI
# ---------------------------------------------------------------------------


def _hdri_sphere_scenes(img):
    """The sphere scene of `test_torch_render.py` under the map `img`, built
    with each package."""
    (ref_scene, ref_cam, eps), (port_scene, port_cam, _) = sphere_scene(rpt_tpu), sphere_scene(rpt_tpu_torch)
    # Each its own copy: `from_hdri` keeps a float32 array as given.
    ref_scene.set_environment(rpt_tpu.Environment.from_hdri(img.copy()))
    port_scene.set_environment(rpt_tpu_torch.Environment.from_hdri(img.copy()))
    return (ref_scene, ref_cam, eps), (port_scene, port_cam, eps)


def _render_ref(scene, cam, eps, bounces=1):
    rpt_tpu.renderer._MANY_CACHE = rpt_tpu.renderer.SceneCache()
    r = rpt_tpu.Renderer(scene, cam, width=W, height=H, max_bounces=bounces, num_samples=1, epsilon=eps, seed=SEED)
    return np.asarray(r.render_buffer().mean_image())


def _renderer(scene, cam, eps, bounces=1):
    return rpt_tpu_torch.Renderer(scene, cam, width=W, height=H, max_bounces=bounces, num_samples=1, epsilon=eps,
                                  seed=SEED, device="cpu")


def test_hdri_render_matches_reference(form):
    (ref_scene, ref_cam, eps), (port_scene, port_cam, _) = _hdri_sphere_scenes(procedural_sky(16))
    want = _render_ref(ref_scene, ref_cam, eps)
    got = _renderer(port_scene, port_cam, eps).render_buffer().mean_image().numpy()
    assert_images_agree(got, want)
    # The reference's compiled scene, its quad table (or its absence) carried.
    sd = convert.scene_data_from_arrays(reference_tree(ref_scene.compile()), device="cpu")
    assert (sd.env_quad is None) == (form == "gather") and sd.env_hdri.shape == (16, 32, 3)
    cam = convert.camera_from_arrays(reference_camera(ref_cam))
    assert_images_agree(_renderer(port_scene, cam, eps).render_buffer(scene_data=sd).mean_image().numpy(), want)


def test_map_reads_as_the_reference_reads_it():
    """An empty scene under a map: every camera ray misses, so the image is
    the lookup of the camera's directions (`tests/test_hdri.py`'s render)."""
    img = _test_image(h=8, w=16, seed=9)
    ref_scene, port_scene = rpt_tpu.Scene(), rpt_tpu_torch.Scene()
    ref_scene.set_environment(rpt_tpu.Environment.from_hdri(img))
    port_scene.set_environment(rpt_tpu_torch.Environment.from_hdri(img))
    ref_cam = rpt_tpu.Camera.look_at([0, 0, 5], [0, 0, 0], [0, 1, 0], math.pi / 4)
    port_cam = rpt_tpu_torch.Camera.look_at([0, 0, 5], [0, 0, 0], [0, 1, 0], math.pi / 4)
    want = _render_ref(ref_scene, ref_cam, 1e-3, bounces=0)
    got = _renderer(port_scene, port_cam, 1e-3, bounces=0).render_buffer().mean_image().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_digest_holds_every_texel():
    """Two maps one texel apart: different digests, so separate compiles
    and separate cached graphs."""
    img = procedural_sky(16)
    other = img.copy()
    other[5, 7, 1] += 0.5
    scenes = []
    for im in (img, other):
        s = rpt_tpu_torch.Scene()
        s.add(rpt_tpu_torch.Object(rpt_tpu_torch.sphere()))
        s.set_environment(rpt_tpu_torch.Environment.from_hdri(im))
        scenes.append(s)
    assert _scene_digest(scenes[0]) != _scene_digest(scenes[1])
    sds = [s.compile(device="cpu") for s in scenes]
    assert renderer_mod.scene_cache_key(sds[0]) != renderer_mod.scene_cache_key(sds[1])
    fns = [renderer_mod.make_render_many_fn(sd, 8, 6, 1) for sd in sds]
    assert fns[0] is not fns[1] and fns[0].sd is sds[0] and fns[1].sd is sds[1]
    # The solid-color digest is unchanged by the map's field being None.
    plain = rpt_tpu_torch.Scene()
    plain.set_environment(rpt_tpu_torch.Environment.from_color((0.0, 0.0, 0.0)))
    assert _scene_digest(plain) == _scene_digest(rpt_tpu_torch.Scene())


def test_in_place_edit_of_the_map_renders_as_the_reference(form, monkeypatch):
    """The reference's quirk, mirrored: editing `Environment.hdri` in place
    changes the digest, so the scene compiles anew; the quad table was
    baked by `from_hdri` and is not rebuilt, so the edit shows only in the
    4-gather form. After the edit both packages render the same image.
    (The digest does not see the quad table either, in both packages: the
    two forms of one edited map share a cache key, so the port's pass
    cache starts empty here, as `_render_ref` empties the reference's.)"""
    monkeypatch.setattr(renderer_mod, "_MANY_CACHE", renderer_mod.SceneCache())
    (ref_scene, ref_cam, eps), (port_scene, port_cam, _) = _hdri_sphere_scenes(procedural_sky(16))
    r = _renderer(port_scene, port_cam, eps)
    before = r.render_buffer().mean_image().numpy()
    sd_before = r.scene_data()
    for scene in (ref_scene, port_scene):
        scene.environment.hdri[:] = scene.environment.hdri[::-1, ::-1] * 2.0
    after = r.render_buffer().mean_image().numpy()
    assert r.scene_data() is not sd_before
    assert_images_agree(after, _render_ref(ref_scene, ref_cam, eps))
    if form == "quad":
        np.testing.assert_array_equal(after, before)
    else:
        assert not np.allclose(after, before)
