"""Whole renders of the port against the JAX package, same scene and seed.

The port's threefry is bit-exact with `jax.random`, so both packages draw the
same numbers for every pixel, and their images compare pixel by pixel. They
are not bit-equal: XLA on the CPU contracts multiply-adds into FMAs where
torch does not, so last-bit differences in f32 can flip a grazing hit, a
shadow ray's visibility or a lobe choice. A pixel on such a path takes a
different random walk from there on. The render tolerance (rtol 1e-3, atol
1e-4 on at least 99% of pixels, the image mean to 1e-3 relative) leaves room
for those few pixels and no more.

`dragon` (a baked mesh) and the `lego` brick city (instanced meshes, 46
materials) run twice each: once through each package's own
`Scene.compile`, and once with the JAX package's compiled scene, BVH or
two-level tree carried into the port by `convert.scene_data_from_arrays`.
Both run again under each kernel choice (`RPT_BVH_KERNEL` binary, a lowered
`WIDE_KERNEL_MIN_TRIS`) and through the wide packs' fallback to the binary
kernels; the toy brick plane of `examples/lego.py` runs through the OBJ+MTL
loader of each package.
"""

import dataclasses
import math
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
from rpt_tpu.renderer import pixel_ndc_tiled as ref_pixel_ndc_tiled
from rpt_tpu_torch import convert
from rpt_tpu_torch.ops import bvh8, tlas8
from rpt_tpu_torch.scenes import (
    build_brick_city,
    build_dragon_scene,
    build_toy_plane_scene,
    dragon_camera,
    lego_camera,
    toy_plane_camera,
)
from test_torch_reference_native import reference_native

reference_native()

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
W, H = 64, 48
SEED = 7


# ---------------------------------------------------------------------------
# Scenes, built with either package's API (the two are the same)
# ---------------------------------------------------------------------------


def sphere_scene(pkg):
    scene = pkg.Scene()
    scene.add(pkg.Object(pkg.sphere()))
    scene.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0xAAAAAA))))
    scene.add(pkg.ObjectLight(pkg.Object(pkg.sphere().scale([2.0, 2.0, 2.0]).translate([0.0, 12.0, 0.0]))
                              .material(pkg.Material.light(pkg.hex_color(0xFFFFFF), 40.0))))
    cam = pkg.Camera.look_at([-2.5, 4.0, 6.5], [0.0, -0.25, 0.0], [0.0, 1.0, 0.0], math.pi / 4)
    return scene, cam, 1e-3


def cornell_scene(pkg):
    """examples/cornell.py: walls and light are polygons (small triangle
    meshes), the two boxes are transformed cubes."""
    two_pi = 6.283185307179586
    scene = pkg.Scene()
    white = pkg.Material.diffuse(pkg.hex_color(0xAAAAAA))
    red = pkg.Material.diffuse(pkg.hex_color(0xBC0000))
    green = pkg.Material.diffuse(pkg.hex_color(0x00BC00))
    light = pkg.Material.light(pkg.hex_color(0xFFFEFA), 100.0)
    poly = pkg.polygon
    scene.add(pkg.Object(poly([[0, 0, 0], [0, 0, 559.2], [556, 0, 559.2], [556, 0, 0]])).material(white))
    scene.add(pkg.Object(poly([[0, 548.9, 0], [556, 548.9, 0], [556, 548.9, 559.2], [0, 548.9, 559.2]]))
              .material(white))
    scene.add(pkg.Object(poly([[0, 0, 559.2], [0, 548.9, 559.2], [556, 548.9, 559.2], [556, 0, 559.2]]))
              .material(white))
    scene.add(pkg.Object(poly([[556, 0, 0], [556, 0, 559.2], [556, 548.9, 559.2], [556, 548.9, 0]]))
              .material(red))
    scene.add(pkg.Object(poly([[0, 0, 0], [0, 548.9, 0], [0, 548.9, 559.2], [0, 0, 559.2]])).material(green))
    scene.add(pkg.Object(pkg.cube().scale([165.0, 330.0, 165.0]).rotate_y(two_pi * (-253.0 / 360.0))
                         .translate([368.0, 165.0, 351.0])).material(white))
    scene.add(pkg.Object(pkg.cube().scale([165.0, 165.0, 165.0]).rotate_y(two_pi * (-197.0 / 360.0))
                         .translate([185.0, 82.5, 169.0])).material(white))
    scene.add(pkg.ObjectLight(pkg.Object(poly([[343.0, 548.8, 227.0], [343.0, 548.8, 332.0],
                                               [213.0, 548.8, 332.0], [213.0, 548.8, 227.0]]))
                              .material(light)))
    cam = pkg.Camera(eye=(278.0, 273.0, -800.0), direction=(0.0, 0.0, 1.0), fov=0.686)
    return scene, cam, 0.05


def dragon_scenes():
    """The `dragon` workload with a ~5k-triangle trefoil: the JAX example's
    own builder, and the port's copy of it."""
    sys.path.insert(0, EXAMPLES)
    import dragon

    ref = dragon.build_scene(target_tris=5000)  # 125 segments x 20 sides
    cam = rpt_tpu.Camera.look_at((-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)
    return (ref, cam, 1e-3), (build_dragon_scene(segments=125, sides=20), dragon_camera(), 1e-3)


# ---------------------------------------------------------------------------
# The JAX package's compiled state as plain arrays (what convert.py takes)
# ---------------------------------------------------------------------------


def _fields(obj):
    if obj is None:
        return None
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if not f.metadata.get("static")}


def reference_tree(sd) -> dict:
    """Walk the JAX package's SceneData into the nested dict of numpy arrays
    that `convert.scene_data_from_arrays` takes."""
    return dict(
        materials=_fields(sd.materials),
        spheres=_fields(sd.spheres),
        cubes=_fields(sd.cubes),
        planes=_fields(sd.planes),
        monomials=_fields(sd.monomials),
        triangles=_fields(sd.triangles),
        bvh=_fields(sd.bvh),
        instanced=_fields(sd.instanced),
        lights=[dict(type=type(l).__name__, **_fields(l)) for l in sd.lights],
        environment=dict(color=np.asarray(sd.environment.color), hdri=sd.environment.hdri,
                         hdri_quad=sd.environment.hdri_quad),
        digest=sd.digest,
    )


def reference_camera(cam) -> dict:
    return {f.name: np.asarray(getattr(cam, f.name)) for f in dataclasses.fields(cam)}


# ---------------------------------------------------------------------------
# Rendering both packages
# ---------------------------------------------------------------------------


def render_ref(scene, cam, eps, spp):
    r = rpt_tpu.Renderer(scene, cam, width=W, height=H, max_bounces=2, num_samples=spp, epsilon=eps, seed=SEED)
    return np.asarray(r.render_buffer().mean_image())


def render_port(scene, cam, eps, spp, scene_data=None):
    r = rpt_tpu_torch.Renderer(scene, cam, width=W, height=H, max_bounces=2, num_samples=spp, epsilon=eps,
                               seed=SEED, device="cpu")
    return r.render_buffer(scene_data=scene_data).mean_image().numpy()


def assert_images_agree(got, want):
    assert got.shape == want.shape == (H, W, 3)
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


def depth0_hits(ref_scene, ref_cam, port_sd, eps):
    """Depth-0 hits of both packages on the reference's own camera rays of
    sample 0 (the same inputs on both sides)."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    xg, yg, dim, _ = ref_pixel_ndc_tiled(W, H)
    k_jit, k_cam, _ = jax.random.split(key, 3)
    jitter = jax.random.uniform(k_jit, (2, xg.shape[0]), jnp.float32, -1.0 / dim, 1.0 / dim)
    o, d = ref_cam.cast_rays(xg + jitter[0], yg + jitter[1], k_cam)
    ref = ref_scene.compile().intersect(o, d, jnp.float32(eps))
    got = port_sd.intersect(torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d)), eps)
    return ref, got


def assert_depth0_agrees(ref, got):
    """Hit mask and material exact; `t` to 2e-5 on all but 0.1% of the hits.
    The exception is a ray through a shared edge of the closed trefoil: in
    one package's f32 rounding both triangles' barycentric tests fail and
    the ray hits the far side of the tube instead (one ray of 3072 here)."""
    hit_ref = np.isfinite(np.asarray(ref.t))
    hit_got = np.isfinite(got.t.numpy())
    assert hit_ref.any()
    np.testing.assert_array_equal(hit_got, hit_ref)
    np.testing.assert_array_equal(got.mat_id.numpy()[hit_ref], np.asarray(ref.mat_id)[hit_ref])
    t_ok = np.isclose(got.t.numpy()[hit_ref], np.asarray(ref.t)[hit_ref], rtol=2e-5, atol=2e-5)
    assert t_ok.mean() >= 0.999, f"t agrees on only {t_ok.mean():.5f} of the hits"


@pytest.mark.parametrize("builder", [sphere_scene, cornell_scene], ids=["sphere", "cornell"])
def test_analytic_scene_matches_reference(builder):
    ref_scene, ref_cam, eps = builder(rpt_tpu)
    port_scene, port_cam, _ = builder(rpt_tpu_torch)
    ref, got = depth0_hits(ref_scene, ref_cam, port_scene.compile(device="cpu"), eps)
    assert_depth0_agrees(ref, got)
    assert_images_agree(render_port(port_scene, port_cam, eps, 2), render_ref(ref_scene, ref_cam, eps, 2))


def test_dragon_own_compile_matches_reference():
    (ref_scene, ref_cam, eps), (port_scene, port_cam, _) = dragon_scenes()
    port_sd = port_scene.compile(device="cpu")
    assert port_sd.bvh is not None and port_sd.bvh.num_tris >= 5000
    ref, got = depth0_hits(ref_scene, ref_cam, port_sd, eps)
    assert_depth0_agrees(ref, got)
    assert_images_agree(render_port(port_scene, port_cam, eps, 1), render_ref(ref_scene, ref_cam, eps, 1))


def test_dragon_converted_scene_matches_reference():
    (ref_scene, ref_cam, eps), (port_scene, _, _) = dragon_scenes()
    ref_sd = ref_scene.compile()
    port_sd = convert.scene_data_from_arrays(reference_tree(ref_sd), device="cpu")
    # The carried-over BVH is the reference's, array for array.
    for f in dataclasses.fields(ref_sd.bvh):
        np.testing.assert_array_equal(getattr(port_sd.bvh, f.name).numpy(), np.asarray(getattr(ref_sd.bvh, f.name)))
    cam = convert.camera_from_arrays(reference_camera(ref_cam))
    ref, got = depth0_hits(ref_scene, ref_cam, port_sd, eps)
    assert_depth0_agrees(ref, got)
    got_img = render_port(port_scene, cam, eps, 1, scene_data=port_sd)
    assert_images_agree(got_img, render_ref(ref_scene, ref_cam, eps, 1))


def brick_city_scenes():
    """The `lego` workload's brick city cut to two towers of 48 instances,
    the fewest that use more than 32 materials (39): the JAX example's own
    builder, and the port's copy of it."""
    sys.path.insert(0, EXAMPLES)
    import lego

    ref = lego.build_brick_city(n_instances=96)
    cam = rpt_tpu.Camera.look_at((18.0, 14.0, 26.0), (0.0, 4.0, 0.0), (0.0, 1.0, 0.0), math.pi / 5)
    return (ref, cam, 1e-3), (build_brick_city(n_instances=96), lego_camera(), 1e-3)


@pytest.fixture(scope="module")
def brick_city_ref():
    """The JAX package's scene, compiled scene and 1-spp image, made once."""
    (ref_scene, ref_cam, eps), _ = brick_city_scenes()
    return dict(scene=ref_scene, cam=ref_cam, eps=eps, sd=ref_scene.compile(),
                img=render_ref(ref_scene, ref_cam, eps, 1))


def assert_instances_seen(port_sd, ref):
    """Some camera rays hit a brick: the instanced walk is on the path."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    xg, yg, _, _ = ref_pixel_ndc_tiled(W, H)
    o, d = ref["cam"].cast_rays(xg, yg, key)
    hit = tlas8.tlas8_closest_hit(port_sd.instanced, port_sd.instance_pack, torch.as_tensor(np.array(o)),
                                  torch.as_tensor(np.array(d)), ref["eps"])
    assert torch.isfinite(hit.t).sum() > 100


def test_brick_city_own_compile_matches_reference(brick_city_ref):
    ref = brick_city_ref
    _, (port_scene, port_cam, eps) = brick_city_scenes()
    port_sd = port_scene.compile(device="cpu")
    assert port_sd.instanced is not None and port_sd.bvh is None
    assert port_sd.materials.color.shape[0] > 32  # past the reference's one-hot material gather
    assert_instances_seen(port_sd, ref)
    ref_hit, got = depth0_hits(ref["scene"], ref["cam"], port_sd, eps)
    assert_depth0_agrees(ref_hit, got)
    assert_images_agree(render_port(port_scene, port_cam, eps, 1), ref["img"])


def test_brick_city_converted_scene_matches_reference(brick_city_ref):
    ref = brick_city_ref
    _, (port_scene, _, eps) = brick_city_scenes()
    port_sd = convert.scene_data_from_arrays(reference_tree(ref["sd"]), device="cpu")
    # The carried-over two-level tree is the reference's, array for array.
    for f in dataclasses.fields(ref["sd"].instanced):
        np.testing.assert_array_equal(getattr(port_sd.instanced, f.name).numpy(),
                                      np.asarray(getattr(ref["sd"].instanced, f.name)))
    cam = convert.camera_from_arrays(reference_camera(ref["cam"]))
    ref_hit, got = depth0_hits(ref["scene"], ref["cam"], port_sd, eps)
    assert_depth0_agrees(ref_hit, got)
    assert_images_agree(render_port(port_scene, cam, eps, 1, scene_data=port_sd), ref["img"])


# ---------------------------------------------------------------------------
# The kernel choice, its fallback, and the OBJ+MTL toy plane
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dragon_ref():
    """The JAX package's 5k dragon, compiled scene and 1-spp image, made once.
    Its own RPT_BVH_KERNEL switch picks among TPU kernels only: on the CPU it
    always walks its XLA loop, so one reference image serves every choice."""
    (ref_scene, ref_cam, eps), _ = dragon_scenes()
    return dict(scene=ref_scene, cam=ref_cam, eps=eps, img=render_ref(ref_scene, ref_cam, eps, 1))


def assert_port_dragon_matches(ref, family):
    _, (port_scene, port_cam, eps) = dragon_scenes()
    port_sd = port_scene.compile(device="cpu")
    assert [pack.library for pack in port_sd.packs] == [family] and port_sd.mesh_pack is not None
    ref_hit, got = depth0_hits(ref["scene"], ref["cam"], port_sd, eps)
    assert_depth0_agrees(ref_hit, got)
    assert_images_agree(render_port(port_scene, port_cam, eps, 1), ref["img"])


@pytest.mark.parametrize("choice", ["binary", "wide"])
def test_dragon_kernel_choice_matches_reference(dragon_ref, choice, monkeypatch):
    """RPT_BVH_KERNEL=binary takes the binary kernels; under "wide" a BVH
    over a lowered WIDE_KERNEL_MIN_TRIS takes the wide ones. The 5k dragon
    (5,456 rows) is under the default 16,384, so "wide" alone would also
    take the binary kernels."""
    if choice == "binary":
        monkeypatch.setattr(scene_mod, "_BVH_KERNEL", "binary")
    else:
        monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 4096)
    assert_port_dragon_matches(dragon_ref, "bvh8" if choice == "wide" else "bvh2")


def test_dragon_wide_pack_refusal_falls_back_to_binary(dragon_ref, monkeypatch):
    """A wide pack that refuses the tree (its stack need over the cap)
    warns and leaves the BVH to the binary kernels, which render the same
    image."""
    monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 4096)
    monkeypatch.setattr(bvh8, "STACK_CAP", 2)
    with pytest.warns(UserWarning, match="falling back to the binary BVH kernels"):
        assert_port_dragon_matches(dragon_ref, "bvh2")


def assert_port_city_matches(ref, family):
    _, (port_scene, port_cam, eps) = brick_city_scenes()
    port_sd = port_scene.compile(device="cpu")
    assert [pack.library for pack in port_sd.packs] == [family] and port_sd.instance_pack is not None
    ref_hit, got = depth0_hits(ref["scene"], ref["cam"], port_sd, eps)
    assert_depth0_agrees(ref_hit, got)
    assert_images_agree(render_port(port_scene, port_cam, eps, 1), ref["img"])


def test_brick_city_binary_choice_matches_reference(brick_city_ref, monkeypatch):
    monkeypatch.setattr(scene_mod, "_BVH_KERNEL", "binary")
    assert_port_city_matches(brick_city_ref, "tlas2")


def test_brick_city_wide_pack_refusal_falls_back_to_binary(brick_city_ref, monkeypatch):
    monkeypatch.setattr(tlas8, "STACK_CAP", 4)
    with pytest.warns(UserWarning, match="falling back to the binary two-level kernels"):
        assert_port_city_matches(brick_city_ref, "tlas2")


def toy_plane_scenes():
    """The toy brick plane of `examples/lego.py` (no `--zip`): the JAX
    example's own builder, and the port's copy, each through its package's
    OBJ+MTL loader."""
    sys.path.insert(0, EXAMPLES)
    import lego

    ref = lego.build_scene()
    cam = rpt_tpu.Camera.look_at((2.5, 2.0, 1.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)
    return (ref, cam, 1e-3), (build_toy_plane_scene(), toy_plane_camera(), 1e-3)


def test_toy_plane_matches_reference():
    (ref_scene, ref_cam, eps), (port_scene, port_cam, _) = toy_plane_scenes()
    port_sd = port_scene.compile(device="cpu")
    # 108 triangles in four usemtl runs, baked into one 160-row BVH: the
    # binary kernels, as in the reference.
    assert port_sd.mesh_pack.library == "bvh2" and port_sd.bvh.num_tris == 160
    assert port_sd.materials.color.shape[0] == 4 and float(port_sd.materials.transparent.max()) == 1.0
    ref_hit, got = depth0_hits(ref_scene, ref_cam, port_sd, eps)
    assert_depth0_agrees(ref_hit, got)
    assert_images_agree(render_port(port_scene, port_cam, eps, 2), render_ref(ref_scene, ref_cam, eps, 2))


def test_buffer_statistics_match_reference():
    frames = np.random.default_rng(4).uniform(0.0, 2.0, (3, H, W, 3)).astype(np.float32)
    ref, port = rpt_tpu.Buffer.new(W, H), rpt_tpu_torch.Buffer.new(W, H, device="cpu")
    for f in frames:
        ref, port = ref.add_samples(jnp.asarray(f)), port.add_samples(torch.as_tensor(f))
    ref, port = ref.merge(ref), port.merge(port)
    assert port.count == int(ref.count) == 6
    np.testing.assert_allclose(float(port.variance()), float(ref.variance()), rtol=1e-5)
    for filt in (0, 1, 2):
        want = np.asarray(ref.mean_image(rpt_tpu.Filter.box(filt)))
        np.testing.assert_allclose(port.mean_image(rpt_tpu_torch.Filter.box(filt)).numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port.image(), ref.image())


# ---------------------------------------------------------------------------
# The sample pass over tensor keys (the pass a CUDA graph captures), run
# eagerly on the CPU
# ---------------------------------------------------------------------------


def host_key_render(sd, cam, eps, spp, start=0):
    """The render as the port made it with host keys: sample i keyed by
    fold_in(PRNGKey(SEED), start + i) on the host, frames summed in tile order."""
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.renderer import pixel_ndc_tiled, render_pass_tiled

    ndc = pixel_ndc_tiled(W, H, "cpu")
    s = torch.zeros((W * H, 3))
    ss = torch.zeros(W * H)
    for i in range(spp):
        key = rnd.fold_in(rnd.PRNGKey(SEED), start + i)
        frame = render_pass_tiled(sd, cam, key, ndc, 2, float(np.float32(eps)), 1.0)
        s = s + frame
        ss = ss + torch.sum(frame * frame, dim=-1)
    inv = ndc[3]
    return s[inv].reshape(H, W, 3), ss[inv].reshape(H, W)


def port_renderer(scene, cam, eps, spp):
    return rpt_tpu_torch.Renderer(scene, cam, width=W, height=H, max_bounces=2, num_samples=spp, epsilon=eps,
                                  seed=SEED, device="cpu")


@pytest.mark.parametrize("make_scene", [sphere_scene, cornell_scene], ids=["sphere", "cornell"])
def test_tensor_key_pass_matches_host_keys_and_reference(make_scene):
    """The pass keyed on the device (fold_in of the base key and a device
    counter) renders what the host-keyed pass rendered, bit for bit, and
    what the JAX package renders, to the render tolerance."""
    ref_scene, ref_cam, eps = make_scene(rpt_tpu)
    port_scene, port_cam, _ = make_scene(rpt_tpu_torch)
    r = port_renderer(port_scene, port_cam, eps, 2)
    buf = r.render_buffer()
    s, ss = host_key_render(r.scene_data(), port_cam, eps, 2)
    assert torch.equal(buf.sum, s) and torch.equal(buf.sum_sq, ss)
    assert_images_agree(buf.mean_image().numpy(), render_ref(ref_scene, ref_cam, eps, 2))


def test_sample_into_in_chunks_equals_one_call():
    scene, cam, eps = sphere_scene(rpt_tpu_torch)
    r = port_renderer(scene, cam, eps, 3)
    whole = r.render_buffer()
    buf = rpt_tpu_torch.Buffer.new(W, H, device="cpu")
    for start, n in ((0, 1), (1, 2)):
        buf = r.sample_into(buf, n, start_iter=start)
    assert buf.count == whole.count == 3
    assert torch.equal(buf.sum, whole.sum) and torch.equal(buf.sum_sq, whole.sum_sq)
    # Samples 1-2 alone are the host-keyed render from sample 1.
    tail = r.sample_into(rpt_tpu_torch.Buffer.new(W, H, device="cpu"), 2, start_iter=1)
    s, ss = host_key_render(r.scene_data(), cam, eps, 2, start=1)
    assert torch.equal(tail.sum, s) and torch.equal(tail.sum_sq, ss)


def test_make_render_many_fn_and_render_pass_equal_sample_into():
    from rpt_tpu_torch import random as rnd
    from rpt_tpu_torch.renderer import (
        SceneCache, _MANY_CACHE, make_render_fn, make_render_many_fn, render_pass, scene_cache_key,
    )

    scene, cam, eps = cornell_scene(rpt_tpu_torch)
    r = port_renderer(scene, cam, eps, 2)
    sd, t_min, ev_scale = r._pass_args()
    fn = make_render_many_fn(sd, W, H, 2)
    # Keyed by scene, size, bounces and wavefront order (masked: no wide pack).
    assert make_render_many_fn(sd, W, H, 2) is fn and _MANY_CACHE.get((scene_cache_key(sd), W, H, 2, False)) is fn
    s, ss = fn(cam, rnd.PRNGKey(SEED), 0, 2, t_min, ev_scale)
    buf = r.render_buffer()
    assert torch.equal(s, buf.sum) and torch.equal(ss, buf.sum_sq)
    # One pass keyed by the key itself: sample 0 of the stream.
    frame = render_pass(sd, cam, rnd.fold_in(rnd.PRNGKey(SEED), 0), W, H, 2, t_min, ev_scale)
    one = r.sample_into(rpt_tpu_torch.Buffer.new(W, H, device="cpu"), 1)
    assert torch.equal(frame, one.sum)
    assert make_render_fn(sd, W, H, 2) is make_render_fn(sd, W, H, 2)
    # The cache key names the packs: the same scene under another kernel
    # choice is another entry; the cache evicts the oldest entry at its cap.
    assert scene_cache_key(sd).startswith(sd.digest)
    cache = SceneCache(cap=2)
    for k in "abc":
        cache.put(k, k.upper(), sd)
    assert cache.get("a") is None and cache.get("c") == "C"


def test_buffer_new_resolves_its_device(monkeypatch):
    """Without a card, Buffer.new raises unless asked for the CPU, as every
    entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rpt_tpu_torch.Buffer.new(W, H)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rpt_tpu_torch.Buffer.new(W, H, device=None)
    assert rpt_tpu_torch.Buffer.new(W, H, device="cpu").sum.device.type == "cpu"


def test_environment_color_edited_in_place_renders_anew():
    """Editing the environment's color in place recompiles the scene (the
    color is in its digest), and the next render, through the cached pass,
    draws the new background: the same as a scene built with that color."""
    scene, cam, eps = sphere_scene(rpt_tpu_torch)
    r = port_renderer(scene, cam, eps, 1)
    black = r.render_buffer()
    before = r.scene_data()
    scene.environment.color[:] = (0.25, 0.5, 0.75)
    edited = r.render_buffer()
    # The earlier compile keeps its own copy of the color.
    assert r.scene_data() is not before and not bool(before.env_color.any())
    fresh_scene, _, _ = sphere_scene(rpt_tpu_torch)
    fresh_scene.set_environment(rpt_tpu_torch.Environment.from_color((0.25, 0.5, 0.75)))
    want = port_renderer(fresh_scene, cam, eps, 1).render_buffer()
    assert not torch.equal(edited.sum, black.sum)
    assert torch.equal(edited.sum, want.sum) and torch.equal(edited.sum_sq, want.sum_sq)


@pytest.mark.parametrize("target", [2000, 871_000])
def test_dragon_target_tris_maps_as_the_reference(target):
    """`build_dragon_scene(target_tris=...)` sizes the knot as
    `examples/dragon.py` does: at 2,000 the same mesh, vertex for vertex,
    and the same transform; at 871,000 (`dragon871k`) 1,619 segments x 269
    sides, 871,022 triangles (the mesh is not built here)."""
    from rpt_tpu_torch.scenes import dragon_knot_size

    segments, sides = dragon_knot_size(target)
    assert 2 * segments * sides >= target
    if target == 871_000:
        assert (segments, sides, 2 * segments * sides) == (1619, 269, 871_022)
        return
    sys.path.insert(0, EXAMPLES)
    import dragon

    ref = dragon.build_scene(None, target_tris=target).objects[0].shape
    got = build_dragon_scene(target_tris=target).objects[0].shape
    assert got.base.num_triangles == ref.base.num_triangles == 2 * segments * sides
    np.testing.assert_array_equal(np.asarray(got.base.vertices), np.asarray(ref.base.vertices))
    np.testing.assert_array_equal(np.asarray(got.base.normals), np.asarray(ref.base.normals))
    np.testing.assert_array_equal(got.matrix, ref.matrix)
