"""The port's dynamic path (`Renderer(dynamic=True)`) on the CPU.

Frames of one scene topology share one entry of `renderer._DYNAMIC_CACHE`:
a slot, whose tensors each frame's compiled tensors are copied into, and
the sample passes over it (captured once on a card; eager here, where the
slot and the refill run all the same). The mirrors of
`tests/test_dynamic.py` hold that one entry serves every frame and that a
dynamic render is the static one, here bit for bit. The port's dynamic
renders are held against `rpt_tpu`'s dynamic renders of the same scenes
and seed at the port's CPU render bar (99% of pixels to rtol 1e-3 / atol
1e-4, the mean to 1e-3; see `tests/test_torch_render.py` for why not bit
for bit).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch
import rpt_tpu_torch.scene as scene_mod
from rpt_tpu_torch import renderer as renderer_mod
from rpt_tpu_torch.scenes import build_brick_city, trefoil_mesh
from test_torch_reference_native import reference_native

reference_native()

W, H = 40, 30


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    monkeypatch.setattr(renderer_mod, "_DYNAMIC_CACHE", renderer_mod.SceneCache())
    return renderer_mod._DYNAMIC_CACHE


def frame_scene(pkg, x: float, color=0xCC3333, env=None, light=(0.0, 5.0, 2.0), extra=False):
    """`tests/test_dynamic.py`'s frame: a sphere at x over a plane under a
    point light, built with either package's API."""
    scene = pkg.Scene()
    scene.add(pkg.Object(pkg.sphere().translate([x, 0.0, 0.0])).material(pkg.Material.diffuse(pkg.hex_color(color))))
    scene.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0xAAAAAA))))
    scene.add(pkg.PointLight((30.0, 30.0, 30.0), light))
    if env is not None:
        scene.set_environment(pkg.Environment.from_color(env))
    if extra:
        scene.add(pkg.Object(pkg.sphere().scale([0.3] * 3).translate([-1.0, 0.5, 1.0])))
    return scene


def render(pkg, scene, dynamic, w=W, h=H, cam=None, spp=2, seed=3, bounces=1):
    kw = {} if pkg is rpt_tpu else {"device": "cpu"}
    r = pkg.Renderer(scene, cam, width=w, height=h, max_bounces=bounces, num_samples=spp, seed=seed,
                     dynamic=dynamic, **kw)
    return r.render_buffer()


def port_image(scene, dynamic, **kw):
    return render(rpt_tpu_torch, scene, dynamic, **kw).mean_image().numpy()


def ref_image(scene, **kw):
    return np.asarray(render(rpt_tpu, scene, True, **kw).mean_image())


def assert_images_agree(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


def slot_ptrs(cache):
    (passes,) = [fn for fn, _ in cache._entries.values()]
    return [t.data_ptr() for t in renderer_mod._tensor_leaves(passes.sd)]


# ---------------------------------------------------------------------------
# Mirrors of tests/test_dynamic.py
# ---------------------------------------------------------------------------


def test_dynamic_no_recompile_across_frames(fresh_cache):
    base = port_image(frame_scene(rpt_tpu_torch, -0.5), True)
    assert len(fresh_cache) == 1
    ptrs = slot_ptrs(fresh_cache)
    for x in (0.0, 0.5, 1.0):
        img = port_image(frame_scene(rpt_tpu_torch, x), True)
        assert np.isfinite(img).all()
        assert not np.allclose(img, base), "moving the sphere must change pixels"
    assert len(fresh_cache) == 1
    assert slot_ptrs(fresh_cache) == ptrs  # refilled in place, never swapped


def test_dynamic_matches_static_bitwise():
    a = render(rpt_tpu_torch, frame_scene(rpt_tpu_torch, 0.25), False)
    b = render(rpt_tpu_torch, frame_scene(rpt_tpu_torch, 0.25), True)
    assert torch.equal(a.sum, b.sum) and torch.equal(a.sum_sq, b.sum_sq)


# ---------------------------------------------------------------------------
# Against rpt_tpu's dynamic renders
# ---------------------------------------------------------------------------


def test_moving_sphere_frames_match_reference(fresh_cache):
    for x in (-0.5, 0.5):
        assert_images_agree(port_image(frame_scene(rpt_tpu_torch, x), True), ref_image(frame_scene(rpt_tpu, x)))
    assert len(fresh_cache) == 1


def orbit_scene(pkg, mesh_arrays, frame):
    """A trefoil over WIDE_KERNEL_MIN_TRIS rows (so the bvh8 kernels' pack)
    under a point light that circles it, a frame of `dragon_orbit`'s kind."""
    verts, norms = mesh_arrays
    theta = 2.0 * math.pi * frame / 8
    scene = pkg.Scene()
    scene.add(pkg.Object(pkg.triangle_mesh(verts, norms).scale([3.4] * 3))
              .material(pkg.Material.specular(pkg.hex_color(0xB7CA79), 0.1)))
    scene.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0xAAAAAA))))
    scene.add(pkg.AmbientLight((0.01, 0.01, 0.01)))
    scene.add(pkg.PointLight((60.0, 60.0, 60.0), (4.0 * math.sin(theta), 6.0, 4.0 * math.cos(theta))))
    return scene


def test_mesh_frames_with_a_moving_light_match_reference(fresh_cache):
    mesh = trefoil_mesh(segments=328, sides=55)  # 36,080 triangles
    arrays = (mesh.vertices, mesh.normals)
    cam = dict(eye=(-2.5, 4.0, 6.5), target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), fov=math.pi / 6)
    for frame in (0, 3):
        port_scene = orbit_scene(rpt_tpu_torch, arrays, frame)
        assert port_scene.compile(device="cpu").mesh_pack.library == "bvh8"
        got = port_image(port_scene, True, w=32, h=24, cam=rpt_tpu_torch.Camera.look_at(*cam.values()), spp=1)
        want = ref_image(orbit_scene(rpt_tpu, arrays, frame), w=32, h=24, cam=rpt_tpu.Camera.look_at(*cam.values()),
                         spp=1)
        assert_images_agree(got, want)
    assert len(fresh_cache) == 1


# ---------------------------------------------------------------------------
# The topology key, the slot and the refill
# ---------------------------------------------------------------------------


def test_a_topology_change_makes_a_second_entry(fresh_cache):
    port_image(frame_scene(rpt_tpu_torch, 0.0), True)
    scene = frame_scene(rpt_tpu_torch, 0.3, extra=True)
    dyn = render(rpt_tpu_torch, scene, True)
    assert len(fresh_cache) == 2
    static = render(rpt_tpu_torch, scene, False)
    assert torch.equal(dyn.sum, static.sum) and torch.equal(dyn.sum_sq, static.sum_sq)
    assert_images_agree(dyn.mean_image().numpy(), ref_image(frame_scene(rpt_tpu, 0.3, extra=True)))


def _packed_scene(family, monkeypatch):
    """A small compiled scene carrying `family`'s pack."""
    if family in ("bvh8", "bvh2"):
        if family == "bvh8":
            monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 256)
        scene = rpt_tpu_torch.Scene()
        scene.add(rpt_tpu_torch.Object(trefoil_mesh(segments=40, sides=8)))
    else:
        if family == "tlas2":
            monkeypatch.setattr(scene_mod, "_BVH_KERNEL", "binary")
        scene = build_brick_city(n_instances=48)
    sd = scene.compile(device="cpu")
    assert [pack.library for pack in sd.packs] == [family]
    return sd


@pytest.mark.parametrize("family, field", [("bvh8", "group_depth"), ("bvh2", "stack_depth"), ("tlas8", "group_depth"),
                                           ("tlas8", "n_tlas"), ("tlas2", "stack_depth"), ("tlas2", "n_tlas")])
def test_key_holds_the_packs_ints(family, field, monkeypatch):
    """Two scenes with the same tensor shapes and another stack depth (or
    TLAS size) have different keys: the int is a launch argument a graph
    freezes."""
    sd = _packed_scene(family, monkeypatch)
    level = "mesh_pack" if sd.mesh_pack is not None else "instance_pack"
    pack = getattr(sd, level)
    other = dataclasses.replace(sd, **{level: dataclasses.replace(pack, **{field: getattr(pack, field) + 1})})
    key = renderer_mod._topology_key
    assert key(sd, W, H, 1) != key(other, W, H, 1)
    assert key(sd, W, H, 1) == key(dataclasses.replace(sd, digest="another frame"), W, H, 1)


def test_key_ignores_values_and_holds_the_rest():
    key = renderer_mod._topology_key
    a, b = (frame_scene(rpt_tpu_torch, x).compile(device="cpu") for x in (0.0, 0.7))
    assert a.digest != b.digest and not torch.equal(a.spheres.inv_tf, b.spheres.inv_tf)
    assert key(a, W, H, 1) == key(b, W, H, 1)
    assert key(a, W, H, 1) != key(a, W, H, 2) != key(a, W + 1, H, 2)
    assert key(a, W, H, 1) != key(frame_scene(rpt_tpu_torch, 0.0, extra=True).compile(device="cpu"), W, H, 1)
    assert key(a, W, H, 1) != key(dataclasses.replace(a, env_quad=torch.zeros(1, 13)), W, H, 1)
    f64 = frame_scene(rpt_tpu_torch, 0.0).compile(torch.float64, device="cpu")
    assert key(a, W, H, 1) != key(f64, W, H, 1)


@pytest.mark.parametrize("leaf", ["sphere_transform", "material_color", "environment_color", "light_position"])
def test_every_leaf_that_changes_reaches_the_render(leaf, fresh_cache):
    """Frame 2 differs from frame 1 in one kind of leaf; through the slot
    it renders as its own static render, bit for bit, not as frame 1."""
    changed = dict(sphere_transform=dict(x=0.4), material_color=dict(color=0x33CC33),
                   environment_color=dict(env=(0.3, 0.5, 0.8)), light_position=dict(light=(2.0, 4.0, -1.0)))[leaf]
    first_kw = dict(x=0.0, env=(0.1, 0.1, 0.1))
    first = render(rpt_tpu_torch, frame_scene(rpt_tpu_torch, **first_kw), True, spp=1)
    second_scene = frame_scene(rpt_tpu_torch, **{**first_kw, **changed})
    second = render(rpt_tpu_torch, second_scene, True, spp=1)
    assert len(fresh_cache) == 1
    static = render(rpt_tpu_torch, second_scene, False, spp=1)
    assert torch.equal(second.sum, static.sum) and torch.equal(second.sum_sq, static.sum_sq)
    assert not torch.equal(second.sum, first.sum)


def test_converted_scene_data_takes_the_dynamic_path(fresh_cache):
    """`scene_data=` goes through the slot too."""
    scene = frame_scene(rpt_tpu_torch, 0.2)
    r = rpt_tpu_torch.Renderer(scene, width=W, height=H, max_bounces=1, num_samples=1, seed=3, dynamic=True,
                               device="cpu")
    sd = scene.compile(device="cpu")
    a = r.render_buffer(scene_data=sd)
    b = r.render_buffer(scene_data=frame_scene(rpt_tpu_torch, 0.2).compile(device="cpu"))
    assert len(fresh_cache) == 1 and torch.equal(a.sum, b.sum)
    passes = next(iter(fresh_cache._entries.values()))[0]
    assert passes.sd is not sd and all(
        s.data_ptr() != t.data_ptr() for s, t in zip(renderer_mod._tensor_leaves(passes.sd),
                                                     renderer_mod._tensor_leaves(sd)))


@pytest.mark.parametrize("family", ["bvh8", "bvh2", "tlas8", "tlas2"])
def test_the_slot_has_its_scenes_topology(family, monkeypatch, fresh_cache):
    """The key, the slot and the refill walk one tree: the slot a scene's
    entry makes has that scene's key, its own tensors in the same order,
    the scene's host environment and no digest."""
    sd = _packed_scene(family, monkeypatch)
    passes = renderer_mod.dynamic_render_many_fn(sd, W, H, 1)
    key = renderer_mod._topology_key
    assert key(passes.sd, W, H, 1) == key(sd, W, H, 1)
    pairs = list(zip(renderer_mod._tensor_leaves(passes.sd), renderer_mod._tensor_leaves(sd), strict=True))
    assert all(s.data_ptr() != t.data_ptr() and torch.equal(s, t) for s, t in pairs)
    assert passes.sd.environment is sd.environment and passes.sd.digest == "" != sd.digest
    assert renderer_mod.dynamic_render_many_fn(sd, W, H, 1) is passes and len(fresh_cache) == 1
