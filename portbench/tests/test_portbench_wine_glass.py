"""The `wine_glass_trefoil` configuration and its cell on the CPU: the frozen
builder against the port's own scene builder, a small run that checks
correct, a run whose shadow rays are never blocked that does not, and the
reader of `shadow_live_share`."""

import json
import types

import numpy as np
import pytest

from portbench import harness, registry
from portbench.rays import frame_rays

CELL = "wine_glass_trefoil.progressive"
SMALL = {"width": 64, "height": 36, "spp": 2, "interval": 1, "max_bounces": 2, "mesh": {"segments": 60, "sides": 10}}
CHECKOUT = registry.PACKAGE + "/.."


def _spec():
    return registry.builder("wine_glass_trefoil")(registry.config("wine_glass_trefoil"))


def test_the_frozen_builder_is_the_port_s_wine_glass_trefoil_scene_and_camera():
    from rpt_tpu_torch import scenes

    spec = _spec()
    scene, camera = scenes.build_wine_glass_trefoil_scene(), scenes.wine_glass_camera()
    glass, floor = scene.objects
    assert np.array_equal(glass.shape.base.vertices, spec.meshes[0].vertices)
    assert np.array_equal(glass.shape.base.normals, spec.meshes[0].normals)
    assert np.array_equal(glass.shape.matrix, spec.objects[0].matrix)
    assert np.array_equal(floor.shape.vertices, spec.meshes[1].vertices)
    assert np.array_equal(floor.shape.normals, spec.meshes[1].normals)
    assert np.array_equal(spec.objects[1].matrix, np.eye(4))
    for obj, want in zip(scene.objects, spec.objects):
        m = obj.mat
        assert (m.color, m.index, m.roughness, m.metallic, m.emittance, m.transparent) == \
            (want.material.color, want.material.index, want.material.roughness, want.material.metallic,
             want.material.emittance, want.material.transparent)
    (light,) = scene.lights
    (want,) = spec.lights
    assert want.kind == "sphere" and np.array_equal(light.object.shape.matrix, want.matrix)
    assert (light.object.mat.color, light.object.mat.emittance) == (want.color, want.emittance)
    assert tuple(scene.environment.color) == spec.env_color and spec.hdri is None
    from rpt_tpu_torch import Camera

    port = Camera.look_at(spec.camera.eye, spec.camera.center, spec.camera.up, spec.camera.fov)
    for field in ("eye", "direction", "up", "fov"):
        assert np.array_equal(np.asarray(getattr(port, field)), np.asarray(getattr(camera, field))), field
    assert (spec.width, spec.height, spec.max_bounces, spec.spp, spec.epsilon, spec.exposure_value) == \
        (1920, 1080, 6, 20, 1e-3, 0.0)


def test_a_frame_is_14_rays_a_pixel_a_sample():
    assert frame_rays(_spec(), 20) == 14 * 1920 * 1080 * 20


def test_the_cell_runs_on_the_cpu_at_a_small_size_and_checks_correct():
    result = harness.run_cell(CELL, 2 ** 31 + 11, 0.0, False, CHECKOUT, "cpu", overrides=SMALL)
    assert result["correct"], json.dumps(result)
    assert set(result["checks"]) == {"image_off", "image_gap", "sums_off"}


def test_shadow_rays_never_blocked_read_not_correct(monkeypatch):
    import torch

    from rpt_tpu_torch import integrator

    monkeypatch.setattr(integrator, "_shadow_visible",
                        lambda scene, pos, wi, dist, t_min, found, compact: torch.ones_like(found))
    result = harness.run_cell(CELL, 2 ** 31 + 11, 0.0, False, CHECKOUT, "cpu", overrides=SMALL)
    assert not result["correct"], json.dumps(result)


def _ctx(launches):
    return types.SimpleNamespace(launches=launches)


@pytest.mark.parametrize("launches, share", [
    (None, None), ({}, None), ({"_threefry": 90}, None), ({"shadow_lanes": 0, "shadow_live_lanes": 0}, None),
    ({"shadow_lanes": 400, "shadow_live_lanes": 0}, 0.0), ({"shadow_lanes": 400, "shadow_live_lanes": 50}, 12.5),
    ({"shadow_lanes": 400, "shadow_live_lanes": 400}, 100.0)])
def test_shadow_live_share_is_the_live_lanes_over_the_lanes(launches, share):
    got = registry.reader("shadow_live_share")(_ctx(launches))
    assert got == (None if share is None else pytest.approx(share))
