"""The port's `profiling.py` against the JAX package's: the ray accounting,
the per-depth wavefront occupancy of one pass, and the throughput counters
(on the CPU here: their keys and their ray count, not their speed)."""

import math
import os
import sys

import numpy as np
import pytest

import rpt_tpu
import rpt_tpu.profiling as ref_prof
import rpt_tpu_torch
from rpt_tpu_torch import profiling
from rpt_tpu_torch.scenes import build_cornell_scene, build_dragon_scene, build_toy_plane_scene
from test_torch_reference_native import reference_native

reference_native()

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _reference_scenes():
    sys.path.insert(0, EXAMPLES)
    import cornell
    import dragon
    import lego

    return {"cornell": cornell.build_scene(), "dragon": dragon.build_scene(target_tris=5000),
            "lego_toy": lego.build_scene()}


PORT_SCENES = {"cornell": build_cornell_scene, "dragon": lambda: build_dragon_scene(segments=125, sides=20),
               "lego_toy": build_toy_plane_scene}


@pytest.mark.parametrize("name", sorted(PORT_SCENES))
def test_rays_per_sample_matches_reference(name):
    ref_sd = _reference_scenes()[name].compile()
    sd = PORT_SCENES[name]().compile(device="cpu")
    for bounces in (0, 2, 5):
        assert profiling.rays_per_sample(sd, bounces) == ref_prof.rays_per_sample(ref_sd, bounces)
    assert profiling.rays_per_sample(sd, 2) == {"cornell": 6, "dragon": 9, "lego_toy": 6}[name]


def _sphere_scene(pkg):
    scene = pkg.Scene()
    scene.add(pkg.Object(pkg.sphere()).material(pkg.Material.specular(pkg.hex_color(0xB7410E), 0.2)))
    scene.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0x777777))))
    scene.add(pkg.ObjectLight(pkg.Object(pkg.sphere().scale([2.0, 2.0, 2.0]).translate([0.0, 12.0, 0.0]))
                              .material(pkg.Material.light(pkg.hex_color(0xFFFFFF), 40.0))))
    cam = pkg.Camera.look_at([-2.5, 4.0, 6.5], [0.0, -0.25, 0.0], [0.0, 1.0, 0.0], math.pi / 4)
    return scene, cam


def test_depth_stats_match_reference():
    """32x24 pixels, 3 bounces: the same hits at every depth, so the same
    f32 shares."""
    ref = ref_prof.depth_stats(rpt_tpu.Renderer(*_sphere_scene(rpt_tpu), width=32, height=24, max_bounces=3,
                                                seed=4))
    scene, cam = _sphere_scene(rpt_tpu_torch)
    got = profiling.depth_stats(rpt_tpu_torch.Renderer(scene, cam, width=32, height=24, max_bounces=3, seed=4,
                                                       device="cpu"))
    assert got["found_frac"].shape == (4,) and got["cont_frac"].shape == (3,)
    for k in ("found_frac", "cont_frac"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=0, atol=1e-6)
    assert np.all(np.diff(got["cont_frac"]) <= 1e-6) and 0.0 < got["cont_frac"][-1] < got["found_frac"][0]


def test_measure_rays_per_sec_counts_as_the_reference():
    scene, cam = _sphere_scene(rpt_tpu_torch)
    r = rpt_tpu_torch.Renderer(scene, cam, width=24, height=16, max_bounces=2, device="cpu")
    meter = profiling.measure_rays_per_sec(r, warmup=1, passes=2)
    assert set(meter) == {"rays_per_sec", "samples_per_sec", "seconds", "rays"}
    assert meter["rays"] == 24 * 16 * profiling.rays_per_sample(r.scene_data(), 2) * 2 == 24 * 16 * 6 * 2
    assert meter["rays_per_sec"] > 0 and meter["seconds"] > 0


def test_device_trace_writes_a_trace(tmp_path):
    scene, cam = _sphere_scene(rpt_tpu_torch)
    r = rpt_tpu_torch.Renderer(scene, cam, width=16, height=8, max_bounces=1, device="cpu")
    with profiling.device_trace(str(tmp_path)):
        r.render_buffer()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json") or f.endswith(".json.gz")]
    assert traces
