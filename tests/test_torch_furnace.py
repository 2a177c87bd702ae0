"""White furnace through the port (`tests/test_furnace.py`).

A sphere under a uniform environment L, no lights, one bounce, seen head-on
through a tiny field of view: the center pixel's expected radiance is L
times the hemispherical integral of f cos, which `tests/test_furnace.py`
evaluates by f64 quadrature from the material formulas, apart from both
packages. The port renders it on the CPU at the reference's 5x5 pixels and
3000 spp and must come within the reference's 3%.
"""

import numpy as np
import pytest
import torch

from rpt_tpu_torch import Camera, Environment, Material, Object, Renderer, Scene, sphere
from test_furnace import ALBEDO, ENV_L, _quadrature_albedo


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small renders run as fast on one, and do
    not oversubscribe the cores that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mat_kind", ["diffuse", "specular"])
def test_furnace_matches_quadrature(mat_kind):
    mat = Material.diffuse(ALBEDO) if mat_kind == "diffuse" else Material.specular(ALBEDO, 0.4)
    scene = Scene()
    scene.add(Object(sphere()).material(mat))
    scene.set_environment(Environment.from_color(ENV_L))
    cam = Camera(eye=(0.0, 0.0, 40.0), direction=(0.0, 0.0, -1.0), up=(0.0, 1.0, 0.0), fov=0.004)
    r = Renderer(scene, cam, width=5, height=5, max_bounces=1, num_samples=3000, epsilon=1e-3, seed=3,
                 device="cpu")
    img = r.render_buffer().mean_image().numpy().astype(np.float64)
    rendered = img[2, 2]  # center pixel: wo = n to within ~fov
    expect = np.asarray(ENV_L, np.float64) * _quadrature_albedo(mat.color, mat.roughness, mat.index)
    rel = np.abs(rendered - expect) / expect
    assert rel.max() < 0.03, (rendered, expect, rel)
