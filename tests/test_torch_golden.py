"""Golden parity of the port against the independent f64 oracle.

`tests/goldens/*.npz` hold block means of the sphere, cornell and glass
scenes rendered at 512 spp by `tools/ref_renderer.py`, an implementation of
the reference estimator written apart from both packages. Here the same
scenes render through `rpt_tpu_torch` on the CPU at 48 spp and are held to
`tests/test_golden.py`'s `test_golden_fast_global_mean` bars, unchanged: the
global mean within 2% and the mean relative 8x8-block difference under 5%.
(The teapot golden needs an asset this repository does not hold.)
"""

import math
import os

import numpy as np
import pytest
import torch

from rpt_tpu_torch import (
    Camera, Environment, Material, Object, ObjectLight, Renderer, Scene, hex_color, plane, sphere,
)
from rpt_tpu_torch.scenes import build_cornell_scene, cornell_camera, CORNELL_EPSILON

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
SPP = 48


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small renders run as fast on one, and do
    not oversubscribe the cores that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_means(img, b=8):
    h, w, _ = img.shape
    return img[: h // b * b, : w // b * b].reshape(h // b, b, w // b, b, 3).mean((1, 3))


def _sphere_scene():
    """`examples/sphere.py`: a default-material sphere on a gray floor under
    a sphere light."""
    scene = Scene()
    scene.add(Object(sphere()))
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.diffuse(hex_color(0xAAAAAA))))
    scene.add(ObjectLight(Object(sphere().scale([2.0, 2.0, 2.0]).translate([0.0, 12.0, 0.0]))
                          .material(Material.light(hex_color(0xFFFFFF), 40.0))))
    cam = Camera.look_at([-2.5, 4.0, 6.5], [0.0, -0.25, 0.0], [0.0, 1.0, 0.0], math.pi / 4)
    return scene, cam, 1e-3


def _glass_scene():
    """`tests/test_golden.py`'s transmission golden: a clear sphere, a red
    ball, a floor, a sphere light and a colored environment."""
    scene = Scene()
    scene.add(Object(sphere()).material(Material.clear(1.5, 0.0001)))
    scene.add(Object(sphere().scale([0.4] * 3).translate([-2.0, -0.6, -1.5]))
              .material(Material.diffuse(hex_color(0xBC0000))))
    scene.add(Object(plane([0.0, 1.0, 0.0], -1.0)).material(Material.diffuse(hex_color(0xAAAAAA))))
    scene.add(ObjectLight(Object(sphere().scale([2.0] * 3).translate([4.0, 10.0, 4.0]))
                          .material(Material.light(hex_color(0xFFFFFF), 50.0))))
    scene.set_environment(Environment.from_color((0.1, 0.12, 0.15)))
    cam = Camera.look_at([0.0, 1.2, 5.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], math.pi / 5)
    return scene, cam, 1e-3


SCENES = {
    "sphere": _sphere_scene,
    "cornell": lambda: (build_cornell_scene(), cornell_camera(), CORNELL_EPSILON),
    "glass": _glass_scene,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_golden_fast_global_mean(name):
    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    scene, cam, eps = SCENES[name]()
    r = Renderer(scene, cam, width=int(g["width"]), height=int(g["height"]), max_bounces=int(g["bounces"]),
                 num_samples=SPP, epsilon=eps, seed=7, device="cpu")
    img = r.render_buffer().mean_image().numpy()
    assert np.isfinite(img).all()
    gm = float(g["mean"].mean())
    assert abs(img.mean() - gm) < 0.02 * max(gm, 0.05)
    ob = _block_means(img)
    gb = g["blocks"]
    rel = np.abs(ob - gb) / np.maximum(np.abs(gb), 0.05)
    assert rel.mean() < 0.05
