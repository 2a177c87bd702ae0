"""The reference's two heaviest bench rows, `pegasus` and `wine_glass`
(`bench.py`), through the port against the JAX package, on the CPU.

Both examples read a mesh from an asset (`examples/pegasus.py`,
`examples/wine_glass.py`); here each package builds the example's scene with
the trefoil of `examples/dragon.py` in the asset's place, placed as
`rpt_tpu_torch.scenes.PEGASUS_TREFOIL` / `WINE_GLASS_TREFOIL` say. The
trefoil is cut to 4,000 triangles, and the wide threshold of both packages
lowered below that, so the port walks it with its bvh8 walk (as the full
knot on the card) and the reference sorts its wavefronts by morton code
(its wide pack is there). Each renders 32x32, 1 spp, seed 7, at the row's
full bounce count: `pegasus` 8 (no light: environment-lit, EV -1.5),
`wine_glass` 6 (one sphere light). The images are held to the port's render
bar (`tests/test_torch_render.py`): 99% of pixels to rtol 1e-3 / atol 1e-4,
the mean to 1e-3.

A scene with no light casts no shadow ray: its render launches the closest
hit once per path vertex and the any hit never (counted through the plain
walks, which run on the CPU in the kernels' place).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu.scene as ref_scene_mod
import rpt_tpu_torch
import rpt_tpu_torch.scene as scene_mod
from rpt_tpu_torch import scenes
from rpt_tpu_torch.ops import walk
from test_torch_reference_native import reference_native

reference_native()

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)
import dragon  # noqa: E402
from _sky import procedural_sky  # noqa: E402

W = H = 32
SEED = 7
KNOT = dict(segments=100, sides=20)  # 4,000 triangles
WIDE_MIN = 2048


def reference_pegasus():
    """`examples/pegasus.py`'s `build_scene` with the trefoil for the
    pegasus, through the JAX package's API, and its camera."""
    R = rpt_tpu
    scene = R.Scene()
    scene.set_environment(R.Environment.from_hdri(procedural_sky()))
    ice = R.Material.transparent_colored(R.hex_color(0xF8F8FF), 1.31, 0.2)
    scene.add(R.Object(scenes._placed(dragon.trefoil_mesh(**KNOT), scenes.PEGASUS_TREFOIL)).material(ice))
    scene.add(R.Object(R.polygon([[2.0, -0.01, 2.0], [2.0, -0.01, -2.0], [-2.0, -0.01, -2.0], [-2.0, -0.01, 2.0]]))
              .material(R.Material.diffuse(R.hex_color(0xDDDDDD))))
    cam = R.Camera.look_at((0.0, 1.5, 3.1), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0), math.pi / 4)
    return scene, cam


def reference_wine_glass():
    """`examples/wine_glass.py`'s `build_scene` (no HDR) with the trefoil
    for the glass, through the JAX package's API, and its camera."""
    R = rpt_tpu
    scene = R.Scene()
    scene.set_environment(R.Environment.from_color((0.25, 0.25, 0.28)))
    scene.add(R.Object(scenes._placed(dragon.trefoil_mesh(**KNOT), scenes.WINE_GLASS_TREFOIL))
              .material(R.Material.clear(1.5, 0.0001)))
    scene.add(R.Object(R.polygon([[-5.0, 0.0, -5.0], [-5.0, 0.0, 5.0], [5.0, 0.0, 5.0], [5.0, 0.0, -5.0]]))
              .material(R.Material.diffuse(R.hex_color(0x6F5D48))))
    scene.add(R.ObjectLight(R.Object(R.sphere().scale([3.0] * 3).translate([11.15, 13.739, -4.9325]))
                            .material(R.Material.light(R.hex_color(0xFFFFFF), 200.0))))
    eye = np.array([5.530, 4.375, 5.384])
    cam = R.Camera.look_at(eye, eye + np.array([-0.6962, -0.3754, -0.6119]), [0.0, 1.0, 0.0], 0.6911)
    return scene, cam


# name -> (reference builder, port builder, port camera, bounces, EV)
ROWS = {
    "pegasus": (reference_pegasus, scenes.build_pegasus_trefoil_scene, scenes.pegasus_camera, 8, -1.5),
    "wine_glass": (reference_wine_glass, scenes.build_wine_glass_trefoil_scene, scenes.wine_glass_camera, 6, 0.0),
}


@pytest.fixture
def wide(monkeypatch):
    for mod in (ref_scene_mod, scene_mod):
        monkeypatch.setattr(mod, "WIDE_KERNEL_MIN_TRIS", WIDE_MIN)


def port_renderer(name):
    _, build, camera, bounces, ev = ROWS[name]
    return rpt_tpu_torch.Renderer(build(scenes.trefoil_mesh(**KNOT)), camera(), width=W, height=H,
                                  exposure_value=ev, max_bounces=bounces, seed=SEED, device="cpu")


def assert_images_agree(got, want):
    assert got.shape == want.shape == (H, W, 3)
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    print(f"pixels agreeing: {close.mean():.4f}")
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


@pytest.mark.parametrize("name", list(ROWS))
def test_row_matches_reference(name, wide):
    build_ref, _, _, bounces, ev = ROWS[name]
    ref_scene, ref_cam = build_ref()
    ref = rpt_tpu.Renderer(ref_scene, ref_cam, width=W, height=H, exposure_value=ev, max_bounces=bounces, seed=SEED)
    want = np.asarray(ref.render_buffer().mean_image())
    port = port_renderer(name)
    sd = port.scene_data()
    assert sd.mesh_pack.library == "bvh8" and sd.bvh.num_tris >= 4000
    # The sky (256x512 texels) takes the quad form of the lookup at every depth.
    assert (sd.env_quad is not None) == (name == "pegasus")
    assert ref_scene.compile().bvh8_packed is not None
    got = port.render_buffer().mean_image().numpy()
    assert got.mean() > 0.0
    assert_images_agree(got, want)


@pytest.mark.parametrize("name", list(ROWS))
def test_walks_follow_the_lights(name, wide, monkeypatch):
    """One sample launches the closest hit once per path vertex and the any
    hit once per vertex and light: never on `pegasus`, which has no light,
    7 times on `wine_glass`. The walks are counted at their dispatch
    (`ops.walk`), which runs the plain walks on the CPU."""
    calls = {"closest": 0, "occluded": 0}

    def counting(kind, fn):
        def wrapped(*args, **kw):
            calls[kind] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(walk, "closest_hit", counting("closest", walk.closest_hit))
    monkeypatch.setattr(walk, "occluded", counting("occluded", walk.occluded))
    r = port_renderer(name)
    r.width = r.height = 16
    sd = r.scene_data()
    lights = len(sd.lights)
    assert lights == (0 if name == "pegasus" else 1)
    img = r.render_buffer().mean_image()
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    vertices = r.max_bounces + 1
    assert calls == {"closest": vertices, "occluded": lights * vertices}
