"""The shadow wavefront's lane counts, on the CPU.

`integrator._shadow_visible` adds, on the device, the lanes it hands to each
any-hit query (`shadow_lanes`) and the live ones among them
(`shadow_live_lanes`) to the device's count table (`kernels.add_count`),
which `kernels.launch_counts()` returns beside the kernels' launch counts.
The counts equal what an eager pass hands the walks, in every wavefront
order; a scene with no shadow-casting light counts nothing; no value of a
render changes. (On the card, `tests/test_torch_cuda.py` holds graph
replays to the same counts.)
"""

import pytest
import torch

from rpt_tpu_torch import Renderer, integrator, kernels, scenes
from rpt_tpu_torch import random as rnd

NAMES = (integrator.shadow_lanes, integrator.shadow_live_lanes)


def _counts() -> list:
    c = kernels.launch_counts()
    return [c[fn] for fn in NAMES]


def _dragon():
    """Two shadow-casting sphere lights and an ambient light, which casts none."""
    scene = scenes.build_dragon_scene(mesh=scenes.trefoil_mesh(40, 8))
    return scene, scenes.dragon_camera()


def _wine_glass():
    return scenes.build_wine_glass_trefoil_scene(scenes.trefoil_mesh(40, 8)), scenes.wine_glass_camera()


def _camera_rays(camera, w: int, h: int):
    ys, xs = torch.meshgrid(torch.linspace(0.9, -0.9, h), torch.linspace(-0.9, 0.9, w), indexing="ij")
    return camera.cast_rays(xs.reshape(-1), ys.reshape(-1), rnd.PRNGKey(1))


@pytest.mark.parametrize("compact", [False, True, "octant", "morton"])
@pytest.mark.parametrize("build, lights", [(_wine_glass, 1), (_dragon, 2)])
def test_the_counts_are_the_lanes_and_live_lanes_of_an_eager_pass(build, lights, compact, monkeypatch):
    scene, camera = build()
    sd = scene.compile(device="cpu")
    o, d = _camera_rays(camera, 24, 16)
    seen = []
    original = integrator.sample_lights

    def sample_lights(scene_data, mat, pos, n, wo, key, t_min, found, compact=False):
        seen.append(found.clone())
        return original(scene_data, mat, pos, n, wo, key, t_min, found, compact=compact)

    monkeypatch.setattr(integrator, "sample_lights", sample_lights)
    before = _counts()
    integrator.trace_paths(sd, o, d, rnd.PRNGKey(7), 3, 1e-3, compact=compact)
    added = [a - b for a, b in zip(_counts(), before)]
    assert len(seen) == 4
    assert added == [lights * o.shape[0] * len(seen), lights * sum(int(f.sum()) for f in seen)]
    assert 0 < added[1] < added[0]


def test_a_scene_without_a_shadow_casting_light_counts_nothing():
    scene = scenes.build_pegasus_trefoil_scene(scenes.trefoil_mesh(40, 8), sky_height=16)
    r = Renderer(scene, scenes.pegasus_camera(), width=16, height=16, max_bounces=3, num_samples=2, device="cpu")
    before = _counts()
    r.render_buffer()
    assert _counts() == before


def test_the_counts_change_no_value_of_a_render(monkeypatch):
    scene, camera = _wine_glass()
    r = Renderer(scene, camera, width=24, height=16, max_bounces=3, num_samples=2, device="cpu", seed=3)
    counted = r.render_buffer()
    monkeypatch.setattr(integrator, "add_count", lambda *args, **kwargs: None)
    before = _counts()
    plain = r.render_buffer()
    assert _counts() == before
    assert torch.equal(counted.sum, plain.sum) and torch.equal(counted.sum_sq, plain.sum_sq)


def test_a_count_is_a_slot_of_the_device_table():
    before = _counts()
    kernels.add_count(integrator.shadow_live_lanes, "cpu", torch.tensor(5))
    kernels.add_count(integrator.shadow_lanes, "cpu", 9)
    assert [a - b for a, b in zip(_counts(), before)] == [9, 5]
    with pytest.raises(ValueError):
        kernels.add_count(integrator.shadow_lanes, "cpu", 1, slot=1)
