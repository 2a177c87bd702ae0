"""The traversal seam (`rpt_tpu_torch.ops.walk`) on the CPU.

A compiled scene holds one pack per level, and everything above `ops/`
reads the kernels' choice off the pack's type. For each of the four
families, a small scene that compiles to it: `SceneData.intersect` and
`occluded` go through the family's plain walk and finish (on a CUDA card
the same dispatch launches its kernel instead, `tests/test_torch_cuda.py`),
the per-scene cache key names the pack's library, the wavefront order is
"morton" exactly where a wide pack walks, and rays of the other real type
are refused.
"""

import dataclasses

import pytest
import torch

import rpt_tpu_torch.scene as scene_mod
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch import scenes
from rpt_tpu_torch.integrator import _auto_compact
from rpt_tpu_torch.ops import bvh2, bvh8, tlas2, tlas8, walk
from rpt_tpu_torch.ops.bvh import finish_closest
from rpt_tpu_torch.ops.intersect import merge_hits
from rpt_tpu_torch.ops.tlas import finish_instanced
from rpt_tpu_torch.renderer import camera_rays_tiled, pixel_ndc_tiled, scene_cache_key

FAMILIES = ["bvh8", "bvh2", "tlas8", "tlas2"]
PLAIN = {"bvh8": (bvh8.bvh8_closest_plain, bvh8.bvh8_occluded_plain),
         "bvh2": (bvh2.bvh2_closest_plain, bvh2.bvh2_occluded_plain),
         "tlas8": (tlas8.tlas8_closest_plain, tlas8.tlas8_occluded_plain),
         "tlas2": (tlas2.tlas2_closest_plain, tlas2.tlas2_occluded_plain)}
T_MIN = 1e-3


@pytest.fixture(scope="module")
def compiled():
    """{family: (compiled scene, camera rays)}, each scene compiled under the
    choice that gives it that family's pack: the 640-triangle trefoil with
    WIDE_KERNEL_MIN_TRIS lowered to 256 (bvh8), the toy plane's 160 rows
    (bvh2), and the brick city cut to 48 instances under each kernel choice
    (tlas8, tlas2)."""
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for family, choice, min_tris, (scene, camera) in (
                ("bvh8", "wide", 256, (scenes.build_dragon_scene(segments=40, sides=8), scenes.dragon_camera())),
                ("bvh2", "wide", 16384, (scenes.build_toy_plane_scene(), scenes.toy_plane_camera())),
                ("tlas8", "wide", 16384, (scenes.build_brick_city(n_instances=48), scenes.lego_camera())),
                ("tlas2", "binary", 16384, (scenes.build_brick_city(n_instances=48), scenes.lego_camera()))):
            mp.setattr(scene_mod, "_BVH_KERNEL", choice)
            mp.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", min_tris)
            sd = scene.compile(device="cpu")
            o, d, _ = camera_rays_tiled(camera, rnd.fold_in(rnd.PRNGKey(7), 0), pixel_ndc_tiled(24, 16, "cpu"))
            out[family] = sd, o, d
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_one_dispatch_walks_every_family(compiled, family, monkeypatch):
    sd, o, d = compiled[family]
    closest_plain, occluded_plain = PLAIN[family]
    assert [pack.library for pack in sd.packs] == [family]
    pack, = sd.packs
    geometry = sd.bvh if pack is sd.mesh_pack else sd.instanced
    bare = dataclasses.replace(sd, mesh_pack=None, instance_pack=None)  # the scene without its walk

    active = torch.arange(o.shape[0]) % 5 != 0
    out = closest_plain(pack, o, d, T_MIN, active)
    assert (out[0] < 1e38).sum() > 20  # the walk is on the path
    if pack.two_level:
        walked = finish_instanced(geometry, pack, o, d, T_MIN, *out, active)
    else:
        walked = finish_closest(geometry, o, d, T_MIN, *out, active)
    want = merge_hits(bare.intersect(o, d, T_MIN, active), walked)
    got = sd.intersect(o, d, T_MIN, active)
    for field in ("t", "normal", "mat_id"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field

    t_max = torch.where(torch.isfinite(want.t), want.t, torch.full_like(want.t, 1e3))
    t_max[1::2] *= 0.5
    occ = occluded_plain(pack, o, d, T_MIN, t_max, active)
    want_occ = bare.occluded(o, d, T_MIN, t_max, active) | walk.finish_occluded(occ, t_max, active)
    assert torch.equal(sd.occluded(o, d, T_MIN, t_max, active), want_occ)

    assert f"|{family}|" in scene_cache_key(sd)
    monkeypatch.delenv("RPT_COMPACT", raising=False)
    assert _auto_compact(sd) == ("morton" if pack.wide else False)
    assert pack.wide == (family in ("bvh8", "tlas8"))


@pytest.mark.parametrize("family", FAMILIES)
def test_dispatch_refuses_rays_of_another_type(compiled, family):
    sd, o, d = compiled[family]
    pack, = sd.packs
    geometry = sd.bvh if pack is sd.mesh_pack else sd.instanced
    o64, d64 = o.double(), d.double()
    with pytest.raises(TypeError, match="rays on a torch.float32 pack"):
        pack.closest_hit(geometry, o64, d64, T_MIN)
    with pytest.raises(TypeError, match="rays on a torch.float32 pack"):
        pack.occluded(geometry, o64, d64, T_MIN, 1.0)
