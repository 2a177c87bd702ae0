"""Which kernels walk a compiled scene: the port's choice against the JAX
package's.

The reference decides at compile time which kernel pack a tree gets
(`rpt_tpu/scene.py:736-754` for a baked BVH, `:686-689` with the dispatch at
`:333-364` for instanced meshes), from `_BVH_KERNEL` (env
`RPT_BVH_KERNEL`) and `WIDE_KERNEL_MIN_TRIS` (env `RPT_WIDE_MIN_TRIS`). The
port takes the same decision in `scene.choose_bvh_pack` /
`scene.choose_instanced_pack`, for `Scene.compile` and for
`convert.scene_data_from_arrays` alike. Here both packages compile the toy
plane, a 5k and a 20k trefoil and the brick city (cut to 96 instances)
under each setting, and the kernels each would run must be the same.
"""

import os
import sys

import pytest

import rpt_tpu.scene as ref_scene_mod
import rpt_tpu_torch.scene as scene_mod
from rpt_tpu.ops.tlas_pallas import tlas_pallas_eligible
from rpt_tpu_torch import convert
from rpt_tpu_torch.scenes import build_brick_city, build_dragon_scene, build_toy_plane_scene
from test_torch_reference_native import reference_native
from test_torch_render import reference_tree

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)
import dragon  # noqa: E402
import lego  # noqa: E402

reference_native()

SCENES = {
    "toy_plane": (lambda: lego.build_scene(), build_toy_plane_scene),
    "dragon_5k": (lambda: dragon.build_scene(target_tris=5000), lambda: build_dragon_scene(segments=125, sides=20)),
    "dragon_20k": (lambda: dragon.build_scene(target_tris=20000), lambda: build_dragon_scene(segments=244, sides=41)),
    "brick_city": (lambda: lego.build_brick_city(n_instances=96), lambda: build_brick_city(n_instances=96)),
}
# name -> (_BVH_KERNEL, WIDE_KERNEL_MIN_TRIS)
SETTINGS = {"wide": ("wide", 16384), "binary": ("binary", 16384), "wide_min_4096": ("wide", 4096)}


def reference_kernels(sd) -> set:
    """The kernels the reference runs on a TPU for a compiled scene."""
    out = set()
    if sd.bvh is not None:
        out.add("bvh8" if sd.bvh8_packed is not None else "bvh2" if sd.bvh_packed is not None else "xla")
    if sd.instanced is not None:
        if sd.instanced8_packed is not None and ref_scene_mod._BVH_KERNEL == "wide":
            out.add("tlas8")
        else:
            out.add("tlas2" if sd.instanced_packed is not None else "xla")
    return out


def port_kernels(sd) -> set:
    """The kernel libraries of the packs a compiled scene holds."""
    return {pack.library for pack in sd.packs}


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("scene", list(SCENES))
def test_compile_and_convert_choose_the_reference_kernels(scene, setting, monkeypatch):
    kernel, min_tris = SETTINGS[setting]
    for mod in (ref_scene_mod, scene_mod):
        monkeypatch.setattr(mod, "_BVH_KERNEL", kernel)
        monkeypatch.setattr(mod, "WIDE_KERNEL_MIN_TRIS", min_tris)
    build_ref, build_port = SCENES[scene]
    ref_sd = build_ref().compile()
    want = reference_kernels(ref_sd)
    assert "xla" not in want
    assert port_kernels(build_port().compile(device="cpu")) == want
    assert port_kernels(convert.scene_data_from_arrays(reference_tree(ref_sd), device="cpu")) == want


def test_expected_choices():
    """The choices the test above holds the port to, spelled out at the
    defaults: small meshes binary, large meshes wide, instances wide."""
    compiled = {name: port_kernels(build().compile(device="cpu")) for name, (_, build) in SCENES.items()}
    assert compiled == {"toy_plane": {"bvh2"}, "dragon_5k": {"bvh2"}, "dragon_20k": {"bvh8"},
                        "brick_city": {"tlas8"}}


def test_binary_two_level_takes_the_full_city(monkeypatch):
    """Deviation: the full 768-instance city is past the reference's SMEM
    budget for its binary two-level kernel (`tlas_pallas_eligible`), so
    under RPT_BVH_KERNEL=binary the reference walks it in its XLA loop. The
    port has no such budget: its binary two-level kernels take the scene."""
    monkeypatch.setattr(scene_mod, "_BVH_KERNEL", "binary")
    scene = build_brick_city()
    sd = scene.compile(device="cpu")
    assert port_kernels(sd) == {"tlas2"}
    pack = sd.instance_pack
    assert (pack.n_tlas, pack.num_nodes, pack.inst.shape[0]) == (767, 8571, 768)
    assert not tlas_pallas_eligible(lego.build_brick_city().compile().instanced)


def test_knobs_come_from_the_environment():
    """The defaults are the reference's, read from the same variables."""
    assert scene_mod._BVH_KERNEL == os.environ.get("RPT_BVH_KERNEL", "wide")
    assert scene_mod.WIDE_KERNEL_MIN_TRIS == int(os.environ.get("RPT_WIDE_MIN_TRIS", "16384"))
    assert (scene_mod._BVH_KERNEL, scene_mod.WIDE_KERNEL_MIN_TRIS) == (ref_scene_mod._BVH_KERNEL,
                                                                      ref_scene_mod.WIDE_KERNEL_MIN_TRIS)
