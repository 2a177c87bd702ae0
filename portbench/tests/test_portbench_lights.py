"""The reference's lights, next-event estimation, shadow rays, instances and
planes against the port's, on the CPU: a lit, instanced fixture scene
(`lit_city.py`), which no cell drives yet, run through the progressive
entry checks correct, and the bfloat16 control in the program's place does
not."""

import json
import os
import shutil

import torch

from portbench import calibrate, check, frames, harness, registry

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "lit_city.progressive"
CONFIG = {"name": "lit_city", "width": 24, "height": 16, "spp": 4, "max_bounces": 5, "exposure_value": 0.0,
          "interval": 2, "epsilon": 0.001,
          "camera": {"eye": [18.0, 14.0, 26.0], "center": [0.0, 4.0, 0.0], "up": [0.0, 1.0, 0.0],
                     "fov": 0.6283185307179586},
          "scene": {"instances": 96, "per_tower": 48, "seed": 0, "materials": 48}}
CHECKS = {"frames": 2, "pixels": 2048, "limits": {"image_off": 0.09, "image_gap": 0.01, "sums_off": 0.1}}


def _fixture(tmp):
    root = tmp / "bench"
    for sub in ("configs", "traffic", "checks"):
        (root / sub).mkdir(parents=True)
    (root / "configs" / "lit_city.json").write_text(json.dumps(CONFIG))
    shutil.copy(os.path.join(HERE, "lit_city.py"), root / "configs" / "lit_city.py")
    shutil.copy(os.path.join(registry.PACKAGE, "traffic", "progressive.json"), root / "traffic")
    (root / "checks" / f"{CELL}.json").write_text(json.dumps(CHECKS))
    checkout = tmp / "checkout"
    checkout.mkdir()
    (checkout / "BENCHMARK.json").write_text(json.dumps(
        {"workloads": [{"name": CELL, "config": "lit_city", "traffic": "progressive", "chips": 1, "why": "fixture"}],
         "end_to_end": [], "per_layer": []}))
    return str(root), str(checkout)


def test_a_lit_instanced_scene_runs_on_the_cpu_and_checks_correct(tmp_path):
    root, checkout = _fixture(tmp_path)
    spec = registry.builder("lit_city", root)(registry.config("lit_city", root))
    assert spec.shadow_lights() == 2 and any(o.mesh is None for o in spec.objects) and len(spec.meshes) > 1
    result = harness.run_cell(CELL, 2 ** 31 + 9, 0.0, False, checkout, "cpu", root=root)
    assert result["correct"], json.dumps(result)
    assert set(result["checks"]) == {"image_off", "image_gap", "sums_off"}


def test_the_bfloat16_control_fails_the_check_of_a_lit_scene(tmp_path):
    root, checkout = _fixture(tmp_path)
    c = harness.prepare(CELL, 11, checkout, "cpu", root)
    seeds = [frames.frame_seed(11, k) for k in range(c.limits["frames"])]
    ctl = calibrate.control_frames(c.spec, seeds, c.driver.pixels, "cpu", torch.bfloat16, True)
    numbers = check.numbers(ctl, check.reference_renders(c.spec, seeds, c.driver.pixels, "cpu"), c.spec.spp)
    assert any(v > CHECKS["limits"][k] for k, v in numbers.items()), numbers
