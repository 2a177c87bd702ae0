"""A later cell, configuration, mix and metric come as files and entries
alone: the harness finds each by its name under a root it is given."""

import json
import os
import shutil
import types

from portbench import harness, registry

from small import small

FIXTURE_BUILDER = '''
from portbench import registry

def build(cfg):
    base = registry.config("pegasus_trefoil")
    for k, v in cfg["base"].items():
        base[k] = {**base[k], **v} if isinstance(v, dict) else v
    spec = registry.builder("pegasus_trefoil")(base)
    spec.exposure_value = cfg["exposure_value"]
    return spec
'''


def _fixture(tmp):
    root = tmp / "bench"
    for sub in ("configs", "traffic", "checks", "metrics"):
        (root / sub).mkdir(parents=True)
    (root / "configs" / "dim_ice.json").write_text(json.dumps(
        {"name": "dim_ice", "exposure_value": -3.0, "interval": 1, "base": small("pegasus_trefoil")}))
    (root / "configs" / "dim_ice.py").write_text(FIXTURE_BUILDER)
    (root / "traffic" / "two_updates.json").write_text(json.dumps({"entry": "iterative_render", "interval": 1,
                                                                   "spp": 2}))
    (root / "checks" / "dim_ice.two_updates.json").write_text(json.dumps(
        {"frames": 1, "pixels": 64, "limits": {"image_off": 0.02, "image_gap": 0.005, "sums_off": 0.02}}))
    (root / "metrics" / "frames_seen.py").write_text("def read(ctx):\n    return len(ctx.frames) or None\n")
    bench = registry.benchmark(os.path.dirname(registry.PACKAGE))
    bench["configs"].append({"name": "dim_ice", "source": "https://example.org", "file": "x", "reduced": [],
                             "why": "fixture"})
    bench["workloads"].append({"name": "dim_ice.two_updates", "config": "dim_ice", "traffic": "two_updates",
                               "chips": 1, "why": "fixture"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "setup_s", "workloads": ["dim_ice.two_updates"]})
    checkout = tmp / "checkout"
    checkout.mkdir()
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, checkout


def test_a_new_config_mix_and_metric_are_found_from_files_alone(tmp_path):
    root, checkout = _fixture(tmp_path)
    bench = registry.benchmark(str(checkout))
    assert registry.config("dim_ice", str(root))["exposure_value"] == -3.0
    assert registry.traffic("two_updates", str(root))["interval"] == 1
    assert [m["name"] for m in registry.metrics_of(bench, "dim_ice.two_updates", "per_layer")] == ["frames_seen"]
    assert registry.reader("frames_seen", str(root))(types.SimpleNamespace(frames=[1, 2])) == 2

    result = harness.run_cell("dim_ice.two_updates", 77, 0.0, False, str(checkout), "cpu", root=str(root))
    assert result["correct"], result
    assert result["attempted"] == 1 and result["metrics"] == {}
    assert set(result["checks"]) == {"image_off", "image_gap", "sums_off"}
    assert not os.path.exists(os.path.join(registry.PACKAGE, "configs", "dim_ice.json"))
    shutil.rmtree(root)
