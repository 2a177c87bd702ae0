"""Each cell end to end on the CPU at a tiny size: the port's plain path
through the traffic's entry, then the check against the reference. A CPU
run reports no metric: it measures no device."""

import json

import pytest

from portbench import harness, registry

from small import small

BENCH = registry.benchmark(registry.PACKAGE + "/..")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_runs_on_the_cpu_and_checks_correct(cell):
    result = harness.run_cell(cell, 2 ** 31 + 7, 0.0, False, registry.PACKAGE + "/..", "cpu", overrides=small(cell))
    assert result["correct"], json.dumps(result)
    assert result["metrics"] == {} and "memory_peak_bytes" not in result["device"]
    assert list(result)[-1] == "checks"
    entry = registry.traffic(registry.workload(BENCH, cell)["traffic"])["entry"]
    assert ("sums_off" in result["checks"]) == (entry == "iterative_render")


def test_a_run_keys_its_frames_and_pixels_by_its_seed():
    from portbench import check, frames

    assert frames.frame_seed(2 ** 31 + 5, 0) == frames.frame_seed(2 ** 31 + 5, 0)
    assert frames.frame_seed(2 ** 31 + 5, 0) != frames.frame_seed(2 ** 31 + 5, 1)
    assert all(0 <= frames.frame_seed(s, k) < 2 ** 31 for s in (0, -3, 2 ** 40) for k in (-1, 0, 9))
    a = check.sample_pixels(2 ** 33, 100, 50, 64)
    assert (a == check.sample_pixels(2 ** 33, 100, 50, 64)).all() and len(set(a.tolist())) == 64
    assert (a != check.sample_pixels(2 ** 33 + 1, 100, 50, 64)).any()
