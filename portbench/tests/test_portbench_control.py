"""The check must fail what it exists to catch: the control (the plain
reference in bfloat16, the precision below the configuration's float32, in
the program's place), and the run with its timed path broken underneath in
each way a render can be: a sample pass that leaves the buffer unchanged,
half of the samples left out with the mean taken over the rest, and an
answer altered where it is made (every fourth lane's radiance its neighbour's)."""

import json

import pytest
import torch

from portbench import calibrate, check, frames, harness, registry

from small import small

CHECKOUT = registry.PACKAGE + "/.."
BENCH = registry.benchmark(CHECKOUT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _control_numbers(cell: str, device: str, overrides, seed: int) -> dict:
    c = harness.prepare(cell, seed, CHECKOUT, device, overrides=overrides)
    seeds = [frames.frame_seed(seed, k) for k in range(c.limits["frames"])]
    ctl = calibrate.control_frames(c.spec, seeds, c.driver.pixels, device, torch.bfloat16,
                                   c.driver.entry != "render")
    refs = check.reference_renders(c.spec, seeds, c.driver.pixels, device)
    return check.numbers(ctl, refs, c.spec.spp), c.limits["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails_the_check(cell):
    numbers, limits = _control_numbers(cell, "cpu", small(cell), 11)
    assert any(v > limits[k] for k, v in numbers.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails_the_check_on_the_card_on_three_seeds(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (101, 202, 303):
        numbers, limits = _control_numbers(cell, "cuda", None, seed)
        assert any(v > limits[k] for k, v in numbers.items()), (seed, numbers)


def _unchanged(self, buffer, iterations, start_iter=0, scene_data=None):
    return buffer


def _half(original):
    """Every odd sample of a frame left out; the buffer counts the rest."""
    def sample_into(self, buffer, iterations, start_iter=0, scene_data=None):
        for s in range(start_iter, start_iter + iterations):
            if s % 2 == 0:
                buffer = original(self, buffer, 1, s, scene_data)
        return buffer
    return sample_into


def _swapped(original):
    def trace_paths(*args, **kwargs):
        radiance = original(*args, **kwargs)
        out = radiance.clone()
        out[::4] = radiance.roll(1, 0)[::4]
        return out
    return trace_paths


@pytest.mark.parametrize("fault", ["unchanged", "half", "swapped"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_reads_not_correct(cell, fault, monkeypatch):
    import rpt_tpu_torch.renderer as r

    if fault == "unchanged":
        monkeypatch.setattr(r.Renderer, "sample_into", _unchanged)
    elif fault == "half":
        monkeypatch.setattr(r.Renderer, "sample_into", _half(r.Renderer.sample_into))
    else:
        monkeypatch.setattr(r, "trace_paths", _swapped(r.trace_paths))
    result = harness.run_cell(cell, 5, 0.0, False, CHECKOUT, "cpu", overrides=small(cell))
    assert not result["correct"], json.dumps(result)
