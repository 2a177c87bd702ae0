"""The asset-free examples through the port against their scripts, on the CPU.

`basic`, `compound` (five cubes, three of them mirrored, turned about
(1, 1, 1); 5 bounces), `glass` (a dielectric sphere, 6 bounces), `spheres`
(a thin lens) and `simple_video` (frames 0 and 59 of the dynamic loop,
each with its own seed): each script's and each module's `Renderer(...)`
call is recorded (`tests/test_torch_examples_config.py`), and the two
scenes are rendered by their own packages at 16x16, 1 spp, seed 7, with
the call's bounces, and held to the port's bar: 99% of pixels to rtol
1e-3 / atol 1e-4, the mean to 1e-3.
"""

import pytest

from test_torch_examples_config import render_recorded


@pytest.mark.parametrize("name", ["basic", "compound", "glass", "spheres"])
def test_example_renders_as_its_script(name, monkeypatch, tmp_path):
    render_recorded(name, [], monkeypatch, tmp_path)


@pytest.mark.parametrize("frame", [0, 59])
def test_video_frame_renders_as_the_scripts(frame, monkeypatch, tmp_path):
    call = render_recorded("simple_video", ["--frames", str(frame + 1)], monkeypatch, tmp_path, frame)
    assert call["seed"] == frame and call["dynamic"]
