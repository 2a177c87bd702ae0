"""The examples that read an asset, through the port against their scripts,
on the CPU, on stand-in files (`rpt_tpu_torch.examples._stand_ins`).

`teapot` (OBJ), `cylinder` (binary STL), `metal` (OBJ, `.hdr`, two instances
of one mesh), `rustacean` (OBJ), `fractal_teapots` (`--levels 3`: 37
instances), `pegasus` (OBJ read from a zip member), `wine_glass` (OBJ),
`dragon --obj` and `lego --zip` (OBJ+MTL from a zip): the meshes are the
trefoil at 2,256 and 4,000 triangles and the toy brick plane. Each
script's and module's `Renderer(...)` call is recorded
(`tests/test_torch_examples_config.py`) and both scenes are rendered by
their own packages at 16x16, 1 spp, seed 7, at the call's bounces, and
held to the port's bar: 99% of pixels to rtol 1e-3 / atol 1e-4, the mean
to 1e-3.
"""

import pytest

from test_torch_examples_config import render_recorded, stand_ins  # noqa: F401

NAMES = ["teapot", "cylinder", "metal", "rustacean", "fractal_teapots", "pegasus", "wine_glass", "dragon", "lego"]


@pytest.mark.parametrize("name", NAMES)
def test_asset_example_renders_as_its_script(name, stand_ins, monkeypatch, tmp_path):  # noqa: F811
    flags = stand_ins[name] + (["--levels", "3"] if name == "fractal_teapots" else [])
    render_recorded(name, flags, monkeypatch, tmp_path)
