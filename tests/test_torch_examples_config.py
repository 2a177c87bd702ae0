"""The port's example modules (`rpt_tpu_torch.examples`) against the scripts
of `examples/`, on the CPU: the same `Renderer(...)` call.

Each script and its module run through their `main` with one flag set, the
script under `sys.argv` and the module with `--device cpu`, each with its
`Renderer` replaced by a recorder that takes the call's scene, camera and
settings and stops the example at its first render (a video at the frame
asked for; earlier frames get a black image). The flags and their defaults
must be the same (the module adds `--device`), and so must the settings:
size, bounces, samples, exposure, filter, ray offset, seed, dynamic, and,
for the progressive examples, the interval of `iterative_render`'s
callback; the cameras must agree to float32 rounding. The examples that
read an asset read stand-in files (`rpt_tpu_torch.examples._stand_ins`)
written once per test session.

Also here: the examples whose scene another test holds against the
reference (`cornell`, `dragon`, `lego`, `monomial_glass`,
`fractal_spheres`, `marbles`, `sphere`) build the scene of the port's
builder; the kernel choice of the two instanced examples follows the
reference's rule; a missing asset ends as the script ends; `main` writes a
PNG. `tests/test_torch_examples_analytic.py` and
`tests/test_torch_examples_assets.py` render the recorded scenes.
"""

import argparse
import importlib
import importlib.util
import inspect
import os
import struct
import sys

import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch
from rpt_tpu_torch import scenes
from rpt_tpu_torch.examples import _stand_ins
from rpt_tpu_torch.scene import _scene_digest
from test_torch_reference_native import reference_native

reference_native()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
sys.path.insert(0, EXAMPLES)  # the scripts import `_sky` and `_fractal`

NAMES = sorted(f[:-3] for f in os.listdir(EXAMPLES) if f.endswith(".py") and not f.startswith("_"))
FIELDS = ("width", "height", "exposure_value", "max_bounces", "num_samples", "epsilon", "seed", "dynamic")
CAMERA_FIELDS = ("eye", "direction", "up", "fov", "aperture", "focal_distance")
# The larger stand-in trefoil of the CPU tests, (segments, sides): the 120k
# one of the card cut to 4,000 triangles (the teapot's stays at
# `scenes.TEAPOT_KNOT`).
GLASS_KNOT = (100, 20)
SKY_HEIGHT = 16
# Examples whose script has a `--full` configuration.
FULL = ("simple_video", "marbles")


class Stop(Exception):
    """Raised by the recorder where the example would render."""


_SCRIPTS = {}


def script(name):
    """`examples/<name>.py`, imported once under a name of its own."""
    if name not in _SCRIPTS:
        spec = importlib.util.spec_from_file_location(f"example_script_{name}", os.path.join(EXAMPLES, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _SCRIPTS[name] = mod
    return _SCRIPTS[name]


def port(name):
    return importlib.import_module(f"rpt_tpu_torch.examples.{name}")


@pytest.fixture(scope="session")
def stand_ins(tmp_path_factory):
    """{example: its flags} of the stand-in files, written once."""
    d = tmp_path_factory.mktemp("stand_ins")
    return _stand_ins.write_stand_ins(str(d), glass_knot=GLASS_KNOT, sky_height=SKY_HEIGHT)


def recorder(real, frame: int):
    """A stand-in for `real` (a package's Renderer class) that records each
    call's arguments by name (defaults filled in) in `calls`, and raises
    Stop at render number `frame` (0-based); earlier renders return black."""
    sig = inspect.signature(real.__init__)
    calls = []

    class Recorder:
        def __init__(self, *args, **kwargs):
            bound = sig.bind(None, *args, **kwargs)
            bound.apply_defaults()
            call = dict(bound.arguments)
            call.pop("self")
            self.__dict__.update(call)
            calls.append(call)

        def render(self):
            if len(calls) > frame:
                raise Stop
            return np.zeros((self.height, self.width, 3), np.uint8)

        def iterative_render(self, callback_interval, callback, checkpoint_path=None):
            calls[-1]["interval"] = callback_interval
            raise Stop

    return Recorder, calls


def record(name, flags, monkeypatch, tmp_path, frame: int = 0) -> tuple:
    """(the script's call, the module's call) of `name` run with `flags`,
    at render number `frame`, from `tmp_path` (videos write there). Each
    call also holds, under "options", {flag: default} of the parser that
    read the flags."""
    monkeypatch.chdir(tmp_path)
    parse_args = argparse.ArgumentParser.parse_args
    out = []
    for mod, real in ((script(name), rpt_tpu.Renderer), (port(name), rpt_tpu_torch.Renderer)):
        rec, calls = recorder(real, frame)
        options = {}

        def spy(parser, args=None, namespace=None):
            options.update({a.option_strings[-1]: a.default for a in parser._actions if a.dest != "help"})
            return parse_args(parser, args, namespace)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
        monkeypatch.setattr(mod, "Renderer", rec)
        with pytest.raises(Stop):
            if mod.__name__.startswith("rpt_tpu_torch"):
                mod.main([*flags, "--device", "cpu"])
            else:
                monkeypatch.setattr(sys, "argv", [f"{name}.py", *flags])
                mod.main()
        assert len(calls) == frame + 1
        out.append(dict(calls[-1], options=options))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    return tuple(out)


def flags_of(name, stand_ins, full=False) -> list:
    return [*stand_ins.get(name, []), *(["--full"] if full else [])]


def assert_same_call(ref, got):
    """The same flags and defaults (the module adds `--device`), the same
    Renderer settings and the same camera."""
    assert {k: v for k, v in got["options"].items() if k != "--device"} == ref["options"]
    assert got["options"]["--device"] is None
    for f in FIELDS:
        assert got[f] == ref[f], f"{f}: port {got[f]!r}, script {ref[f]!r}"
    assert got["filter"].radius == ref["filter"].radius
    assert got.get("interval") == ref.get("interval")
    assert got["device"] == "cpu"
    ref_cam = ref["camera"] if ref["camera"] is not None else rpt_tpu.Camera()
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(got["camera"], f).numpy(), np.asarray(getattr(ref_cam, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


CASES = [(name, False) for name in NAMES] + [(name, True) for name in FULL]


def test_every_script_has_a_module():
    assert len(NAMES) == 19
    for name in NAMES:
        assert callable(port(name).main)


@pytest.mark.parametrize("name,full", CASES, ids=[f"{n}{'-full' if f else ''}" for n, f in CASES])
def test_module_makes_the_scripts_renderer_call(name, full, stand_ins, monkeypatch, tmp_path):
    ref, got = record(name, flags_of(name, stand_ins, full), monkeypatch, tmp_path)
    assert_same_call(ref, got)


def test_videos_keep_the_scripts_seed_per_frame(stand_ins, monkeypatch, tmp_path):
    """Frame i of `simple_video` renders with seed i, dynamic, as the script's."""
    ref, got = record("simple_video", ["--frames", "3"], monkeypatch, tmp_path, frame=2)
    assert_same_call(ref, got)
    assert got["seed"] == 2 and got["dynamic"]
    assert sorted(os.listdir(tmp_path / "video")) == ["image_0.png", "image_1.png"]


def test_module_functions_keep_the_scripts_signatures():
    """Every public function of a script is in its module, with the same
    parameters. A module may add `device` (where the script makes a state
    on the device), and its `main` takes `argv`."""
    for name in NAMES:
        mod = port(name)
        for fname, fn in vars(script(name)).items():
            if fname.startswith("_") or fname == "main" or not inspect.isfunction(fn) \
                    or fn.__module__ != f"example_script_{name}":
                continue
            ours = getattr(mod, fname, None)
            assert ours is not None, f"{name}.{fname} is missing"
            want = list(inspect.signature(fn).parameters)
            have = [p for p in inspect.signature(ours).parameters if p != "device"]
            assert have == want, f"{name}.{fname}: {have} != {want}"


def digest(scene) -> str:
    return _scene_digest(scene)


def test_held_examples_build_their_builders_scenes(stand_ins):
    """The examples held against the reference through `scenes` (and
    `tests/test_torch_render.py`'s sphere) build those very scenes."""
    from rpt_tpu_torch import Environment
    from rpt_tpu_torch.io.image import load_hdr
    from rpt_tpu_torch.io.obj import load_obj
    from test_torch_render import sphere_scene

    assert digest(port("sphere").build_scene()) == digest(sphere_scene(rpt_tpu_torch)[0])
    assert digest(port("cornell").build_scene()) == digest(scenes.build_cornell_scene())
    assert digest(port("dragon").build_scene(target_tris=5000)) == \
        digest(scenes.build_dragon_scene(*scenes.dragon_knot_size(5000)))
    obj = stand_ins["dragon"][1]
    assert digest(port("dragon").build_scene(obj)) == digest(scenes.build_dragon_scene(mesh=load_obj(obj)))
    # The toy plane from the zip is the toy plane of the `lego_toy` workload.
    assert digest(port("lego").build_scene(stand_ins["lego"][1])) == digest(scenes.build_toy_plane_scene())
    assert digest(port("lego").build_scene()) == digest(scenes.build_toy_plane_scene())
    hdr = stand_ins["monomial_glass"][1]
    assert digest(port("monomial_glass").build_scene(hdr)) == \
        digest(scenes.build_monomial_glass_scene(environment=Environment.from_hdri(load_hdr(hdr))))
    assert digest(port("monomial_glass").build_scene()) == \
        digest(scenes.build_monomial_glass_scene(environment=Environment.from_color((0.4, 0.45, 0.5))))
    assert digest(port("fractal_spheres").build_scene(3)) == digest(scenes.build_fractal_spheres_scene(3))
    state = port("marbles").initial_state(device="cpu")
    for test_mode in (True, False):
        assert digest(port("marbles").build_scene(state, test_mode)) == \
            digest(scenes.build_marbles_scene(state, test_mode))


def test_asset_examples_share_the_stand_in_builders(stand_ins):
    """`pegasus` and `wine_glass` build their scenes with the functions the
    trefoil workloads use (`build_pegasus_scene`, `build_wine_glass_scene`)."""
    from rpt_tpu_torch import Environment
    from rpt_tpu_torch.io.obj import load_obj

    mesh = port("pegasus").load_pegasus(stand_ins["pegasus"][1])
    assert digest(port("pegasus").build_scene(stand_ins["pegasus"][1])) == \
        digest(scenes.build_pegasus_scene(mesh.scale([1.4] * 3), Environment.from_hdri(scenes.procedural_sky())))
    obj = stand_ins["wine_glass"][1]
    assert digest(port("wine_glass").build_scene(obj)) == \
        digest(scenes.build_wine_glass_scene(load_obj(obj), Environment.from_color((0.25, 0.25, 0.28))))
    assert digest(port("fractal_teapots").build_scene(stand_ins["fractal_teapots"][1], 3)) == \
        digest(scenes.build_fractal_teapots_scene(load_obj(stand_ins["fractal_teapots"][1]), 3))


@pytest.mark.parametrize("name", ["fractal_teapots", "metal"])
def test_instanced_examples_follow_the_reference_kernel_choice(name, stand_ins, monkeypatch, tmp_path):
    """One mesh shared by several instances (937 teapots, two teapots): the
    two-level path, and the kernels the reference's rule gives it."""
    from test_torch_kernel_choice import port_kernels, reference_kernels

    ref, got = record(name, stand_ins[name], monkeypatch, tmp_path)
    want = reference_kernels(ref["scene"].compile())
    assert want == {"tlas8"}
    assert port_kernels(got["scene"].compile(device="cpu")) == want


@pytest.mark.parametrize("name,flag", [("teapot", "--obj"), ("cylinder", "--stl"), ("wine_glass", "--obj")])
def test_missing_asset_ends_as_the_script_ends(name, flag, monkeypatch, tmp_path):
    missing = str(tmp_path / "missing.asset")
    monkeypatch.setattr(sys, "argv", [f"{name}.py", flag, missing])
    with pytest.raises(SystemExit) as want:
        script(name).main()
    with pytest.raises(SystemExit) as got:
        port(name).main([flag, missing, "--device", "cpu"])
    assert str(got.value) == str(want.value) == f"Mesh not found: {missing} (pass {flag} PATH)"


def test_module_without_a_device_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        port("basic").main([])
    assert not os.path.exists(tmp_path / "basic.png")


def test_main_writes_a_png_of_its_size(tmp_path):
    out = tmp_path / "sphere.png"
    img = port("sphere").main(["--width", "24", "--height", "16", "--spp", "1", "--device", "cpu", "--out", str(out)])
    assert img.shape == (16, 24, 3) and img.dtype == np.uint8 and img.any()
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    assert struct.unpack(">II", data[16:24]) == (24, 16)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(out)), img)


# ---------------------------------------------------------------------------
# Renders of the recorded scenes (the tests of the other two files)
# ---------------------------------------------------------------------------

W = H = 16
SEED = 7


def assert_images_agree(got, want):
    """The port's render bar (`tests/test_torch_render.py`): 99% of pixels
    to rtol 1e-3 / atol 1e-4, the mean to 1e-3."""
    assert got.shape == want.shape == (H, W, 3)
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1)
    print(f"pixels agreeing: {close.mean():.4f}, means {got.mean():.6e} / {want.mean():.6e}")
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


def render_recorded(name, flags, monkeypatch, tmp_path, frame: int = 0):
    """The script's and the module's recorded scene, each rendered by its
    own package at W x H, 1 spp, seed SEED, with the call's bounces,
    exposure, ray offset, filter and dynamic flag, and held to the bar.
    Returns the module's recorded call."""
    ref, got = record(name, flags, monkeypatch, tmp_path, frame)
    assert_same_call(ref, got)
    kw = {k: ref[k] for k in ("exposure_value", "max_bounces", "epsilon", "dynamic")}
    want = np.asarray(rpt_tpu.Renderer(ref["scene"], ref["camera"], width=W, height=H, filter=ref["filter"],
                                       num_samples=1, seed=SEED, **kw).render_buffer().mean_image(ref["filter"]))
    port_renderer = rpt_tpu_torch.Renderer(got["scene"], got["camera"], width=W, height=H, filter=got["filter"],
                                           num_samples=1, seed=SEED, device="cpu", **kw)
    img = port_renderer.render_buffer().mean_image(got["filter"]).numpy()
    assert img.mean() > 0.0
    assert_images_agree(img, want)
    return got
