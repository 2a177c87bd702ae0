"""Package rules of the PyTorch/CUDA port.

`rpt_tpu_torch` and `chip_smoke.py` import neither JAX nor the JAX package,
and the port's entry points never fall back to the CPU on their own.
"""

import os
import re

import pytest
import torch

import rpt_tpu_torch
from rpt_tpu_torch import Renderer, Scene
from rpt_tpu_torch.scenes import build_brick_city
from rpt_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = [
    re.compile(r"^\s*import\s+jax\b"),
    re.compile(r"^\s*from\s+jax\b"),
    re.compile(r"^\s*from\s+rpt_tpu(\.|\s+import\b)"),
    re.compile(r"^\s*import\s+rpt_tpu(?!_torch)\b"),
    re.compile(r"\brpt_tpu\.(?!.*rpt_tpu_torch)\w"),
]


def _port_sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "rpt_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # git-ignored build outputs
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_port_imports_neither_jax_nor_the_jax_package():
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            for no, line in enumerate(fh, 1):
                code = line.split("#", 1)[0]
                if any(p.search(code) for p in FORBIDDEN):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{no}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


def test_grep_catches_a_forbidden_import():
    for line in ("import jax.numpy as jnp", "from jax import lax", "from rpt_tpu.ops import bvh",
                 "from rpt_tpu import Scene", "import rpt_tpu", "x = rpt_tpu.scene"):
        assert any(p.search(line) for p in FORBIDDEN), line
    for line in ("import rpt_tpu_torch", "from rpt_tpu_torch.ops import bvh8", "from . import random"):
        assert not any(p.search(line) for p in FORBIDDEN), line


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    scene = Scene()
    scene.add(rpt_tpu_torch.Object(rpt_tpu_torch.sphere()))
    with pytest.raises(RuntimeError, match="CUDA"):
        scene.compile()
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(scene)
    # Asking for the CPU is the one way onto it.
    assert Renderer(scene, device="cpu").device.type == "cpu"
    assert scene.compile(device="cpu").device.type == "cpu"


def test_parallel_entry_points_raise_without_cuda(monkeypatch):
    """A mesh, a sharded render and a multi-process render default to the
    cards; without one they raise, and CPU shards are asked for by name."""
    from rpt_tpu_torch.parallel import make_ray_mesh, render_distributed, render_multihost
    from rpt_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(multihost._LOCAL, "devices", None)
    scene = Scene()
    scene.add(rpt_tpu_torch.Object(rpt_tpu_torch.sphere()))
    r = Renderer(scene, width=8, height=4, device="cpu")
    for call in (make_ray_mesh, lambda: render_distributed(r), lambda: render_multihost(r)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert render_distributed(r, make_ray_mesh(2, device="cpu")).sum.device.type == "cpu"


def test_package_import_leaves_parallel_unimported():
    """As `rpt_tpu/__init__.py`, the package does not import `parallel`
    (torch.distributed) when it is imported."""
    import subprocess
    import sys

    code = "import sys, rpt_tpu_torch; print('rpt_tpu_torch.parallel' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr


def test_instanced_scene_compile_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = build_brick_city(n_instances=48)  # one tower: some bricks share a mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        scene.compile()
    sd = scene.compile(device="cpu")
    assert sd.instanced is not None and sd.instance_pack.library == "tlas8"
    assert sd.instance_pack.bounds.device.type == "cpu"


# The example modules also read and write images and meshes without the
# scripts' helpers or their image libraries.
EXAMPLE_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(PIL|imageio|examples|_sky|_fractal)\b")


def test_port_imports_no_script_and_no_image_library():
    scripts = {f[:-3] for f in os.listdir(os.path.join(ROOT, "examples")) if f.endswith(".py")}
    modules = set()
    offenders = []
    for path in _port_sources():
        if os.path.dirname(path) == os.path.join(ROOT, "rpt_tpu_torch", "examples"):
            modules.add(os.path.basename(path)[:-3])
        with open(path) as fh:
            for no, line in enumerate(fh, 1):
                code = line.split("#", 1)[0]
                imported = re.match(r"^\s*(?:import|from)\s+(\w+)", code)
                if EXAMPLE_FORBIDDEN.search(code) or (imported and imported.group(1) in scripts):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{no}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
    # The walk reaches every example module.
    assert {s for s in scripts if not s.startswith("_")} <= modules
