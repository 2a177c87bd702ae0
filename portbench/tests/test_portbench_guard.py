"""The import guard: nothing the harness or the reference loads is JAX or
the JAX package (names compared whole), and the reference loads nothing of
the port."""

import os
import subprocess
import sys

from portbench import guard, registry

ROOT = os.path.dirname(registry.PACKAGE)


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_names_are_compared_whole():
    sys.modules["rpt_tpu_torch_fixture_mod"] = object()
    try:
        assert "rpt_tpu_torch_fixture_mod" not in guard.loaded_forbidden()
    finally:
        del sys.modules["rpt_tpu_torch_fixture_mod"]
    sys.modules["rpt_tpu.fixture"] = object()
    try:
        assert guard.loaded_forbidden() == ["rpt_tpu.fixture"]
    finally:
        del sys.modules["rpt_tpu.fixture"]


def test_the_harness_and_the_port_load_no_jax():
    loaded = _modules_after("from portbench import run, harness, calibrate\nimport rpt_tpu_torch, rpt_tpu_torch.kernels")
    assert "rpt_tpu_torch" in loaded
    assert not loaded & set(guard.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    assert guard.reference_imports(registry.PACKAGE) == []
    loaded = _modules_after("import portbench.reference.trace, portbench.check")
    assert not loaded & (set(guard.FORBIDDEN) | {guard.PORT})
