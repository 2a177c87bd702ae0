"""The port's public names take the reference's parameters.

For every name of `rpt_tpu.__all__`, `rpt_tpu.ode.__all__` and
`rpt_tpu.parallel.__all__`, and every public method a reference class
defines, the port's parameters start with the reference's names in the
reference's order; the only extras allowed after them are the port's
`device` and `scene_data` keywords, and `backend`, which lets
`parallel.init_multihost` ask for gloo where its shards are on a card
(NCCL does not put two processes on one card).

The same holds for every submodule of `rpt_tpu` that has an `__all__`
(the `*_pallas` modules apart: the port's kernels replace them): its
counterpart in the port exports every name, with the same parameters. The
submodules' extras may also be `dtype`: where the reference makes values
of its default real type (float64 under `jax_enable_x64`), the port takes
the type as an argument (the sampling draws). One deviation is recorded:
`scene.SceneData`'s fields are the port's own compiled packs (`bvh8`,
`bvh2`, `tlas8`, `tlas2`, the environment's device tensors), not the
reference's TPU packs.
"""

import importlib
import inspect
import pkgutil

import pytest

import rpt_tpu
import rpt_tpu.ode
import rpt_tpu.parallel
import rpt_tpu_torch
import rpt_tpu_torch.ode
import rpt_tpu_torch.parallel

EXTRAS = ("device", "scene_data", "backend")
MODULES = [(rpt_tpu, rpt_tpu_torch), (rpt_tpu.ode, rpt_tpu_torch.ode), (rpt_tpu.parallel, rpt_tpu_torch.parallel)]
SUBMODULE_EXTRAS = EXTRAS + ("dtype",)
# (module, name) -> why the port's parameters differ on purpose.
DEVIATIONS = {("rpt_tpu.scene", "SceneData"): "the port's compiled packs are its own"}


def _submodules() -> list:
    """Every public submodule of `rpt_tpu` with an `__all__`, the `*_pallas`
    kernel modules apart."""
    names = []
    for info in pkgutil.walk_packages(rpt_tpu.__path__, "rpt_tpu."):
        last = info.name.rsplit(".", 1)[1]
        if last.startswith("_") or last.endswith("_pallas"):
            continue
        if hasattr(importlib.import_module(info.name), "__all__"):
            names.append(info.name)
    return names


SUBMODULES = _submodules()


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):  # a builtin without a signature
        return None


def _pairs(modules=MODULES):
    for ref_mod, port_mod in modules:
        for name in ref_mod.__all__:
            ref = getattr(ref_mod, name)
            yield f"{ref_mod.__name__}.{name}", ref, getattr(port_mod, name, None)
            if inspect.isclass(ref):
                for attr in vars(ref):
                    if not attr.startswith("_") and callable(getattr(ref, attr)):
                        port_cls = getattr(port_mod, name, None)
                        yield (f"{ref_mod.__name__}.{name}.{attr}", getattr(ref, attr),
                               getattr(port_cls, attr, None))


def signature_faults(pairs, extras=EXTRAS) -> list:
    """The pairs whose port parameters are not the reference's, in its
    order, followed by nothing but `extras`."""
    faults = []
    for label, ref, port in pairs:
        if port is None:
            faults.append(f"{label}: missing in the port")
            continue
        want, got = _params(ref), _params(port)
        if want is None and got is None:
            continue
        if want is None or got is None or got[:len(want)] != want or any(p not in extras for p in got[len(want):]):
            faults.append(f"{label}: reference {want}, port {got}")
    return faults


def test_every_public_name_takes_the_reference_parameters():
    pairs = list(_pairs())
    assert len(pairs) > 60
    faults = signature_faults(pairs)
    assert not faults, "\n".join(faults)


@pytest.mark.parametrize("module", SUBMODULES)
def test_every_submodule_exports_the_reference_names(module):
    """The port's counterpart of `module` exports each name of the
    reference's `__all__` (in its own `__all__`), with the reference's
    parameters as above, apart from DEVIATIONS."""
    ref_mod = importlib.import_module(module)
    port_mod = importlib.import_module(module.replace("rpt_tpu", "rpt_tpu_torch", 1))
    missing = [name for name in ref_mod.__all__ if name not in getattr(port_mod, "__all__", ())]
    assert not missing, f"{module}: {missing} not exported by the port"
    pairs = [p for p in _pairs([(ref_mod, port_mod)])
             if (module, p[0].split(".")[len(module.split("."))]) not in DEVIATIONS]
    faults = signature_faults(pairs, SUBMODULE_EXTRAS)
    assert not faults, "\n".join(faults)


def test_submodules_cover_the_reference():
    assert len(SUBMODULES) >= 20
    assert {"rpt_tpu.native", "rpt_tpu.ops.bvh", "rpt_tpu.ops.tlas", "rpt_tpu.sampling"} <= set(SUBMODULES)
    assert not any(m.endswith("_pallas") for m in SUBMODULES)


def test_native_names_build_and_load():
    """`native_available` says whether the native libraries build and
    load; `get_lib` holds their entry points, as the reference's one
    library holds its own, and the digest's hash beside them."""
    from rpt_tpu_torch import native

    assert native.native_available() is True
    lib = native.get_lib()
    for fn in ("rpt_build_bvh_sah", "rpt_parse_obj", "rpt_obj_free", "rpt_murmur3_x64_128"):
        assert callable(getattr(lib, fn))


def test_native_available_is_false_when_a_build_fails(monkeypatch):
    from rpt_tpu_torch import native

    def refuse(name):
        raise RuntimeError(f"g++ failed building {name}")

    monkeypatch.setattr(native, "_load", refuse)
    assert native.get_lib() is None and native.native_available() is False


def test_renderer_takes_dynamic_twelfth_and_device_after_it():
    params = _params(rpt_tpu_torch.Renderer)
    assert params.index("dynamic") == 11 == _params(rpt_tpu.Renderer).index("dynamic")
    assert params[12:] == ["device"]


@pytest.mark.parametrize("port_params, ok", [
    (["scene", "camera", "dtype", "dynamic", "device"], True),
    (["scene", "camera", "dtype", "device"], False),  # the parent's Renderer: `dynamic` missing
    (["scene", "camera", "dtype", "device", "dynamic"], False),  # out of the reference's order
    (["scene", "camera", "dtype", "dynamic", "verbose"], False),  # an extra the rule does not allow
])
def test_the_rule_catches_a_missing_or_misplaced_parameter(port_params, ok):
    ref = inspect.Signature([inspect.Parameter(p, inspect.Parameter.POSITIONAL_OR_KEYWORD)
                             for p in ("scene", "camera", "dtype", "dynamic")])
    port = inspect.Signature([inspect.Parameter(p, inspect.Parameter.POSITIONAL_OR_KEYWORD) for p in port_params])

    class Ref:
        __signature__ = ref

    class Port:
        __signature__ = port

    assert (signature_faults([("Renderer", Ref, Port)]) == []) == ok
