"""The port's public names take the reference's parameters.

For every name of `rpt_tpu.__all__`, `rpt_tpu.ode.__all__` and
`rpt_tpu.parallel.__all__`, and every public method a reference class
defines, the port's parameters start with the reference's names in the
reference's order; the only extras allowed after them are the port's
`device` and `scene_data` keywords, and `backend`, which lets
`parallel.init_multihost` ask for gloo where its shards are on a card
(NCCL does not put two processes on one card).
"""

import inspect

import pytest

import rpt_tpu
import rpt_tpu.ode
import rpt_tpu.parallel
import rpt_tpu_torch
import rpt_tpu_torch.ode
import rpt_tpu_torch.parallel

EXTRAS = ("device", "scene_data", "backend")
MODULES = [(rpt_tpu, rpt_tpu_torch), (rpt_tpu.ode, rpt_tpu_torch.ode), (rpt_tpu.parallel, rpt_tpu_torch.parallel)]


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):  # a builtin without a signature
        return None


def _pairs():
    for ref_mod, port_mod in MODULES:
        for name in ref_mod.__all__:
            ref = getattr(ref_mod, name)
            yield f"{ref_mod.__name__}.{name}", ref, getattr(port_mod, name, None)
            if inspect.isclass(ref):
                for attr in vars(ref):
                    if not attr.startswith("_") and callable(getattr(ref, attr)):
                        port_cls = getattr(port_mod, name, None)
                        yield (f"{ref_mod.__name__}.{name}.{attr}", getattr(ref, attr),
                               getattr(port_cls, attr, None))


def signature_faults(pairs) -> list:
    """The pairs whose port parameters are not the reference's, in its
    order, followed by nothing but EXTRAS."""
    faults = []
    for label, ref, port in pairs:
        if port is None:
            faults.append(f"{label}: missing in the port")
            continue
        want, got = _params(ref), _params(port)
        if want is None and got is None:
            continue
        if want is None or got is None or got[:len(want)] != want or any(p not in EXTRAS for p in got[len(want):]):
            faults.append(f"{label}: reference {want}, port {got}")
    return faults


def test_every_public_name_takes_the_reference_parameters():
    pairs = list(_pairs())
    assert len(pairs) > 60
    faults = signature_faults(pairs)
    assert not faults, "\n".join(faults)


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
