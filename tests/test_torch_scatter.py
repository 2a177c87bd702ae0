"""The scatter step (`ops/scatter.py`) on the CPU.

`scatter` is `trace_paths`' sampled direction, BSDF value and path weight in
one call. On the CPU it runs its plain torch version, which is the lines it
replaced; on a CUDA card it launches `csrc/scatter.cu`, held to the plain
version in `test_torch_cuda.py`, and where an input requires grad rebuilds
the weight in torch on the kernel's samples. The card's paths are rehearsed
here with the kernel's outputs made by the plain version (`_kernel_outputs`).
"""

import math
import re

import numpy as np
import pytest
import torch

from rpt_tpu_torch import kernels, materials
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch.materials import Material, MaterialTable
from rpt_tpu_torch.ops import scatter as scatter_mod
from rpt_tpu_torch.sampling import disk_point, uniform_disk
from rpt_tpu_torch.utils import vmath

# Each benchmark configuration's materials (scenes.build_pegasus_scene,
# scenes.build_wine_glass_scene): rough ice on a diffuse floor; near-specular
# clear glass (m^2 = 1e-8) on a diffuse floor under a light.
CONFIG_MATERIALS = {
    "pegasus": [Material.transparent_colored((0xF8 / 255, 0xF8 / 255, 1.0), 1.31, 0.2),
                Material.diffuse((0xDD / 255,) * 3)],
    "wine_glass": [Material.clear(1.5, 0.0001), Material.diffuse((0x6F / 255, 0x5D / 255, 0x48 / 255)),
                   Material.light((1.0, 1.0, 1.0), 200.0)],
}


def _wavefront(config, dtype, n=2000, seed=0):
    """Unit normals and outgoing directions from both sides, ~80% of the lanes
    hitting, materials gathered from the configuration's table."""
    rng = np.random.default_rng(seed)

    def unit(k):
        v = rng.normal(size=(k, 3))
        return torch.as_tensor(v / np.linalg.norm(v, axis=-1, keepdims=True), dtype=dtype)

    table = MaterialTable.pack(CONFIG_MATERIALS[config], dtype=dtype)
    ids = torch.as_tensor(rng.integers(0, len(CONFIG_MATERIALS[config]), n), dtype=torch.int32)
    found = torch.as_tensor(rng.uniform(size=n) < 0.8)
    return table, table.gather(ids), unit(n), unit(n), found


def _replaced_lines(key, mat, n, wo, found):
    """The lines of `trace_paths` that `scatter` replaced."""
    wi, pdf, valid = materials.sample_f(key, mat, n, wo)
    wi, pdf = wi.detach(), pdf.detach()
    f = materials.bsdf(mat, n, wo, wi)
    ok = found & valid & (pdf > 1e-10)
    pdf_safe = torch.where(ok, pdf, torch.ones_like(pdf))
    w = f * (vmath.absolute(vmath.dot(wi, n)) / pdf_safe)[:, None]
    return wi, torch.where(ok[:, None], w, torch.zeros_like(w)), ok


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32) if t.is_floating_point() else t


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("config", sorted(CONFIG_MATERIALS))
def test_scatter_on_the_cpu_is_the_lines_it_replaced(config, dtype):
    _, mat, n, wo, found = _wavefront(config, dtype)
    key = rnd.fold_in(rnd.PRNGKey(7), 3)
    wi, w, ok = scatter_mod.scatter(key, mat, n, wo, found)
    _assert_bit_equal((wi, w, ok), _replaced_lines(key, mat, n, wo, found))
    assert 0.2 < ok.float().mean() < 0.8 and (w[ok] > 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sample_draws_are_the_draws_sample_f_made(dtype):
    """`sample_draws` makes `sample_f`'s five draws as it made them inline:
    the key split in four, the disk's through `uniform_disk`."""
    key, shape = rnd.PRNGKey(11), (5, 37)
    draws = materials.sample_draws(key, shape, "cpu", dtype)
    k_lobe, k_theta, k_phi, k_disk = rnd.split(key, 4)
    assert torch.equal(draws.u, rnd.uniform(k_theta, shape, dtype=dtype, minval=1e-7, maxval=1.0))
    assert torch.equal(draws.phi, rnd.uniform(k_phi, shape, dtype=dtype, minval=0.0, maxval=2.0 * math.pi))
    assert torch.equal(draws.lobe, rnd.uniform(k_lobe, shape, dtype=dtype))
    disk = uniform_disk(k_disk, shape, device="cpu", dtype=dtype)
    assert torch.equal(disk_point(draws.disk_r, draws.disk_a), disk)


def _kernel_outputs(calls):
    """A stand-in for `scatter_kernel` off the card: its outputs, made by the
    plain version with no graph, as the kernel returns them; each call's
    (launches, with_pdf) goes to `calls`."""

    def kernel(draws, mat, n, wo, found, launches=None, with_pdf=False):
        calls.append((launches, with_pdf))
        with torch.no_grad():
            wi, pdf, valid = materials.sample_f_drawn(draws, mat, n, wo)
            ok = found & valid & (pdf > scatter_mod.PDF_EPS)
            pdf_safe = torch.where(ok, pdf, torch.ones_like(pdf))
            w = scatter_mod.weight(mat, n, wo, wi, pdf_safe, ok)
        return (wi, w, ok, pdf_safe) if with_pdf else (wi, w, ok)

    return kernel


def _grads(fn, table, ids, n, wo, found, rays=False):
    """The gradient of a weighted sum of `fn`'s weights with respect to the
    material table's columns, and with `rays` to n and wo as well."""
    leaves = MaterialTable(**{f: v.clone().requires_grad_() for f, v in vars(table).items()})
    if rays:
        n, wo = n.clone().requires_grad_(), wo.clone().requires_grad_()
    _, w, _ = fn(rnd.PRNGKey(4), leaves.gather(ids), n, wo, found)
    (w * torch.tensor([0.3, 0.5, 0.7], dtype=w.dtype)).sum().backward()
    out = {f: v.grad for f, v in vars(leaves).items()}
    return {**out, "n": n.grad, "wo": wo.grad} if rays else out


def _assert_same_grads(got, want):
    assert set(got) == set(want)
    for f in want:
        assert (got[f] is None) == (want[f] is None), f
        if want[f] is not None:
            assert torch.equal(got[f], want[f]), f


def test_material_gradients_through_scatter_are_today_s(monkeypatch):
    """Columns that require grad still take the kernel off the CPU, which
    returns the weight's divisor too; the weight rebuilt in torch on its
    samples gives the gradient of the lines it replaced, bit for bit."""
    table, _, n, wo, found = _wavefront("pegasus", torch.float32, n=600)
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 2, 600), dtype=torch.int32)
    want = _grads(_replaced_lines, table, ids, n, wo, found)
    calls = []
    monkeypatch.setattr(scatter_mod, "_on_cpu", lambda device: False)
    monkeypatch.setattr(scatter_mod, "scatter_kernel", _kernel_outputs(calls))
    got = _grads(scatter_mod.scatter, table, ids, n, wo, found)
    _assert_same_grads(got, want)
    assert float(got["roughness"].abs().sum()) > 0.0
    assert [with_pdf for _, with_pdf in calls] == [True]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("config", sorted(CONFIG_MATERIALS))
def test_gradients_through_the_kernel_path_are_the_plain_version_s(config, dtype, monkeypatch):
    """With the normals and outgoing directions requiring grad as well (a
    camera gradient), the card's autograd path (the kernel's samples, the
    weight rebuilt in torch) gives the plain version's values and gradient
    bit for bit, in one counted launch."""
    table, _, n, wo, found = _wavefront(config, dtype, n=500, seed=5)
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, len(CONFIG_MATERIALS[config]), 500),
                          dtype=torch.int32)
    want = _grads(_replaced_lines, table, ids, n, wo, found, rays=True)
    calls = []
    monkeypatch.setattr(scatter_mod, "_on_cpu", lambda device: False)
    monkeypatch.setattr(scatter_mod, "scatter_kernel", _kernel_outputs(calls))
    got = _grads(scatter_mod.scatter, table, ids, n, wo, found, rays=True)
    _assert_same_grads(got, want)
    assert float(got["n"].abs().sum()) > 0.0 and float(got["wo"].abs().sum()) > 0.0
    assert len(calls) == 1 and calls[0][1] and calls[0][0] is not None
    leaves = table.gather(ids)
    _assert_bit_equal(scatter_mod.scatter(rnd.PRNGKey(4), leaves, n, wo, found),
                      _replaced_lines(rnd.PRNGKey(4), leaves, n, wo, found))


def test_the_kernel_runs_where_nothing_requires_grad(monkeypatch):
    """Off the CPU, inputs that need no gradient (or a gradient that is not
    being recorded) go to the kernel alone, with no divisor asked for,
    counted in the slot of their type."""
    calls = []
    monkeypatch.setattr(scatter_mod, "_on_cpu", lambda device: False)
    monkeypatch.setattr(scatter_mod, "scatter_kernel", _kernel_outputs(calls))
    for dtype in (torch.float32, torch.float64):
        table, mat, n, wo, found = _wavefront("wine_glass", dtype, n=300)
        key = rnd.PRNGKey(9)
        _assert_bit_equal(scatter_mod.scatter(key, mat, n, wo, found), _replaced_lines(key, mat, n, wo, found))
        leaves = MaterialTable(**{f: v.clone().requires_grad_() for f, v in vars(table).items()})
        with torch.no_grad():
            scatter_mod.scatter(key, leaves.gather(torch.zeros(300, dtype=torch.int32)), n, wo, found)
    slot = kernels._COUNTED[scatter_mod.scatter][0]
    table_addr = kernels._table(torch.device("cpu")).data_ptr()
    assert [c.value for c, _ in calls] == [table_addr + 8 * (slot + s) for s in (0, 0, 1, 1)]
    assert not any(with_pdf for _, with_pdf in calls)


def _c_params(source, entry):
    """The parameter count of `entry` in a CUDA source's C interface."""
    body = re.search(rf"int {entry}\(([^)]*)\)", source).group(1)
    return len(body.split(","))


def test_the_kernel_library_is_registered():
    assert set(kernels._SIGNATURES["scatter"]) == {"rpt_scatter", "rpt_scatter_f64"}
    assert "scatter" in kernels.sources()
    with open(kernels.sources()["scatter"], encoding="utf-8") as f:
        source = f.read()
    for entry, argtypes in kernels._SIGNATURES["scatter"].items():
        assert _c_params(source, entry) == len(argtypes), entry
    assert kernels._COUNTED[scatter_mod.scatter][1] == 2


def test_scatter_counts_nothing_on_the_cpu():
    kernels.reset_launch_counts()
    _, mat, n, wo, found = _wavefront("pegasus", torch.float32, n=50)
    scatter_mod.scatter(rnd.PRNGKey(1), mat, n, wo, found)
    assert kernels.launch_counts()[scatter_mod.scatter] == 0


def test_a_sample_launches_the_kernel_once_a_depth(monkeypatch):
    """Where the kernel runs, a sample of `max_bounces` bounces launches it
    once at each depth below `max_bounces`; the benchmark's reader gives
    that per sample, and nothing for a tree without the counter."""
    import types

    from portbench import registry
    from rpt_tpu_torch import Buffer, Renderer, scenes

    stand_in = _kernel_outputs([])

    def kernel(draws, mat, n, wo, found, launches=None, with_pdf=False):
        kernels.add_count(scatter_mod.scatter, n.device, 1, 0 if n.dtype == torch.float32 else 1)
        return stand_in(draws, mat, n, wo, found, launches, with_pdf)

    monkeypatch.setattr(scatter_mod, "_on_cpu", lambda device: False)
    monkeypatch.setattr(scatter_mod, "scatter_kernel", kernel)
    r = Renderer(scenes.build_cornell_scene(), scenes.cornell_camera(), width=16, height=12, max_bounces=3,
                 num_samples=2, device="cpu")
    kernels.reset_launch_counts()
    r._sample_into_eager(Buffer.new(16, 12, device="cpu"), 2)
    launches = {fn.__name__: n for fn, n in kernels.launch_counts().items()}
    assert launches["scatter"] == 2 * 3
    read = registry.reader("scatter_launches_per_sample")
    assert read(types.SimpleNamespace(launches=launches, stretch_samples=2)) == 3
    assert read(types.SimpleNamespace(launches={"_threefry": 80}, stretch_samples=2)) is None
    assert read(types.SimpleNamespace(launches=None, stretch_samples=2)) is None


def test_a_differentiated_sample_takes_the_kernel_twice_a_depth(monkeypatch):
    """`grad.make_diff_render` off the CPU: the checkpointed sample launches
    the kernel once a depth below `max_bounces` forward and once again in
    the backward's recompute, and the material gradient is the plain
    version's bit for bit."""
    from rpt_tpu_torch import scenes
    from rpt_tpu_torch.grad import make_diff_render

    def step():
        fn, m0 = make_diff_render(scenes.build_cornell_scene(), scenes.cornell_camera(), 12, 8, max_bounces=3,
                                  spp=2, device="cpu")
        leaves = MaterialTable(**{f: v.clone().requires_grad_() for f, v in vars(m0).items()})
        img = fn(leaves)
        img.mean().backward()
        return img.detach(), {f: v.grad for f, v in vars(leaves).items()}

    want_img, want = step()
    stand_in = _kernel_outputs([])

    def kernel(draws, mat, n, wo, found, launches=None, with_pdf=False):
        kernels.add_count(scatter_mod.scatter, n.device, 1, 0)
        return stand_in(draws, mat, n, wo, found, launches, with_pdf)

    monkeypatch.setattr(scatter_mod, "_on_cpu", lambda device: False)
    monkeypatch.setattr(scatter_mod, "scatter_kernel", kernel)
    kernels.reset_launch_counts()
    img, got = step()
    assert kernels.launch_counts()[scatter_mod.scatter] == 2 * 3 * 2
    assert torch.equal(img, want_img)
    _assert_same_grads(got, want)
    assert any(g is not None and float(g.abs().sum()) > 0.0 for g in got.values())
