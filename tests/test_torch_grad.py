"""The port's differentiable rendering (`rpt_tpu_torch.grad`) against the JAX
package's `jax.grad` (`rpt_tpu.grad`): the same scene, seed and draws on
both sides, the port's gradient on the CPU.

Bars: |g_port - g_ref| <= 1e-4 * max|g_ref| per material leaf at bounces 0,
and <= 1e-3 * max|g_ref| at bounces >= 1, where a last-bit difference
between the packages' float32 arithmetic (XLA contracts multiply-adds into
FMAs, torch does not) travels further down a path; the float64 case is
held at 1e-9 (`F64_BAR`). Every path here is the
detached estimator's: gradients flow through the BSDF values, the lights
and the camera, and the traversal walks (the plain versions of the bvh8,
bvh2 and tlas8 kernels here) give hit times with no gradient.

The material leaves are those of `tests/test_grad_fd.py`'s scene (a
specular sphere on a diffuse plane under a point light), its clear sphere
through the transmission lobe, the 5,000-triangle trefoil of
`examples/dragon.py` and a 96-instance brick city of `examples/lego.py`.
"""

import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch
import rpt_tpu_torch.scene as scene_mod
from rpt_tpu.grad import make_diff_render as ref_make_diff_render
from rpt_tpu_torch.grad import make_diff_render, make_material_render_fn
from rpt_tpu_torch.materials import MaterialTable
from rpt_tpu_torch.scenes import build_brick_city, build_dragon_scene, dragon_camera, lego_camera
from test_torch_reference_native import reference_native
from test_torch_render import EXAMPLES

reference_native()

FIELDS = tuple(f.name for f in dataclasses.fields(MaterialTable))
W, H = 12, 8


def bar(bounces: int) -> float:
    return 1e-4 if bounces == 0 else 1e-3


def fd_scene(pkg):
    """`tests/test_grad_fd.py` `_scene()`, in either package."""
    s = pkg.Scene()
    s.add(pkg.Object(pkg.sphere()).material(pkg.Material.specular(pkg.hex_color(0xCC2222), 0.35)))
    s.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0x888888))))
    s.add(pkg.PointLight((25.0, 25.0, 25.0), (3.0, 5.0, 4.0)))
    return s


def clear_scene(pkg):
    """`tests/test_grad_fd.py` `_scene_clear()`: a dielectric sphere over a
    bright floor, radiance reaching the camera through the BTDF."""
    s = pkg.Scene()
    s.add(pkg.Object(pkg.sphere()).material(pkg.Material.clear(1.5, 0.05)))
    s.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse(pkg.hex_color(0xBBBBBB))))
    s.add(pkg.PointLight((25.0, 25.0, 25.0), (3.0, 5.0, 4.0)))
    return s


def fd_cam(pkg):
    return pkg.Camera.look_at([0.0, 1.5, 6.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], math.pi / 5)


def leaves(mats0, fields=FIELDS) -> dict:
    """Fresh leaves of a port material table, `fields` requiring grad."""
    return {f: getattr(mats0, f).detach().clone().requires_grad_(f in fields) for f in FIELDS}


def port_grads(img_fn, mats0, fields=FIELDS) -> dict:
    """d mean(image) / d leaf of the port, as numpy; a leaf the image does
    not depend on (`transparent`, read only through `> 0.5`) gets zeros."""
    m = leaves(mats0, fields)
    torch.mean(img_fn(MaterialTable(**m))).backward()
    return {f: (np.zeros(tuple(m[f].shape), np.float64) if m[f].grad is None else m[f].grad.numpy())
            for f in fields}


def ref_grads(img_fn, mats0) -> dict:
    g = jax.grad(lambda m: jnp.mean(img_fn(m)))(mats0)
    return {f: np.asarray(getattr(g, f)) for f in FIELDS}


def assert_grad_agrees(got, want, bounces, what=""):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    print(f"grad-relative-error[{what}, bounces={bounces}]: {err / scale:.3e}")
    assert np.isfinite(got).all(), what
    assert err <= bar(bounces) * scale, f"{what}: |g_port - g_ref| = {err:.3e} > {bar(bounces)} x {scale:.3e}"


# ---------------------------------------------------------------------------
# The analytic scene: every leaf of the material table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fd_scene_grads():
    """Both packages' gradients of every leaf, at bounces 0 (spp 2) and 2
    (spp 4), made once."""
    out = {}
    for bounces, spp in ((0, 2), (2, 4)):
        ref_fn, ref_m = ref_make_diff_render(fd_scene(rpt_tpu), fd_cam(rpt_tpu), width=W, height=H,
                                             max_bounces=bounces, spp=spp)
        fn, m0 = make_diff_render(fd_scene(rpt_tpu_torch), fd_cam(rpt_tpu_torch), width=W, height=H,
                                  max_bounces=bounces, spp=spp, device="cpu")
        out[bounces] = (port_grads(fn, m0), ref_grads(ref_fn, ref_m))
    return out


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("bounces", [0, 2])
def test_material_leaf_gradient_matches_reference(fd_scene_grads, bounces, field):
    got, want = fd_scene_grads[bounces][0][field], fd_scene_grads[bounces][1][field]
    assert got.shape == want.shape
    if field == "transparent":
        # Read only through a comparison: no gradient in either package.
        assert not np.any(want) and not np.any(got)
        return
    assert np.abs(want).max() > 0.0
    assert_grad_agrees(got, want, bounces, field)


def test_transmission_index_gradient_matches_reference():
    """The IOR of a clear sphere at bounces 3: the Fresnel and BTDF values
    are differentiated, the refracted directions are not."""
    ref_fn, ref_m = ref_make_diff_render(clear_scene(rpt_tpu), fd_cam(rpt_tpu), width=W, height=H, max_bounces=3,
                                         spp=4)
    fn, m0 = make_diff_render(clear_scene(rpt_tpu_torch), fd_cam(rpt_tpu_torch), width=W, height=H, max_bounces=3,
                              spp=4, device="cpu")
    want = np.asarray(jax.grad(lambda v: jnp.mean(ref_fn(dataclasses.replace(ref_m, index=v))))(ref_m.index))
    got = port_grads(fn, m0, ("index",))["index"]
    assert np.abs(want[0]) > 0.0  # the clear sphere's own IOR moves the image
    assert_grad_agrees(got, want, 3, "index")


def test_primal_equals_the_forward_renderer():
    """The differentiable path's image is `Renderer`'s mean image of the
    same seed and samples, bit for bit (the same keys, the same sums)."""
    fn, m0 = make_diff_render(fd_scene(rpt_tpu_torch), fd_cam(rpt_tpu_torch), width=W, height=H, max_bounces=2,
                              spp=3, seed=5, device="cpu")
    with torch.no_grad():
        img = fn(m0)
    r = rpt_tpu_torch.Renderer(fd_scene(rpt_tpu_torch), fd_cam(rpt_tpu_torch), width=W, height=H, max_bounces=2,
                               num_samples=3, seed=5, device="cpu")
    assert torch.equal(img, r.render_buffer().mean_image())


def level_cam(pkg):
    """`fd_cam` lowered to the sphere's height: look_at's and cast_rays'
    float32 camera arithmetic is then exact in both packages. On `fd_cam`'s
    tilted view XLA's FMA contraction of the camera's cross product puts
    the reference's float32 rays one ulp from the port's (see
    `tests/test_torch_f64.py`), and the float64 gradients 2.5e-8 to 7.7e-8
    of max|g| apart, which would hide float32 arithmetic."""
    return pkg.Camera.look_at([0.0, 0.0, 6.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], math.pi / 5)


F64_BAR = 1e-9


def test_float64_material_gradients_match_reference():
    """dtype float64 on both sides, the reference under jax_enable_x64: the
    x64 key, 64-bit draws and float64 arithmetic, held at a float64 bar
    (|g_port - g_ref| <= 1e-9 * max|g_ref|; measured 3.6e-14 at most)."""
    with jax.enable_x64(True):
        ref_fn, ref_m = ref_make_diff_render(fd_scene(rpt_tpu), level_cam(rpt_tpu), width=W, height=H,
                                             max_bounces=2, spp=2, seed=3, dtype=jnp.float64)
        want = ref_grads(ref_fn, ref_m)
    fn, m0 = make_diff_render(fd_scene(rpt_tpu_torch), level_cam(rpt_tpu_torch), width=W, height=H, max_bounces=2,
                              spp=2, seed=3, dtype=torch.float64, device="cpu")
    assert m0.color.dtype == torch.float64
    got = port_grads(fn, m0)
    for f in ("color", "index", "roughness", "metallic", "emittance"):
        assert want[f].dtype == np.float64 and got[f].dtype == np.float64
        scale = float(np.abs(want[f]).max())
        err = float(np.abs(got[f] - want[f]).max())
        print(f"grad-relative-error[float64 {f}, bounces=2]: {err / scale:.3e}")
        assert scale > 0.0 and np.isfinite(got[f]).all(), f
        assert err <= F64_BAR * scale, f"{f}: |g_port - g_ref| = {err:.3e} > {F64_BAR} x {scale:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("rows,width", [(4, 3), (5, None), (70, 3), (130, None)])
def test_material_gather_backward_sums_each_rows_hits(rows, width, dtype):
    """`MaterialTable.gather`'s backward (one-hot blocks of 64 rows, no
    atomics) against torch's own index backward: the same sums, to the
    rounding of another order."""
    from rpt_tpu_torch.materials import _RowGather

    gen = torch.Generator().manual_seed(rows)
    shape = (rows,) if width is None else (rows, width)
    table = torch.randn(shape, generator=gen, dtype=dtype, requires_grad=True)
    ids = torch.randint(0, rows, (5000,), generator=gen)
    g = torch.randn((5000,) + shape[1:], generator=gen, dtype=dtype)
    out = _RowGather.apply(table, ids)
    assert torch.equal(out, table[ids])
    (out * g).sum().backward()
    got = table.grad.clone()
    table.grad = None
    (table[ids] * g).sum().backward()
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    assert got.shape == table.shape
    assert float((got - table.grad).abs().max()) <= tol * float(table.grad.abs().max())


def test_make_diff_render_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_diff_render(fd_scene(rpt_tpu_torch), fd_cam(rpt_tpu_torch), width=4, height=4)
    fn, m0 = make_diff_render(fd_scene(rpt_tpu_torch), fd_cam(rpt_tpu_torch), width=4, height=4, device="cpu")
    assert fn(m0).device.type == "cpu"


def test_material_render_fn_is_cached_per_scene_and_size():
    sd = fd_scene(rpt_tpu_torch).compile(device="cpu")
    fn = make_material_render_fn(sd, W, H, 1, 2)
    assert make_material_render_fn(sd, W, H, 1, 2) is fn
    assert make_material_render_fn(sd, W, H, 1, 3) is not fn


# ---------------------------------------------------------------------------
# Meshes: the traversal walks on the path, their hits carry no gradient
# ---------------------------------------------------------------------------


def trefoil_scenes():
    """The `dragon` workload with a 5,000-triangle trefoil (16x12, 2
    bounces): the JAX example's builder and the port's copy of it."""
    sys.path.insert(0, EXAMPLES)
    import dragon

    ref = dragon.build_scene(target_tris=5000)
    cam = rpt_tpu.Camera.look_at((-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)
    return (ref, cam), (build_dragon_scene(segments=125, sides=20), dragon_camera())


@pytest.fixture(scope="module")
def trefoil_ref_grads():
    """The reference's gradient on the trefoil. On the CPU its walk is its
    XLA loop whatever the kernel choice, so one gradient serves both."""
    (ref, cam), _ = trefoil_scenes()
    fn, m0 = ref_make_diff_render(ref, cam, width=16, height=12, max_bounces=2, spp=1)
    return ref_grads(fn, m0)


@pytest.mark.parametrize("field", ["color", "roughness"])
@pytest.mark.parametrize("family", ["bvh8", "bvh2"])
def test_trefoil_material_gradients_match_reference(trefoil_ref_grads, monkeypatch, family, field):
    """Through the wide walk (the kernel threshold lowered below the
    trefoil's rows) and through the binary walk (RPT_BVH_KERNEL=binary)."""
    if family == "bvh8":
        monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 4096)
    else:
        monkeypatch.setattr(scene_mod, "_BVH_KERNEL", "binary")
    _, (scene, cam) = trefoil_scenes()
    fn, m0 = make_diff_render(scene, cam, width=16, height=12, max_bounces=2, spp=1, device="cpu")
    sd = scene.compile(device="cpu")
    assert sd.mesh_pack.library == family and sd.bvh.num_tris >= 5000
    want = trefoil_ref_grads[field]
    assert np.abs(want).max() > 0.0
    assert_grad_agrees(port_grads(fn, m0, (field,))[field], want, 2, f"{family} {field}")


@pytest.fixture(scope="module")
def city_grads():
    sys.path.insert(0, EXAMPLES)
    import lego

    ref = lego.build_brick_city(n_instances=96)
    cam = rpt_tpu.Camera.look_at((18.0, 14.0, 26.0), (0.0, 4.0, 0.0), (0.0, 1.0, 0.0), math.pi / 5)
    ref_fn, ref_m = ref_make_diff_render(ref, cam, width=16, height=12, max_bounces=2, spp=1)
    scene = build_brick_city(n_instances=96)
    fn, m0 = make_diff_render(scene, lego_camera(), width=16, height=12, max_bounces=2, spp=1, device="cpu")
    assert scene.compile(device="cpu").instance_pack.library == "tlas8"
    return port_grads(fn, m0, ("color", "roughness")), ref_grads(ref_fn, ref_m)


@pytest.mark.parametrize("field", ["color", "roughness"])
def test_brick_city_material_gradients_match_reference(city_grads, field):
    """96 instances, 39 materials, through the two-level wide walk."""
    got, want = city_grads[0][field], city_grads[1][field]
    assert np.count_nonzero(want) > 10
    assert_grad_agrees(got, want, 2, field)
