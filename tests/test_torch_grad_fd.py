"""Camera gradients, the detached estimator, the reference's tie rules and
finite differences of the port's differentiable rendering
(`rpt_tpu_torch.grad`).

- Camera gradients against the JAX package's `jax.grad` on its two
  edge-free views (`tests/test_grad_fd.py`, `tests/test_parallel_grad.py`),
  to 1e-4 * max|g_ref| at bounces 0 and 1e-3 * max|g_ref| above; through a
  mesh both packages refuse them (the walks give no dt/d(ray)).
- The estimator detaches the sampled direction and pdf, as the reference
  does: left attached, the roughness gradient at bounces 2 is another one.
- Ties take the reference's rule: its `jnp.minimum/maximum/clip` give half
  the gradient at a tie and `jnp.abs` +1 at 0, where torch.clamp gives all
  of it and torch.abs 0.
- The finite-difference checks of `tests/test_grad_fd.py` at bounces 0
  and its color check at 64 spp, and `TestGradients` of
  `tests/test_parallel_grad.py` on one device, through the port alone.
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
import rpt_tpu.integrator as ref_integrator
import rpt_tpu.materials as ref_materials
import rpt_tpu_torch
from rpt_tpu.grad import make_diff_render as ref_make_diff_render
from rpt_tpu.grad import make_material_render_fn as ref_make_material_render_fn
from rpt_tpu.renderer import pixel_ndc_tiled as ref_pixel_ndc_tiled
from rpt_tpu_torch import integrator, materials
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch.grad import make_diff_render, make_material_render_fn, render_with_camera
from rpt_tpu_torch.materials import MaterialTable
from rpt_tpu_torch.ops import scatter as scatter_mod
from rpt_tpu_torch.scenes import build_dragon_scene, dragon_camera
from rpt_tpu_torch.utils import vmath
from test_torch_grad import W, H, assert_grad_agrees, bar, fd_cam, fd_scene, port_grads
from test_torch_reference_native import reference_native
from test_torch_render import EXAMPLES

reference_native()


def plane_scene(pkg):
    """`tests/test_parallel_grad.py`'s edge-free scene: a plane fills the view."""
    s = pkg.Scene()
    s.add(pkg.Object(pkg.plane([0.0, 0.0, 1.0], 0.0)).material(pkg.Material.diffuse((0.7, 0.5, 0.3))))
    s.add(pkg.PointLight((30.0, 30.0, 30.0), (3.0, 6.0, 6.0)))
    return s


def simple_scene(pkg):
    """`tests/test_parallel_grad.py` `simple_scene()`."""
    s = pkg.Scene()
    s.add(pkg.Object(pkg.sphere()).material(pkg.Material.diffuse((0.7, 0.3, 0.2))))
    s.add(pkg.Object(pkg.plane([0.0, 1.0, 0.0], -1.0)).material(pkg.Material.diffuse((0.6, 0.6, 0.6))))
    s.add(pkg.PointLight((30.0, 30.0, 30.0), (3.0, 6.0, 3.0)))
    return s


def simple_cam(pkg):
    return pkg.Camera.look_at([0.0, 2.0, 8.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 0.7)


# The two edge-free views: (scene, look_at arguments, bounces, spp, loss
# weighted along x). The floor beside the sphere is `test_grad_fd.py`'s
# camera view (its 128 spp cut to 4: both packages draw the same samples).
VIEWS = {
    "floor_beside_sphere": (fd_scene, ([2.5, 1.5, 5.0], [3.5, -1.0, 0.0], [0.0, 1.0, 0.0], math.pi / 7), 2, 4, False),
    "plane_fills_view": (plane_scene, ([0.0, 2.0, 8.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 0.7), 0, 1, True),
}
CAMERA_FIELDS = ("eye", "direction", "fov")


# ---------------------------------------------------------------------------
# Camera gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("view", list(VIEWS))
def test_camera_gradient_matches_reference(view):
    """d loss / d (eye, direction, fov) on an analytic scene: through
    `cast_rays`, the sphere and plane hits, the lights and the BSDF."""
    scene_of, look, bounces, spp, weighted = VIEWS[view]
    sd = scene_of(rpt_tpu).compile()
    cam0 = rpt_tpu.Camera.look_at(*look)
    fn = ref_make_material_render_fn(sd, W, H, bounces, spp)
    wgt = jnp.linspace(0.0, 1.0, W)[None, :, None] if weighted else 1.0

    def ref_loss(fields):
        cam = dataclasses.replace(cam0, **fields)
        return jnp.mean(fn(sd.materials, cam, jax.random.PRNGKey(0), jnp.float32(1e-3), jnp.float32(1.0)) * wgt)

    want = jax.grad(ref_loss)({f: getattr(cam0, f) for f in CAMERA_FIELDS})

    psd = scene_of(rpt_tpu_torch).compile(device="cpu")
    pcam0 = rpt_tpu_torch.Camera.look_at(*look)
    fields = {f: getattr(pcam0, f).detach().clone().requires_grad_() for f in CAMERA_FIELDS}
    cam = dataclasses.replace(pcam0, **fields)
    assert all(getattr(cam, f) is fields[f] for f in CAMERA_FIELDS)  # the camera keeps the leaves
    img = render_with_camera(cam, psd, rnd.PRNGKey(0), W, H, bounces, 1e-3, 1.0, spp=spp)
    pwgt = torch.linspace(0.0, 1.0, W)[None, :, None] if weighted else 1.0
    torch.mean(img * pwgt).backward()
    for f in CAMERA_FIELDS:
        w = np.asarray(want[f])
        assert np.abs(w).max() > 0.0, f
        assert_grad_agrees(fields[f].grad.numpy(), w, bounces, f"{view} {f}")


def test_camera_leaf_of_another_type_keeps_its_gradient():
    """`Camera` holds float32 fields; a float64 leaf is cast on the graph,
    so its gradient comes back in float64."""
    psd = plane_scene(rpt_tpu_torch).compile(device="cpu")
    pcam0 = rpt_tpu_torch.Camera.look_at(*VIEWS["plane_fills_view"][1])
    eye = pcam0.eye.to(torch.float64).requires_grad_()
    cam = dataclasses.replace(pcam0, eye=eye)
    assert cam.eye.dtype == torch.float32
    torch.mean(render_with_camera(cam, psd, rnd.PRNGKey(0), 8, 6, 0, 1e-3, 1.0)).backward()
    assert eye.grad is not None and eye.grad.dtype == torch.float64 and torch.isfinite(eye.grad).all()
    assert float(eye.grad.abs().max()) > 0.0


def trefoil(pkg_ref: bool):
    sys.path.insert(0, EXAMPLES)
    import dragon

    if pkg_ref:
        cam = rpt_tpu.Camera.look_at((-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)
        return dragon.build_scene(target_tris=5000), cam
    return build_dragon_scene(segments=125, sides=20), dragon_camera()


def test_camera_gradient_through_a_mesh_raises_in_both_packages():
    """Reverse mode through the reference's BVH loop raises; the port's walk
    refuses rays that require grad rather than drop dt/d(camera)."""
    scene, cam0 = trefoil(True)
    sd = scene.compile()
    fn = ref_make_material_render_fn(sd, 8, 6, 0, 1)

    def ref_loss(eye):
        cam = dataclasses.replace(cam0, eye=eye)
        return jnp.mean(fn(sd.materials, cam, jax.random.PRNGKey(0), jnp.float32(1e-3), jnp.float32(1.0)))

    with pytest.raises(ValueError, match="while_loop"):
        jax.grad(ref_loss)(cam0.eye)

    scene, cam0 = trefoil(False)
    psd = scene.compile(device="cpu")
    assert psd.bvh is not None
    eye = cam0.eye.detach().clone().requires_grad_()
    cam = dataclasses.replace(cam0, eye=eye)
    with pytest.raises(ValueError, match="require grad"):
        render_with_camera(cam, psd, rnd.PRNGKey(0), 8, 6, 0, 1e-3, 1.0)
    # Without autograd the same camera renders; material gradients need no ray gradient.
    with torch.no_grad():
        assert torch.isfinite(render_with_camera(cam, psd, rnd.PRNGKey(0), 8, 6, 0, 1e-3, 1.0)).all()
    color = psd.materials.color.detach().clone().requires_grad_()
    mats = dataclasses.replace(psd.materials, color=color)
    torch.mean(make_material_render_fn(psd, 8, 6, 0, 1)(mats, cam0, rnd.PRNGKey(0), 1e-3, 1.0)).backward()
    assert float(color.grad.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# The detached estimator
# ---------------------------------------------------------------------------


def test_attached_samples_give_another_roughness_gradient(monkeypatch):
    """At bounces 2 the sampled directions depend on the roughness. Detached,
    as in the reference, the port's gradient is the reference's; left
    attached (the fault this port had) it is not."""
    ref_fn, ref_m = ref_make_diff_render(fd_scene(rpt_tpu), fd_cam(rpt_tpu), width=W, height=H, max_bounces=2, spp=4)
    want = np.asarray(jax.grad(lambda r: jnp.mean(ref_fn(dataclasses.replace(ref_m, roughness=r))))(ref_m.roughness))
    fn, m0 = make_diff_render(fd_scene(rpt_tpu_torch), fd_cam(rpt_tpu_torch), width=W, height=H, max_bounces=2,
                              spp=4, device="cpu")
    detached = port_grads(fn, m0, ("roughness",))["roughness"]
    assert_grad_agrees(detached, want, 2, "roughness")
    monkeypatch.setattr(scatter_mod, "stop_gradient", lambda x: x)
    attached = port_grads(fn, m0, ("roughness",))["roughness"]
    err = float(np.abs(attached - want).max())
    assert err > 10 * bar(2) * float(np.abs(want).max()), f"attached samples moved the gradient by only {err:.3e}"


# ---------------------------------------------------------------------------
# Tie rules
# ---------------------------------------------------------------------------


TIES = {
    "clip_at_lo": (lambda x: vmath.clip(x, 0.0, 1.0), lambda x: jnp.clip(x, 0.0, 1.0), 0.0),
    "clip_at_hi": (lambda x: vmath.clip(x, 0.0, 1.0), lambda x: jnp.clip(x, 0.0, 1.0), 1.0),
    "maximum": (lambda x: vmath.maximum(x, 1e-12), lambda x: jnp.maximum(x, 1e-12), 1e-12),
    "minimum": (lambda x: vmath.minimum(x, 100.0), lambda x: jnp.minimum(x, 100.0), 100.0),
    "absolute": (vmath.absolute, jnp.abs, 0.0),
}


@pytest.mark.parametrize("name", list(TIES))
def test_helpers_take_the_reference_tie_rule(name):
    """At the tie, below, above and at NaN: torch.clamp's / torch.abs's
    values, the reference's gradient."""
    port, ref, tie = TIES[name]
    t = float(np.float32(tie))
    xs = np.array([t, t - 0.25, t + 0.25, -3.0, 3.0, np.nan], np.float32)
    x = torch.tensor(xs, requires_grad=True)
    y = port(x)
    y.sum().backward()
    want_y = np.asarray(ref(jnp.asarray(xs)))
    want_g = np.asarray(jax.vmap(jax.grad(ref))(jnp.asarray(xs)))
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(x.grad.numpy(), want_g)
    with torch.no_grad():  # nothing recorded: the same values
        np.testing.assert_array_equal(port(torch.tensor(xs)).numpy(), want_y)


def test_roughness_at_its_clip_bound_takes_the_reference_rule():
    """roughness 1e-6: roughness^2 is float32(1e-12) exactly, the bound of
    `m2 = maximum(roughness^2, 1e-12)`, in both packages. The BSDF's
    roughness gradient is then half what it is one ulp above."""
    rng = np.random.default_rng(4)
    n = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (64, 1))
    wo = rng.normal(size=(64, 3)).astype(np.float32)
    wo[:, 1] = np.abs(wo[:, 1]) + 0.2
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi = rng.normal(size=(64, 3)).astype(np.float32)
    wi[:, 1] = np.abs(wi[:, 1]) + 0.2
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    r_tie = np.float32(1e-6)
    assert np.float32(r_tie * r_tie) == np.float32(1e-12)

    def ref_grad(r):
        def f(rough):
            mat = ref_materials.MatParams(color=jnp.full((64, 3), 0.5, jnp.float32), index=jnp.full(64, 1.5),
                                          roughness=jnp.full(64, 1.0) * rough, metallic=jnp.zeros(64),
                                          emittance=jnp.zeros(64), transparent=jnp.zeros(64))
            return jnp.sum(ref_materials.bsdf(mat, jnp.asarray(n), jnp.asarray(wo), jnp.asarray(wi)))
        return float(jax.grad(f)(jnp.float32(r)))

    rough = torch.tensor(r_tie, requires_grad=True)
    mat = materials.MatParams(color=torch.full((64, 3), 0.5), index=torch.full((64,), 1.5),
                              roughness=torch.ones(64) * rough, metallic=torch.zeros(64),
                              emittance=torch.zeros(64), transparent=torch.zeros(64))
    materials.bsdf(mat, torch.as_tensor(n), torch.as_tensor(wo), torch.as_tensor(wi)).sum().backward()
    want = ref_grad(r_tie)
    above = ref_grad(np.nextafter(r_tie, np.float32(1)))
    assert want != 0.0 and math.isclose(above / want, 2.0, rel_tol=1e-3)
    assert math.isclose(float(rough.grad), want, rel_tol=1e-5)


class _RecordingNumpy:
    """`jax.numpy` with `minimum`'s first argument recorded (the reference's
    firefly fold is its one `jnp.minimum`)."""

    def __init__(self, seen: list):
        self._seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def minimum(self, x, c):
        self._seen.append(np.asarray(x))
        return jnp.minimum(x, c)


def test_firefly_tie_takes_the_reference_rule(monkeypatch):
    """The firefly fold `minimum(w * L, clamp)` with the clamp set exactly to
    one lane's product, the same float in both packages: the lane takes half
    the gradient, as in the reference (torch.clamp would give it all)."""
    ref_sd = fd_scene(rpt_tpu).compile()
    psd = fd_scene(rpt_tpu_torch).compile(device="cpu")
    key = jax.random.PRNGKey(3)
    xg, yg, _, _ = ref_pixel_ndc_tiled(W, H)
    o, d = fd_cam(rpt_tpu).cast_rays(xg, yg, jax.random.fold_in(key, 1))
    ot, dt = torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d))
    k = jax.random.fold_in(key, 2)

    def ref_radiance(color, clamp):
        sd = dataclasses.replace(ref_sd, materials=dataclasses.replace(ref_sd.materials, color=color))
        return ref_integrator.trace_paths(sd, o, d, k, 1, 1e-3, firefly_clamp=clamp)

    def port_radiance(color, clamp):
        sd = dataclasses.replace(psd, materials=dataclasses.replace(psd.materials, color=color))
        return integrator.trace_paths(sd, ot, dt, np.asarray(k), 1, 1e-3, firefly_clamp=clamp)

    # Each package's products w * L, recorded at its fold.
    ref_seen, port_seen = [], []
    with monkeypatch.context() as m:
        m.setattr(ref_integrator, "jnp", _RecordingNumpy(ref_seen))
        ref_radiance(ref_sd.materials.color, float("inf"))

        def recording_minimum(x, c):
            port_seen.append(x.detach().numpy().copy())
            return vmath.minimum(x, c)

        m.setattr(integrator, "minimum", recording_minimum)
        with torch.no_grad():
            port_radiance(psd.materials.color, float("inf"))
    (ref_p,), (port_p,) = ref_seen, port_seen
    same = (ref_p == port_p) & (port_p > 0.0)
    assert same.any()
    clamp = float(np.max(port_p[same]))
    assert np.count_nonzero(port_p == clamp) == 1

    # Eager, as recorded: under jit XLA fuses w and L into FMAs and may round
    # the product apart from the recorded one.
    grad_ref = jax.grad(lambda c, cl: jnp.sum(ref_radiance(c, cl)))
    want = np.asarray(grad_ref(ref_sd.materials.color, jnp.float32(clamp)))

    def port_grad(cl):
        color = psd.materials.color.detach().clone().requires_grad_()
        port_radiance(color, cl).sum().backward()
        return color.grad.numpy()

    got = port_grad(clamp)
    assert_grad_agrees(got, want, 1, "color at the firefly tie")
    # One ulp above, nothing is clamped and the lane takes its whole
    # gradient: the half the tie rule keeps is far outside the bar.
    whole = port_grad(float(np.nextafter(np.float32(clamp), np.float32(np.inf))))
    assert float(np.abs(whole - want).max()) > 10 * bar(1) * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# Finite differences (`tests/test_grad_fd.py`), through the port alone
# ---------------------------------------------------------------------------


def _fd_vs_grad(field, bounces, spp, eps, atol):
    img_fn, mats0 = make_diff_render(fd_scene(rpt_tpu_torch), fd_cam(rpt_tpu_torch), width=W, height=H,
                                     max_bounces=bounces, spp=spp, device="cpu")

    def loss_from(v):
        return torch.mean(img_fn(dataclasses.replace(mats0, **{field: v})))

    v0 = getattr(mats0, field)
    leaf = v0.detach().clone().requires_grad_()
    loss_from(leaf).backward()
    g = leaf.grad.numpy().ravel()
    base = v0.numpy().astype(np.float64)
    flat = base.ravel()
    fd = np.zeros_like(flat)
    with torch.no_grad():
        for i in range(flat.shape[0]):
            vp, vm = flat.copy(), flat.copy()
            vp[i] += eps
            vm[i] -= eps
            lp = float(loss_from(torch.as_tensor(vp.reshape(base.shape), dtype=v0.dtype)))
            lm = float(loss_from(torch.as_tensor(vm.reshape(base.shape), dtype=v0.dtype)))
            fd[i] = (lp - lm) / (2 * eps)
    scale = max(np.abs(fd).max(), 1e-6)
    l2_err = float(np.linalg.norm(g - fd) / max(np.linalg.norm(fd), 1e-12))
    np.testing.assert_allclose(g / scale, fd / scale, atol=atol)
    return l2_err


@pytest.mark.parametrize("field", ["roughness", "metallic", "index", "emittance"])
def test_material_gradients_match_fd_direct(field):
    assert _fd_vs_grad(field, bounces=0, spp=2, eps=1e-2, atol=0.05) < 0.1


def test_color_gradient_matches_fd_with_bounces():
    """Albedo with metallic 0: the sampled directions do not depend on the
    color, so the detached estimator and the FD agree at 64 spp."""
    assert _fd_vs_grad("color", bounces=2, spp=64, eps=1e-2, atol=0.1) < 0.2


# ---------------------------------------------------------------------------
# `tests/test_parallel_grad.py` `TestGradients`, on one device
# ---------------------------------------------------------------------------


class TestGradients:
    def test_albedo_gradient_matches_fd(self):
        img_fn, mats0 = make_diff_render(simple_scene(rpt_tpu_torch), simple_cam(rpt_tpu_torch), width=12, height=8,
                                         max_bounces=0, spp=2, device="cpu")

        def loss(color):
            return torch.mean(img_fn(dataclasses.replace(mats0, color=color)))

        c = mats0.color.detach().clone().requires_grad_()
        loss(c).backward()
        g = c.grad.numpy()
        eps = 1e-2
        base = mats0.color.numpy()
        fd = np.zeros_like(base)
        with torch.no_grad():
            for i in range(base.shape[0]):
                for j in range(3):
                    cp, cm = base.copy(), base.copy()
                    cp[i, j] += eps
                    cm[i, j] -= eps
                    fd[i, j] = (float(loss(torch.as_tensor(cp))) - float(loss(torch.as_tensor(cm)))) / (2 * eps)
        scale = max(np.abs(fd).max(), 1e-6)
        np.testing.assert_allclose(g / scale, fd / scale, atol=0.05)

    def test_emittance_gradient_direction(self):
        scene = rpt_tpu_torch.Scene()
        scene.add(rpt_tpu_torch.Object(rpt_tpu_torch.sphere()).material(rpt_tpu_torch.Material.light((1.0, 1.0, 1.0),
                                                                                                    2.0)))
        img_fn, mats0 = make_diff_render(scene, rpt_tpu_torch.Camera(), width=8, height=8, max_bounces=0, spp=1,
                                         device="cpu")
        e = mats0.emittance.detach().clone().requires_grad_()
        torch.mean(img_fn(dataclasses.replace(mats0, emittance=e))).backward()
        assert float(e.grad[0]) > 0.0

    def test_indirect_bounce_gradient_finite(self):
        img_fn, mats0 = make_diff_render(simple_scene(rpt_tpu_torch), simple_cam(rpt_tpu_torch), width=8, height=6,
                                         max_bounces=2, spp=1, device="cpu")
        m = {f.name: getattr(mats0, f.name).detach().clone().requires_grad_()
             for f in dataclasses.fields(MaterialTable)}
        torch.mean(img_fn(MaterialTable(**m))).backward()
        for name, leaf in m.items():
            assert leaf.grad is None if name == "transparent" else bool(torch.isfinite(leaf.grad).all()), name

    def test_camera_gradient_matches_fd(self):
        scene_data = plane_scene(rpt_tpu_torch).compile(device="cpu")
        key = rnd.PRNGKey(0)
        wgt = torch.linspace(0.0, 1.0, 12)[None, :, None]

        def loss_eye(eye):
            c = dataclasses.replace(simple_cam(rpt_tpu_torch), eye=eye)
            return torch.mean(render_with_camera(c, scene_data, key, 12, 8, 0, 1e-3, 1.0, spp=1) * wgt)

        eye0 = simple_cam(rpt_tpu_torch).eye
        eye = eye0.detach().clone().requires_grad_()
        loss_eye(eye).backward()
        g = eye.grad.numpy()
        eps = 1e-2
        fd = np.zeros(3)
        with torch.no_grad():
            for j in range(3):
                ep, em = eye0.numpy().copy(), eye0.numpy().copy()
                ep[j] += eps
                em[j] -= eps
                fd[j] = (float(loss_eye(torch.as_tensor(ep))) - float(loss_eye(torch.as_tensor(em)))) / (2 * eps)
        scale = max(np.abs(fd).max(), 1e-8)
        np.testing.assert_allclose(g / scale, fd / scale, atol=0.08)
