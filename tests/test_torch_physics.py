"""Per-ray physics of the port against the JAX package on the same inputs.

Inputs come from numpy seeds; random draws come from the same threefry keys
on both sides (the port's PRNG is bit-exact). XLA on the CPU contracts some
multiply-adds into FMAs where torch does not, so results agree to rtol 1e-5
rather than bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch
from rpt_tpu import materials as ref_mat
from rpt_tpu.ops import intersect as ref_ops
from rpt_tpu_torch import materials as port_mat
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch.ops import intersect as port_ops
from test_torch_reference_native import reference_native

reference_native()

RTOL = 1e-5


def t(x):
    return torch.as_tensor(np.array(x))


def close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("aperture", [0.0, 0.2])
def test_cast_rays(aperture):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 500).astype(np.float32)
    y = rng.uniform(-1, 1, 500).astype(np.float32)
    args = ((-2.5, 4.0, 6.5), (0.0, -0.25, 0.0), (0.0, 1.0, 0.0), math.pi / 4)
    ref_cam = rpt_tpu.Camera.look_at(*args).focus((0.0, 0.0, 0.0), aperture)
    port_cam = rpt_tpu_torch.Camera.look_at(*args).focus((0.0, 0.0, 0.0), aperture)
    for f in ("eye", "direction", "up", "fov", "aperture", "focal_distance"):
        close(getattr(port_cam, f), getattr(ref_cam, f))
    o_r, d_r = ref_cam.cast_rays(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(3))
    o_p, d_p = port_cam.cast_rays(t(x), t(y), rnd.PRNGKey(3))
    close(o_p, o_r, atol=1e-5)
    close(d_p, d_r)


MATERIALS = [
    ("diffuse", lambda m: m.diffuse((0.6, 0.3, 0.2))),
    ("specular", lambda m: m.specular((0.2, 0.7, 0.4), 0.3)),
    ("clear", lambda m: m.clear(1.5, 0.05)),
    ("metallic", lambda m: m.metallic_mat((0.9, 0.8, 0.5), 0.2)),
    ("colored_glass", lambda m: m.transparent_colored((0.8, 0.9, 1.0), 1.33, 0.4)),
]


def _mat_params(n, make):
    ref = ref_mat.MaterialTable.pack([make(ref_mat.Material)]).gather(jnp.zeros(n, jnp.int32))
    port = port_mat.MaterialTable.pack([make(port_mat.Material)]).gather(torch.zeros(n, dtype=torch.int32))
    return ref, port


@pytest.mark.parametrize("name,make", MATERIALS, ids=[m[0] for m in MATERIALS])
def test_bsdf_and_sample_f(name, make):
    rng = np.random.default_rng(1)
    n = 400
    nrm, wo, wi = unit(rng, n), unit(rng, n), unit(rng, n)
    ref, port = _mat_params(n, make)
    for f in ("color", "index", "roughness", "metallic", "emittance", "transparent"):
        close(getattr(port, f), getattr(ref, f))
    close(port_mat.bsdf(port, t(nrm), t(wo), t(wi)),
          ref_mat.bsdf(ref, jnp.asarray(nrm), jnp.asarray(wo), jnp.asarray(wi)), atol=1e-5)
    wi_r, pdf_r, valid_r = ref_mat.sample_f(jax.random.PRNGKey(5), ref, jnp.asarray(nrm), jnp.asarray(wo))
    wi_p, pdf_p, valid_p = port_mat.sample_f(rnd.PRNGKey(5), port, t(nrm), t(wo))
    np.testing.assert_array_equal(valid_p.numpy(), np.asarray(valid_r))
    close(wi_p, wi_r, atol=1e-5)
    # The specular pdf normalizes wi + wo, which cancels when wi is nearly
    # -wo: there the last-bit differences of the two packages' f32 grow to
    # 1e-2. Hold 99% of the samples, and every sample off that cone, to 1e-5.
    ok = np.isclose(pdf_p.numpy(), np.asarray(pdf_r), rtol=RTOL, atol=1e-5)
    assert ok.mean() >= 0.99
    assert ok[np.sum(np.asarray(wi_r) * wo, axis=-1) > -0.9999].all()


def _light_scene(pkg):
    scene = pkg.Scene()
    scene.add(pkg.Object(pkg.sphere()))
    scene.add(pkg.PointLight((1.0, 0.8, 0.6), (1.0, 3.0, -2.0)))
    scene.add(pkg.DirectionalLight((0.5, 0.5, 0.5), (0.3, -1.0, 0.2)))
    scene.add(pkg.AmbientLight((0.01, 0.02, 0.03)))
    scene.add(pkg.ObjectLight(pkg.Object(pkg.sphere().scale([0.5, 0.7, 0.5]).translate([0.0, 4.0, 1.0]))
                              .material(pkg.Material.light((1.0, 1.0, 1.0), 20.0))))
    scene.add(pkg.ObjectLight(pkg.Object(pkg.cube().scale([2.0, 0.1, 1.0]).rotate_y(0.3).translate([1.0, 5.0, 0.0]))
                              .material(pkg.Material.light((1.0, 0.9, 0.8), 10.0))))
    scene.add(pkg.ObjectLight(pkg.Object(pkg.polygon([[-1, 6, -1], [1, 6, -1], [1, 6, 1], [-1, 6, 1]]))
                              .material(pkg.Material.light((0.9, 0.9, 1.0), 5.0))))
    return scene


def test_lights_illuminate():
    rng = np.random.default_rng(2)
    pos = rng.uniform(-2.0, 2.0, (300, 3)).astype(np.float32)
    ref_lights = _light_scene(rpt_tpu).compile().to_device().lights
    port_lights = _light_scene(rpt_tpu_torch).compile(device="cpu").lights
    assert [type(l).__name__ for l in port_lights] == [type(l).__name__ for l in ref_lights]
    for i, (rl, pl) in enumerate(zip(ref_lights, port_lights)):
        if isinstance(pl, rpt_tpu_torch.lights.AmbientLightData):
            close(pl.color, rl.color)
            continue
        want = rl.illuminate(jax.random.fold_in(jax.random.PRNGKey(9), i), jnp.asarray(pos))
        got = pl.illuminate(rnd.fold_in(rnd.PRNGKey(9), i), t(pos))
        for g, w in zip(got, want):
            close(g, w, atol=1e-5)


def _prims(rng, kind, p):
    """Random primitives of one kind as (reference arrays, port tensors,
    a point on each primitive to aim rays at)."""
    mat = rng.integers(0, 5, p).astype(np.int32)
    if kind in ("spheres", "cubes"):
        m = np.tile(np.eye(4), (p, 1, 1))
        m[:, :3, :3] = rng.uniform(-1.0, 1.0, (p, 3, 3)) + 2.0 * np.eye(3)
        m[:, :3, 3] = rng.uniform(-3.0, 3.0, (p, 3))
        inv = np.linalg.inv(m)[:, :3, :]
        nmat = np.transpose(np.linalg.inv(m[:, :3, :3]), (0, 2, 1))
        arrays = (inv.astype(np.float32), nmat.astype(np.float32), mat)
        aim = m[:, :3, 3]
    elif kind == "planes":
        arrays = (unit(rng, p), rng.uniform(-3.0, 3.0, p).astype(np.float32), mat)
        aim = np.zeros((p, 3))
    else:
        base = rng.uniform(-2.0, 2.0, (p, 1, 3))
        verts = np.concatenate([base, base + rng.uniform(-1.0, 1.0, (p, 2, 3))], axis=1).astype(np.float32)
        norms = np.stack([unit(rng, p)] * 3, axis=1)
        arrays = (verts, norms, mat)
        aim = verts.mean(axis=1)
    return tuple(jnp.asarray(a) for a in arrays), tuple(t(a) for a in arrays), aim


@pytest.mark.parametrize("kind", ["spheres", "planes", "cubes", "triangles"])
def test_analytic_intersect_and_occluded(kind):
    rng = np.random.default_rng(3)
    n, p = 600, 12
    ref_a, port_a, aim = _prims(rng, kind, p)
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    d = unit(rng, n)
    # Aim half of the rays at the primitives so many of them hit something.
    to = aim[rng.integers(0, p, n // 2)] - o[: n // 2]
    d[: n // 2] = to / np.linalg.norm(to, axis=-1, keepdims=True)
    t_min = 1e-3
    hit_r = getattr(ref_ops, f"intersect_{kind}")(jnp.asarray(o), jnp.asarray(d), t_min, *ref_a)
    hit_p = getattr(port_ops, f"intersect_{kind}")(t(o), t(d), t_min, *port_a)
    found = np.isfinite(np.asarray(hit_r.t))
    assert 0.2 < found.mean() < 1.0
    np.testing.assert_array_equal(np.isfinite(hit_p.t.numpy()), found)
    np.testing.assert_array_equal(hit_p.mat_id.numpy()[found], np.asarray(hit_r.mat_id)[found])
    close(hit_p.t.numpy()[found], np.asarray(hit_r.t)[found], atol=1e-5)
    close(hit_p.normal.numpy()[found], np.asarray(hit_r.normal)[found], atol=1e-5)

    t_max = rng.uniform(0.5, 8.0, n).astype(np.float32)
    occ_r = getattr(ref_ops, f"occluded_{kind}")(jnp.asarray(o), jnp.asarray(d), t_min, jnp.asarray(t_max), *ref_a)
    occ_p = getattr(port_ops, f"occluded_{kind}")(t(o), t(d), t_min, t(t_max), *port_a)
    np.testing.assert_array_equal(occ_p.numpy(), np.asarray(occ_r))
    # And the any-hit query is the closest hit compared once.
    np.testing.assert_array_equal(occ_p.numpy(), hit_p.t.numpy() <= t_max)


def test_merge_hits_keeps_the_first_on_a_tie():
    a = port_ops.Hit(t=t([1.0, 2.0]), normal=torch.zeros(2, 3), mat_id=torch.tensor([1, 1], dtype=torch.int32))
    b = port_ops.Hit(t=t([1.0, 1.5]), normal=torch.ones(2, 3), mat_id=torch.tensor([2, 2], dtype=torch.int32))
    m = port_ops.merge_hits(a, b)
    assert m.mat_id.tolist() == [1, 2]
