"""float64 renders of the port against the JAX package's under x64.

The JAX package renders in float64 only under `jax_enable_x64`, which its
own tests never turn on; here every reference call runs inside
`jax.enable_x64(True)`. Under x64 three things change in the reference, and
the port's float64 path does the same:

- every draw left at JAX's default type takes 64 random bits: a float64
  `uniform` (52 mantissa bits of `bits1 << 32 | bits2`), an int64 `randint`
  and `bernoulli` on a float64 uniform; an int seed makes a 64-bit key.
  `split` and `fold_in` do not change;
- its Pallas kernels do not trace (a dtype `TypeError` in the shifts), so
  every float64 render walks its XLA loops (`bvh_closest_hit`,
  `instanced_closest_hit`), which the port's float64 walks are held to;
- its wavefront sorts round the sorted columns through float32
  (`_gather_packed`), so a morton render is not the masked one, and each
  order is held against the reference's same order.

Bars. The draws are bit for bit. The hits of the four walk families: hit
mask and material exact except on at most 0.1% of rays (shared edges), `t`
to rtol 1e-12 (measured: 1.3e-15 relative at most, every hit mask equal).
The renders: the f32 render bar of `tests/test_torch_render.py` is rtol
1e-3 / atol 1e-4 on 99% of pixels and the image mean to 1e-3 relative. In
float64 the two packages part only where the camera's float32 fields meet
(XLA contracts the float32 cross product of the camera's right vector, one
float32 ulp away on the look-at cameras) and in summation order. Measured at
32x24, 1 spp, on all five scenes in both orders: every pixel within rtol
1e-5 / atol 1e-7 (the worst 6.2e-7 off, on the sphere; the cornell box and
the trefoil within 5e-13), the image means within 8.6e-9 relative. The bar
here is rtol 1e-5 / atol 1e-7 on 99.5% of pixels and the mean to 1e-7
relative: 100x and 10,000x tighter than the f32 bar, with a margin of 0.5%
of pixels and 10x on the mean.
"""

import math
import sys

import jax
import numpy as np
import pytest
import torch

import rpt_tpu
import rpt_tpu_torch
from rpt_tpu.ops.bvh import build_bvh as ref_build_bvh
from rpt_tpu.ops.bvh import bvh_closest_hit as ref_bvh_closest_hit
from rpt_tpu.ops.tlas import build_instanced as ref_build_instanced
from rpt_tpu.ops.tlas import instanced_closest_hit as ref_instanced_closest_hit
from rpt_tpu_torch import Buffer, convert
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch import renderer as renderer_mod
from rpt_tpu_torch.ops import bvh2, bvh8, tlas2, tlas8
from rpt_tpu_torch.ops.bvh import build_bvh
from rpt_tpu_torch.ops.tlas import build_instanced
from rpt_tpu_torch.scenes import build_brick_city, build_dragon_scene, build_toy_plane_scene, lego_camera
import walk_scenes
from test_bvh_pallas import _random_mesh
from test_tlas_pallas import _build_instanced_scene, _FakeMesh
from test_torch_reference_native import reference_native
from test_torch_render import EXAMPLES, cornell_scene, reference_camera, reference_tree, sphere_scene

reference_native()

F64 = torch.float64
T_MIN = 1e-3
W, H = 32, 24
SEED = 7


def x64():
    return jax.enable_x64(True)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def test_keys_split_and_fold_in_do_not_change_under_x64():
    for seed in (0, 7, 2**31 - 1, -7):
        key = np.asarray(jax.random.PRNGKey(seed)) if seed >= 0 else rnd.PRNGKey(seed)
        with x64():
            key64 = np.asarray(jax.random.PRNGKey(seed))
            np.testing.assert_array_equal(rnd.PRNGKey(seed, x64=True), key64)
            np.testing.assert_array_equal(rnd.split(key64, 3), np.asarray(jax.random.split(key64, 3)))
            np.testing.assert_array_equal(rnd.fold_in(key64, 12345), np.asarray(jax.random.fold_in(key64, 12345)))
        # Keys stay uint32 pairs: split and fold_in are the same without x64.
        np.testing.assert_array_equal(rnd.split(key, 3), np.asarray(jax.random.split(key, 3)))
        np.testing.assert_array_equal(rnd.fold_in(key, 12345), np.asarray(jax.random.fold_in(key, 12345)))
    # Under x64 a negative seed fills the key's high word; the int32 key has 0 there.
    assert rnd.PRNGKey(-7, x64=True)[0] == 0xFFFFFFFF and rnd.PRNGKey(-7)[0] == 0


@pytest.mark.parametrize("tensor_key", [False, True], ids=["host_key", "tensor_key"])
@pytest.mark.parametrize("seed", [0, 3, -7])
def test_64_bit_draws_equal_jax_under_x64(seed, tensor_key):
    host = rnd.PRNGKey(seed, x64=True)
    key = rnd.to_device(host, "cpu") if tensor_key else host
    dev = None if tensor_key else "cpu"
    with x64():
        jkey = jax.random.PRNGKey(seed)
        for shape, lo, hi in [((1000,), 0.0, 1.0), ((2, 333), -1.0 / 48, 1.0 / 48), ((500,), 1e-7, 1.0),
                              ((77, 2), 0.0, 2.0 * np.pi), ((4, 5, 6), -3.0, 5.5)]:
            want = np.asarray(jax.random.uniform(jkey, shape, jax.numpy.float64, lo, hi))
            got = rnd.uniform(key, shape, dtype=F64, minval=lo, maxval=hi, device=dev)
            assert got.dtype == F64 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jax.random.uniform(jkey, (300,)))  # the default type: float64 under x64
        np.testing.assert_array_equal(rnd.uniform(key, (300,), dtype=F64, device=dev).numpy(), want)
        for lo, hi in [(0, 6), (0, 16428), (-100, 123457), (-2**62, 2**62), (0, 2**40 + 3)]:
            want = np.asarray(jax.random.randint(jkey, (2000,), lo, hi))
            assert want.dtype == np.int64
            got = rnd.randint(key, (2000,), lo, hi, dtype=torch.int64, device=dev)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jax.random.bernoulli(jkey, 0.5, (1500,)))
        got = rnd.bernoulli(key, 0.5, (1500,), dtype=F64, device=dev)
        np.testing.assert_array_equal(got.numpy(), want)


def test_64_bit_draws_are_not_the_32_bit_ones():
    key = rnd.PRNGKey(3)
    u32 = rnd.uniform(key, (4,), device="cpu").numpy()
    u64 = rnd.uniform(key, (4,), dtype=F64, device="cpu").numpy()
    np.testing.assert_allclose(u32, [0.0741, 0.938, 0.649, 0.976], atol=1e-3)
    np.testing.assert_allclose(u64, [0.865, 0.453, 0.239, 0.204], atol=1e-3)
    np.testing.assert_array_equal(rnd.randint(key, (4,), 0, 6, device="cpu").numpy(), [3, 1, 1, 2])
    np.testing.assert_array_equal(rnd.randint(key, (4,), 0, 6, dtype=torch.int64, device="cpu").numpy(), [1, 2, 3, 5])


def test_fma64_is_one_rounding():
    """The plain f64 uniform's `floats * span + lo` in one rounding, held
    against exact rational arithmetic on values that round differently in
    two steps."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.uniform(0.0, 1.0, 4000)
    for b, c in [(1.0 - 1e-7, 1e-7), (2.0 / 48, -1.0 / 48), (2.0 * np.pi, 0.0), (8.5, -3.0)]:
        got = rnd.fma64(torch.as_tensor(a), b, c).numpy()
        want = np.array([float(Fraction(x) * Fraction(b) + Fraction(c)) for x in a])
        np.testing.assert_array_equal(got, want)
        assert ((a * b + c) != want).any() or c == 0.0


# ---------------------------------------------------------------------------
# Hits of the four walk families against the reference's float64 XLA loops
# ---------------------------------------------------------------------------


def _rays_at(targets: np.ndarray, n: int, radius: float, seed: int):
    """float64 rays from a sphere of `radius` at jittered points of `targets`."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= radius / np.linalg.norm(o, axis=-1, keepdims=True)
    d = targets[rng.integers(0, targets.shape[0], n)] + rng.uniform(-0.05, 0.05, (n, 3)) - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _assert_hits_agree(got, ref, t_rtol=1e-12):
    want_t, got_t = np.asarray(ref.t), got.t.numpy()
    assert got.t.dtype == F64 and np.asarray(ref.t).dtype == np.float64
    hit = np.isfinite(want_t)
    assert hit.sum() > 60 and (~hit).any()
    same = (np.isfinite(got_t) == hit) & (~hit | (got.mat_id.numpy() == np.asarray(ref.mat_id)))
    assert same.mean() >= 0.999, f"hits agree on only {same.mean():.4f} of the rays"
    both = hit & np.isfinite(got_t)
    np.testing.assert_allclose(got_t[both], want_t[both], rtol=t_rtol, atol=0)


def _mesh_case(seed=0, n_tris=400):
    verts, norms, mats = _random_mesh(n_tris, seed=seed)  # float64 vertices, no float32 values
    o, d = _rays_at(verts.mean(axis=1), 500, 4.0, seed + 1)
    with x64():
        ref = ref_bvh_closest_hit(ref_build_bvh(verts, norms, mats, jax.numpy.float64), o, d, T_MIN)
    return (verts, norms, mats), ref, torch.as_tensor(o), torch.as_tensor(d)


def _instance_case(seed=0):
    meshes, instances = _build_instanced_scene(3, 17, seed=seed)
    cents = np.concatenate([meshes[i].vertices.mean(axis=1) @ mat[:3, :3].T + mat[:3, 3] for i, mat, _ in instances])
    o, d = _rays_at(cents, 500, 10.0, seed + 1)
    with x64():
        ref = ref_instanced_closest_hit(ref_build_instanced(meshes, instances, jax.numpy.float64), o, d, T_MIN)
    return (meshes, instances), ref, torch.as_tensor(o), torch.as_tensor(d)


@pytest.fixture(scope="module")
def mesh_case():
    return _mesh_case()


@pytest.fixture(scope="module")
def instance_case():
    return _instance_case()


ONE_LEVEL = {"bvh8": (bvh8.pack_bvh8, bvh8.bvh8_closest_hit, bvh8.bvh8_occluded),
             "bvh2": (bvh2.pack_bvh2, bvh2.bvh2_closest_hit, bvh2.bvh2_occluded)}
TWO_LEVEL = {"tlas8": (tlas8.pack_tlas8, tlas8.tlas8_closest_hit, tlas8.tlas8_occluded),
             "tlas2": (tlas2.pack_tlas2, tlas2.tlas2_closest_hit, tlas2.tlas2_occluded)}


def _assert_occluded_rule(occluded, closest_t, seed):
    t_max = torch.as_tensor(np.random.default_rng(seed).uniform(2.0, 12.0, closest_t.shape[0]))
    t_max[:20] = torch.where(torch.isfinite(closest_t[:20]), closest_t[:20], t_max[:20])
    want = closest_t <= t_max
    assert want.any() and (~want).any()
    assert torch.equal(occluded(t_max), want)


@pytest.mark.parametrize("family", list(ONE_LEVEL))
def test_one_level_f64_walks_match_reference_xla_loop(mesh_case, family):
    (verts, norms, mats), ref, o, d = mesh_case
    pack_fn, closest, occluded = ONE_LEVEL[family]
    bvh = build_bvh(verts, norms, mats, device="cpu", dtype=F64)
    pack = pack_fn(bvh)
    assert pack.tris.dtype == F64 and pack.tris.shape[1] == 20
    got = closest(bvh, pack, o, d, T_MIN)
    _assert_hits_agree(got, ref)
    _assert_occluded_rule(lambda t_max: occluded(bvh, pack, o, d, T_MIN, t_max), got.t, 2)


@pytest.mark.parametrize("family", list(TWO_LEVEL))
def test_two_level_f64_walks_match_reference_xla_loop(instance_case, family):
    (meshes, instances), ref, o, d = instance_case
    pack_fn, closest, occluded = TWO_LEVEL[family]
    im = build_instanced(meshes, instances, device="cpu", dtype=F64)
    pack = pack_fn(im)
    assert pack.tris.dtype == F64 and pack.inst.dtype == F64
    got = closest(im, pack, o, d, T_MIN)
    _assert_hits_agree(got, ref)
    np.testing.assert_allclose(got.normal.numpy()[np.isfinite(np.asarray(ref.t))],
                               np.asarray(ref.normal)[np.isfinite(np.asarray(ref.t))], rtol=1e-9, atol=1e-9)
    _assert_occluded_rule(lambda t_max: occluded(im, pack, o, d, T_MIN, t_max), got.t, 3)


def _grazing_mesh():
    """A triangle whose right edge stands at x = 1 + 2^-30 (float64), which
    the SAH build's nearest float32 box cuts at x = 1, among other triangles;
    and a ray straight down through the sliver between the two."""
    edge = 1.0 + 2.0**-30
    sliver = np.array([[[edge, -1.0, 0.0], [edge, 1.0, 0.0], [-1.0, 0.0, 0.0]]])
    far, _, _ = _random_mesh(70, seed=5)
    verts = np.concatenate([sliver, 0.4 * far + np.array([-2.0, 0.0, -6.0])])
    e = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    norms = np.repeat((e / np.linalg.norm(e, axis=-1, keepdims=True))[:, None], 3, axis=1)
    mats = np.arange(verts.shape[0], dtype=np.int32) % 3 + 1
    ray_x = 1.0 + 2.0**-31
    return verts, norms, mats, ray_x


def test_float64_boxes_hold_a_grazing_triangle():
    """The reference's float64 loop tests its float64 rays against the
    SAH build's nearest float32 boxes and misses the sliver; every port
    family rounds its float64 pack's boxes outward and finds the hit that a
    brute-force float64 test finds, at t = 3."""
    verts, norms, mats, ray_x = _grazing_mesh()
    o = torch.tensor([[ray_x, 0.0, 3.0]], dtype=F64)
    d = torch.tensor([[0.0, 0.0, -1.0]], dtype=F64)
    brute = rpt_tpu_torch.ops.intersect.intersect_triangles(o, d, T_MIN, torch.as_tensor(verts),
                                                           torch.as_tensor(norms), torch.as_tensor(mats))
    assert float(brute.t[0]) == 3.0
    bvh = build_bvh(verts, norms, mats, device="cpu", dtype=F64)
    assert float(bvh.node_max[0, 0]) == 1.0  # the SAH build's box cuts the sliver off
    with x64():
        ref = ref_bvh_closest_hit(ref_build_bvh(verts, norms, mats, jax.numpy.float64), o.numpy(), d.numpy(), T_MIN)
    assert not np.isfinite(np.asarray(ref.t)[0])
    for pack_fn, closest, occluded in ONE_LEVEL.values():
        pack = pack_fn(bvh)
        assert float(closest(bvh, pack, o, d, T_MIN).t[0]) == 3.0
        assert bool(occluded(bvh, pack, o, d, T_MIN, 4.0)[0])
    # Two-level: the same mesh as one instance moved by +0.5 in x.
    move = np.eye(4)
    move[0, 3] = 0.5
    mesh = rpt_tpu_torch.shapes.Mesh(vertices=verts, normals=norms)
    im = build_instanced([mesh], [(0, move, 1)], device="cpu", dtype=F64)
    ow = o + torch.tensor([[0.5, 0.0, 0.0]], dtype=F64)
    for pack_fn, closest, occluded in TWO_LEVEL.values():
        pack = pack_fn(im)
        assert float(closest(im, pack, ow, d, T_MIN).t[0]) == 3.0
        assert bool(occluded(im, pack, ow, d, T_MIN, 4.0)[0])


_edge_scene = walk_scenes.edge_scene


@pytest.mark.parametrize("family", list(TWO_LEVEL))
def test_two_level_f64_walk_at_a_box_face_under_scaled_instances(family):
    """A float64 box test at its edge (see `_edge_scene`): every ray that
    meets the triangle just inside its edge (by 1e-12 to 1e-6) finds it,
    every ray just outside misses, as a brute-force float64 test of the
    instances' world-space triangles says and as the reference's float64
    XLA loop finds; the any hit agrees at t_max just past the hit's t.

    At t_max = the hit's t itself an unwidened box test can refuse the flat
    leaf, whose z-slab entry rounds an ulp past the triangle's t; both
    families take it (the float box tests widened by 2^-21 of t, a double
    one's upper end by 8 ulps, csrc/walk.cuh `box_upper`), as
    `finish_occluded`'s rule `closest.t <= t_max` asks."""
    (verts, norms, instances), o, d, delta, inst, dist = _edge_scene()
    mesh = rpt_tpu_torch.shapes.Mesh(vertices=verts, normals=norms)
    im = build_instanced([mesh], instances, device="cpu", dtype=F64)
    pack_fn, closest, occluded = TWO_LEVEL[family]
    pack = pack_fn(im)
    got = closest(im, pack, o, d, T_MIN)
    # Brute force: every instance's triangles in world space, in float64.
    wv = np.concatenate([verts @ m[:3, :3].T + m[:3, 3] for _, m, _ in instances])
    wn = np.concatenate([norms for _ in instances])
    wm = np.repeat([mat for _, _, mat in instances], verts.shape[0]).astype(np.int32)
    brute = rpt_tpu_torch.ops.intersect.intersect_triangles(o, d, T_MIN, torch.as_tensor(wv), torch.as_tensor(wn),
                                                           torch.as_tensor(wm))
    inside = delta > 0
    t_got, t_brute = got.t.numpy(), brute.t.numpy()
    assert np.isfinite(t_brute[inside]).all() and not np.isfinite(t_brute[~inside]).any()
    np.testing.assert_array_equal(np.isfinite(t_got), inside)
    np.testing.assert_allclose(t_got[inside], t_brute[inside], rtol=1e-12, atol=0)
    np.testing.assert_allclose(t_got[inside], dist[inside], rtol=1e-12)
    np.testing.assert_array_equal(got.mat_id.numpy()[inside], inst[inside] + 1)
    with x64():
        ref = ref_instanced_closest_hit(ref_build_instanced([_FakeMesh(verts, norms)], instances, jax.numpy.float64),
                                        o.numpy(), d.numpy(), T_MIN)
    np.testing.assert_array_equal(np.isfinite(np.asarray(ref.t)), inside)
    np.testing.assert_allclose(t_got[inside], np.asarray(ref.t)[inside], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got.mat_id.numpy()[inside], np.asarray(ref.mat_id)[inside])
    t_max = torch.where(got.t < 1e38, got.t * (1.0 + 1e-9), torch.full_like(got.t, 12.0))
    assert torch.equal(occluded(im, pack, o, d, T_MIN, t_max), torch.as_tensor(inside))
    t_max = torch.where(got.t < 1e38, got.t, torch.full_like(got.t, 12.0))
    assert torch.equal(occluded(im, pack, o, d, T_MIN, t_max), torch.as_tensor(inside))


@pytest.mark.parametrize("family", list(ONE_LEVEL))
def test_one_level_f64_walk_at_a_box_face(family):
    """The one-level analogue of the test above: `_edge_scene`'s mesh
    alone, under each ray re-expressed in its instance's frame (direction
    unnormalized, so t is the world t). Every ray just inside the edge
    finds the triangle at its t, every ray outside misses, as the
    reference's float64 XLA loop finds; the any hit agrees just past the
    hit's t and at the hit's t itself, where the flat leaf's entry can
    round an ulp past it."""
    (verts, norms, instances), o, d, delta, inst, dist = _edge_scene()
    A = np.stack([np.linalg.inv(m)[:3] for _, m, _ in instances])[inst]
    o = torch.as_tensor(np.einsum("nij,nj->ni", A[:, :, :3], o.numpy()) + A[:, :, 3])
    d = torch.as_tensor(np.einsum("nij,nj->ni", A[:, :, :3], d.numpy()))
    mats = np.ones(verts.shape[0], np.int32)
    bvh = build_bvh(verts, norms, mats, device="cpu", dtype=F64)
    pack_fn, closest, occluded = ONE_LEVEL[family]
    pack = pack_fn(bvh)
    got = closest(bvh, pack, o, d, T_MIN)
    inside = delta > 0
    t_got = got.t.numpy()
    np.testing.assert_array_equal(np.isfinite(t_got), inside)
    np.testing.assert_allclose(t_got[inside], dist[inside], rtol=1e-12)
    with x64():
        ref = ref_bvh_closest_hit(ref_build_bvh(verts, norms, mats, jax.numpy.float64), o.numpy(), d.numpy(), T_MIN)
    np.testing.assert_array_equal(np.isfinite(np.asarray(ref.t)), inside)
    np.testing.assert_allclose(t_got[inside], np.asarray(ref.t)[inside], rtol=1e-12, atol=0)
    for scale in (1.0 + 1e-9, 1.0):
        t_max = torch.where(got.t < 1e38, got.t * scale, torch.full_like(got.t, 12.0))
        assert torch.equal(occluded(bvh, pack, o, d, T_MIN, t_max), torch.as_tensor(inside))


def _brute_closest(bvh, pack, o, d):
    """Every leaf row of the float64 `pack` tested with `bvh8._leaf_t`
    (the walk's own triangle test) against every ray: the lowest t, then
    the lowest row, as (t, row) with bvh8's miss sentinel and row 0 on a
    miss. The padding rows past a leaf's count are not rows of it."""
    leaf = bvh.is_leaf.bool()
    rows = torch.cat([torch.arange(s, s + c) for s, c in zip(bvh.leaf_start[leaf].tolist(),
                                                             bvh.leaf_count[leaf].tolist())])
    tris = pack.tris[rows][None]
    t_out, row_out = [], []
    for c in range(0, o.shape[0], 256):
        t, ok = bvh8._leaf_t(tris, o[c:c + 256], d[c:c + 256], T_MIN)
        t = torch.where(ok, t, torch.full_like(t, bvh8._BIG))
        best = t.min(1).values
        row = torch.where(t == best[:, None], rows, bvh8._NO_ROW).min(1).values
        t_out.append(best)
        row_out.append(torch.where(best < bvh8._BIG, row, torch.zeros_like(row)))
    return torch.cat(t_out), torch.cat(row_out).to(torch.int32)


# `far_trefoil`'s translation: far from the origin and off the float grid,
# so a ray's origin rounds to float by up to 1.2e-4 (the float box tests
# cover that: the pack's boxes lie an ulp outside the float64 triangles).
FAR_OFFSET = (1000.1, -2000.3, 3000.7)
# `far_edge`'s: the flat leaves' plane (z = 0) just under 2^22, half a float
# ulp (0.125) less 1e-9 above a float, so its box's outward rounding leaves
# it the least room (0.125 and a little); the origins lie above 2^22, where
# a float copy is off by up to 0.25. Only the float ray's origin slack
# (csrc/walk.cuh `origin_slack`) keeps such a ray's leaf in its box test.
FAR_EDGE_OFFSET = (0.0, 0.0, 4194303.875 - 1e-9)


def _one_level_f64_case(case):
    """(bvh, o, d) in float64: `_random_mesh` and a 3,000-triangle trefoil
    under rays at their triangles from a sphere around them; the same
    trefoil and rays translated by `FAR_OFFSET`, the origins jittered by up
    to 1e-9 (`far_trefoil`); the trefoil under rays leaving its first hits
    in random directions (an origin on the surface, t_min above it); and
    `walk_scenes`' `edge` (flat leaves, hits on a leaf's face), the same
    translated by `FAR_EDGE_OFFSET` (`far_edge`), and `twin_leaves` (every
    hit a tie of two leaves)."""
    if case in ("edge", "twin_leaves"):
        return walk_scenes.walk_scene("bvh8", case, F64)
    if case == "far_edge":
        return walk_scenes.walk_scene("bvh8", "edge", F64, offset=FAR_EDGE_OFFSET)
    if case == "random_mesh":
        verts, norms, mats = _random_mesh(3000, seed=8)
        o, d = _rays_at(verts.mean(axis=1), 1500, 4.0, 9)
    else:
        knot = rpt_tpu_torch.scenes.trefoil_mesh(segments=50, sides=30)
        verts, norms = knot.vertices, knot.normals
        mats = np.arange(verts.shape[0], dtype=np.int32) % 3
        o, d = _rays_at(verts.mean(axis=1), 1500, 1.5, 10)
        if case == "far_trefoil":
            verts = verts + np.asarray(FAR_OFFSET)
            o = o + np.asarray(FAR_OFFSET) + np.random.default_rng(14).uniform(-1e-9, 1e-9, o.shape)
        if case == "trefoil_bounce":
            t = rpt_tpu_torch.ops.intersect.intersect_triangles(
                torch.as_tensor(o), torch.as_tensor(d), T_MIN, torch.as_tensor(verts), torch.as_tensor(norms),
                torch.as_tensor(mats)).t.numpy()
            hit = np.isfinite(t)
            o = o[hit] + t[hit, None] * d[hit]
            d = np.random.default_rng(11).normal(size=o.shape)
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return build_bvh(verts, norms, mats, device="cpu", dtype=F64), torch.as_tensor(o), torch.as_tensor(d)


ONE_LEVEL_CASES = ["random_mesh", "trefoil", "trefoil_bounce", "edge", "twin_leaves", "far_trefoil", "far_edge"]


@pytest.mark.parametrize("family,case", [pytest.param("bvh8", c, id=c) for c in ONE_LEVEL_CASES]
                         + [pytest.param("bvh2", c, id=f"bvh2-{c}") for c in ONE_LEVEL_CASES])
def test_one_level_f64_walk_equals_a_brute_force_scan(family, case):
    """The float64 bvh8 walk (rows whole) and the float64 bvh2 walk, each
    testing its boxes in float against a float copy of the ray, miss no
    leaf that holds the closest hit, far from the origin too: the closest
    hit's t and triangle id equal a brute-force scan of every row bit for
    bit, ties to the lowest row; the any hit equals `t <= t_max` of the
    scan, at t_max = the scan's t itself, an ulp below it and at random
    t_max."""
    pack_fn, _, _ = ONE_LEVEL[family]
    mod = {"bvh8": bvh8, "bvh2": bvh2}[family]
    bvh, o, d = _one_level_f64_case(case)
    pack = pack_fn(bvh)
    t_brute, row_brute = _brute_closest(bvh, pack, o, d)
    hit = t_brute < bvh8._BIG
    assert hit.sum() > 150 and (~hit).sum() > 20
    t_walk, row_walk = getattr(mod, f"{family}_closest_plain")(pack, o, d, T_MIN)
    assert torch.equal(t_walk, t_brute) and torch.equal(row_walk, row_brute)
    at_t = torch.where(hit, t_brute, torch.full_like(t_brute, 12.0))
    below = torch.where(hit, torch.nextafter(t_brute, torch.zeros_like(t_brute)), at_t)
    random = torch.as_tensor(np.random.default_rng(12).uniform(0.0, 4.0, o.shape[0]))
    assert torch.equal(t_brute <= at_t, hit) and not (t_brute <= below).any()
    assert 0 < int((t_brute <= random).sum()) < int(hit.sum())
    for t_max in (at_t, below, random):
        assert torch.equal(getattr(mod, f"{family}_occluded_plain")(pack, o, d, T_MIN, t_max), t_brute <= t_max)


def test_bvh2_f64_walks_test_their_boxes_in_float(monkeypatch):
    """Both one-level float64 bvh2 walks test their boxes in float: every
    slab comes from `_slab_f32` and none from the double test (`bvh8._slab`
    through `bvh2._slab`), and each walk's box count is the filled child
    slots of the nodes the float test saw."""
    bvh, o, d = _one_level_f64_case("trefoil_bounce")
    pack = bvh2.pack_bvh2(bvh)
    seen = {"double": 0, "float": 0}
    slab, slab_f32 = bvh2._slab, bvh2._slab_f32

    def double_slab(b, ol, il):
        seen["double"] += int((b[:, 0] <= b[:, 3]).sum())  # filled slots: an empty one's box is inverted
        return slab(b, ol, il)

    def float_slab(b, fr):
        seen["float"] += int((b[:, 0] <= b[:, 3]).sum())
        return slab_f32(b, fr)

    monkeypatch.setattr(bvh2, "_slab", double_slab)
    monkeypatch.setattr(bvh2, "_slab_f32", float_slab)
    t_max = torch.as_tensor(np.random.default_rng(13).uniform(0.5, 4.0, o.shape[0]))
    stats = {}
    occ = bvh2.bvh2_occluded_plain(pack, o, d, T_MIN, t_max, stats=stats)
    assert occ.any() and (~occ).any()
    assert seen == {"double": 0, "float": stats["box_tests"]} and stats["box_tests"] > 0
    float_before, stats = seen["float"], {}
    bvh2.bvh2_closest_plain(pack, o, d, T_MIN, stats=stats)
    assert seen["float"] - float_before == stats["box_tests"] > 0 and seen["double"] == 0


@pytest.mark.parametrize("family", list(ONE_LEVEL) + list(TWO_LEVEL))
def test_a_wrapper_refuses_rays_of_the_other_type(family):
    verts, norms, mats = _random_mesh(80, seed=1)
    o, d = (torch.as_tensor(a) for a in _rays_at(verts.mean(axis=1), 8, 4.0, 2))
    if family in ONE_LEVEL:
        pack_fn, closest, occluded = ONE_LEVEL[family]
        scenes = {dt: build_bvh(verts, norms, mats, device="cpu", dtype=dt) for dt in (torch.float32, F64)}
    else:
        pack_fn, closest, occluded = TWO_LEVEL[family]
        mesh = rpt_tpu_torch.shapes.Mesh(vertices=verts, normals=norms)
        scenes = {dt: build_instanced([mesh], [(0, np.eye(4), 0)], device="cpu", dtype=dt)
                  for dt in (torch.float32, F64)}
    for dt, other in ((torch.float32, F64), (F64, torch.float32)):
        sd = scenes[dt]
        pack = pack_fn(sd)
        with pytest.raises(TypeError, match="pack"):
            closest(sd, pack, o.to(other), d.to(other), T_MIN)
        with pytest.raises(TypeError, match="pack"):
            occluded(sd, pack, o.to(other), d.to(other), T_MIN, 5.0)


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------


def trefoil_scenes():
    """The `dragon` scene with a 16,428-triangle trefoil (222 segments x 37
    sides), past WIDE_KERNEL_MIN_TRIS: the wide pack, so morton-sorted
    wavefronts from depth 1 by default."""
    sys.path.insert(0, EXAMPLES)
    import dragon

    ref = dragon.build_scene(target_tris=16384)
    cam = rpt_tpu.Camera.look_at((-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)
    port = build_dragon_scene(target_tris=16384)
    return (ref, cam, 1e-3), (port, rpt_tpu_torch.scenes.dragon_camera(), 1e-3)


def city_scenes():
    """The brick city cut to 96 instances (tlas8, morton by default)."""
    sys.path.insert(0, EXAMPLES)
    import lego

    ref = lego.build_brick_city(n_instances=96)
    cam = rpt_tpu.Camera.look_at((18.0, 14.0, 26.0), (0.0, 4.0, 0.0), (0.0, 1.0, 0.0), math.pi / 5)
    return (ref, cam, 1e-3), (build_brick_city(n_instances=96), lego_camera(), 1e-3)


def toy_plane_scenes():
    """The toy brick plane through each package's OBJ+MTL loader (bvh2)."""
    sys.path.insert(0, EXAMPLES)
    import lego

    cam = rpt_tpu.Camera.look_at((2.5, 2.0, 1.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6)
    return (lego.build_scene(), cam, 1e-3), (build_toy_plane_scene(), rpt_tpu_torch.scenes.toy_plane_camera(), 1e-3)


def _pair(make):
    if make in (sphere_scene, cornell_scene):
        return make(rpt_tpu), make(rpt_tpu_torch)
    return make()


SCENES = {"sphere": sphere_scene, "cornell": cornell_scene, "trefoil": trefoil_scenes, "city": city_scenes,
          "toy_plane": toy_plane_scenes}
# The port's pack of each scene, and whether it sorts by default (the
# reference's rule: morton where a wide pack walks).
FAMILY = {"sphere": None, "cornell": None, "trefoil": "bvh8", "city": "tlas8", "toy_plane": "bvh2"}


def render_ref(scene, cam, eps, spp=1):
    """The reference's float64 render. Its pass cache is keyed on the scene
    alone, not on RPT_COMPACT, so each call starts from an empty one."""
    renderer_ref = rpt_tpu.renderer
    renderer_ref._MANY_CACHE = renderer_ref.SceneCache()
    with x64():
        r = rpt_tpu.Renderer(scene, cam, width=W, height=H, max_bounces=2, num_samples=spp, epsilon=eps, seed=SEED,
                             dtype=jax.numpy.float64)
        img = np.asarray(r.render_buffer().mean_image())
    assert img.dtype == np.float64
    return img


def render_port(scene, cam, eps, spp=1, dtype=F64, scene_data=None):
    r = rpt_tpu_torch.Renderer(scene, cam, width=W, height=H, max_bounces=2, num_samples=spp, epsilon=eps, seed=SEED,
                               dtype=dtype, device="cpu")
    img = r.render_buffer(scene_data=scene_data).mean_image()
    assert img.dtype == dtype
    return img.numpy()


def assert_f64_images_agree(got, want):
    assert got.shape == want.shape == (H, W, 3)
    assert np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-5, atol=1e-7).all(-1)
    assert close.mean() >= 0.995, f"only {close.mean():.4f} of pixels agree"
    assert abs(got.mean() - want.mean()) <= 1e-7 * abs(want.mean())


@pytest.fixture(scope="module")
def scene_pairs():
    """Each scene with both packages, and the reference's image of each
    order, made once: the scenes that do not sort have one image for both."""
    pairs = {}

    def get(name):
        if name not in pairs:
            (ref_scene, ref_cam, eps), (port_scene, port_cam, _) = _pair(SCENES[name])
            pairs[name] = dict(ref=(ref_scene, ref_cam, eps), port=(port_scene, port_cam, eps), img={})
        return pairs[name]

    return get


@pytest.mark.parametrize("order", ["default", "masked"])
@pytest.mark.parametrize("name", list(SCENES))
def test_f64_render_matches_reference(scene_pairs, name, order, monkeypatch):
    if order == "masked":
        monkeypatch.setenv("RPT_COMPACT", "0")
    pair = scene_pairs(name)
    port_scene, port_cam, eps = pair["port"]
    sd = port_scene.compile(F64, device="cpu")
    family = FAMILY[name]
    assert {pack.library for pack in sd.packs} == ({family} - {None})
    sorts = order == "default" and family in ("bvh8", "tlas8")
    assert renderer_mod._auto_compact(sd) == ("morton" if sorts else False)
    if sorts not in pair["img"]:
        pair["img"][sorts] = render_ref(*pair["ref"])
    got = render_port(port_scene, port_cam, eps)
    assert_f64_images_agree(got, pair["img"][sorts])
    pair.setdefault("port_img", {})[order] = got
    if len(pair["port_img"]) == 2 and family not in ("bvh8", "tlas8"):
        # No sort either way: the two orders are one render.
        np.testing.assert_array_equal(pair["port_img"]["default"], pair["port_img"]["masked"])


def test_f64_render_is_not_the_f32_render():
    """The 64-bit draws are other numbers, so a float64 render is another
    sample of the image, not the float32 one more precisely."""
    (_, _, _), (scene, cam, eps) = _pair(sphere_scene)
    r64 = render_port(scene, cam, eps)
    r32 = render_port(scene, cam, eps, dtype=torch.float32)
    assert not np.isclose(r64, r32, rtol=1e-3, atol=1e-4).all(-1).mean() > 0.5
    assert abs(r64.mean() - r32.mean()) < 0.25 * abs(r64.mean())


# ---------------------------------------------------------------------------
# Plumbing
# ---------------------------------------------------------------------------


def test_converted_f64_scene_renders_like_reference(scene_pairs):
    pair = scene_pairs("cornell")
    ref_scene, ref_cam, eps = pair["ref"]
    with x64():
        tree = reference_tree(ref_scene.compile(jax.numpy.float64))
    port_sd = convert.scene_data_from_arrays(tree, device="cpu")
    assert port_sd.dtype == F64 and port_sd.triangles.verts.dtype == F64 and port_sd.digest.startswith("float64:")
    cam = convert.camera_from_arrays(reference_camera(ref_cam))
    assert cam.eye.dtype == torch.float32
    if False not in pair["img"]:
        pair["img"][False] = render_ref(*pair["ref"])
    assert_f64_images_agree(render_port(pair["port"][0], cam, eps, scene_data=port_sd), pair["img"][False])


def test_buffer_round_trips_f64(tmp_path):
    rng = np.random.default_rng(0)
    buf = Buffer(sum=torch.as_tensor(rng.uniform(size=(4, 5, 3))), sum_sq=torch.as_tensor(rng.uniform(size=(4, 5))),
                 count=3)
    path = tmp_path / "ck.npz"
    buf.save(path, seed=9, iteration=3)
    got, seed, it = Buffer.load(path, device="cpu")
    assert (seed, it, got.count) == (9, 3, 3)
    assert got.sum.dtype == F64 and torch.equal(got.sum, buf.sum) and torch.equal(got.sum_sq, buf.sum_sq)
    assert Buffer.new(5, 4, device="cpu", dtype=F64).sum.dtype == F64


def test_f32_and_f64_are_separate_compiles_and_graphs():
    (_, _, _), (scene, cam, eps) = _pair(sphere_scene)
    sd32, sd64 = scene.compile(device="cpu"), scene.compile(F64, device="cpu")
    assert sd32.dtype == torch.float32 and sd64.dtype == F64
    assert scene.compile(F64, device="cpu") is sd64 and scene.compile(device="cpu") is sd32
    assert renderer_mod.scene_cache_key(sd32) != renderer_mod.scene_cache_key(sd64)
    fn32 = renderer_mod.make_render_many_fn(sd32, W, H, 2)
    fn64 = renderer_mod.make_render_many_fn(sd64, W, H, 2)
    assert fn32 is not fn64 and fn32.inputs.s.dtype == torch.float32 and fn64.inputs.s.dtype == F64
    assert renderer_mod.make_render_many_fn(sd64, W, H, 2) is fn64
    # A float64 renderer refuses a float32 scene, and float32 sums refuse float64 samples.
    r64 = rpt_tpu_torch.Renderer(scene, cam, width=W, height=H, dtype=F64, device="cpu")
    with pytest.raises(TypeError):
        r64.render_buffer(scene_data=sd32)
    with pytest.raises(TypeError):
        r64.sample_into(Buffer.new(W, H, device="cpu"), 1)
