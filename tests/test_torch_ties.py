"""The port's walks at the reference's ties, and every any hit at t_max = t.

The reference's XLA loops (`rpt_tpu/ops/bvh.py` `bvh_closest_hit`,
`rpt_tpu/ops/tlas.py` `instanced_closest_hit`; its only path in float64)
walk in preorder with a strict `<`, so among hits at one t they keep the
first leaf in preorder: the first TLAS leaf, then the first BLAS leaf, then
the lowest row. Every port walk keeps that choice, the wide ones too: a
leaf's best row replaces the best hit on a smaller t, or on an equal t with
a smaller key, (TLAS leaf rank, row) two-level and the row one-level. Here
the plain walks (the kernels' contract; `tests/test_torch_cuda.py` holds
the kernels to them) and the port's `bvh_closest_hit` /
`instanced_closest_hit` are held to the XLA loops on scenes where most hits
are ties, in float32 and float64 (under `jax.enable_x64`): hit mask and
material id exactly, t to 2e-5 (float32) or 1e-12 relative (float64).

The any hit answers `closest.t <= t_max` (`rpt_tpu/scene.py:373-379`), so at
t_max = the closest hit's own t it must find that hit, also on a flat leaf
whose box entry rounds an ulp past the triangle's t (`_edge_scene`): every
family's box test widens its upper end (csrc/walk.cuh `box_upper`). The
float64 tlas8 and bvh8 walks test their boxes in float: the float test must
take every box the widened double test takes.
"""

import math

import jax
import numpy as np
import pytest
import torch

import rpt_tpu_torch
import walk_scenes
from rpt_tpu.ops.bvh import build_bvh as ref_build_bvh
from rpt_tpu.ops.bvh import bvh_closest_hit as ref_bvh_closest_hit
from rpt_tpu.ops.tlas import build_instanced as ref_build_instanced
from rpt_tpu.ops.tlas import instanced_closest_hit as ref_instanced_closest_hit
from rpt_tpu_torch.ops import bvh2, bvh8, tlas2, tlas8
from rpt_tpu_torch.ops.bvh import build_bvh, bvh_closest_hit
from rpt_tpu_torch.ops.tlas import build_instanced, instanced_closest_hit
from test_tlas_pallas import _build_instanced_scene, _FakeMesh, _rays_at_instances
from test_torch_bvh2 import _twin_leaves
from test_torch_f64 import _edge_scene
from test_torch_reference_native import reference_native

reference_native()

T_MIN = 1e-3
F32, F64 = torch.float32, torch.float64
DTYPES = {"float32": F32, "float64": F64}
T_BARS = {F32: dict(rtol=2e-5, atol=2e-5), F64: dict(rtol=1e-12, atol=0.0)}


def _one_level(family):
    """closest(bvh, o, d) of a one-level family, or of the public name."""
    if family == "bvh_closest_hit":
        return lambda bvh, o, d: bvh_closest_hit(bvh, o, d, T_MIN)
    mod = {"bvh8": bvh8, "bvh2": bvh2}[family]
    return lambda bvh, o, d: getattr(mod, f"{family}_closest_hit")(bvh, getattr(mod, f"pack_{family}")(bvh), o, d,
                                                                      T_MIN)


def _two_level(family):
    if family == "instanced_closest_hit":
        return lambda im, o, d: instanced_closest_hit(im, o, d, T_MIN)
    mod = {"tlas8": tlas8, "tlas2": tlas2}[family]
    return lambda im, o, d: getattr(mod, f"{family}_closest_hit")(im, getattr(mod, f"pack_{family}")(im), o, d,
                                                                     T_MIN)


def _jnp(dtype):
    return jax.numpy.float64 if dtype == F64 else jax.numpy.float32


def _np(a, dtype):
    return np.asarray(a, np.float64 if dtype == F64 else np.float32)


def _assert_same_hits(got, ref, dtype, both_only=False):
    """Hit mask exactly (unless `both_only`), material on every hit both
    find, t at the type's bar."""
    want_t, got_t = np.asarray(ref.t), got.t.numpy()
    hit, got_hit = np.isfinite(want_t), np.isfinite(got_t)
    if not both_only:
        np.testing.assert_array_equal(got_hit, hit)
    both = hit & got_hit
    assert both.sum() > 100
    np.testing.assert_allclose(got_t[both], want_t[both], **T_BARS[dtype])
    np.testing.assert_array_equal(got.mat_id.numpy()[both], np.asarray(ref.mat_id)[both])
    return both


# ---------------------------------------------------------------------------
# Ties against the reference's XLA loops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin_leaves():
    verts, norms, mats, o, d = _twin_leaves(24, seed=21)
    refs = {}
    for dtype in (F32, F64):
        with jax.enable_x64(dtype == F64):
            refs[dtype] = ref_bvh_closest_hit(ref_build_bvh(_np(verts, dtype), norms, mats, _jnp(dtype)),
                                              _np(o, dtype), _np(d, dtype), T_MIN)
    return (verts, norms, mats, o, d), refs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", ["bvh8", "bvh2", "bvh_closest_hit"])
def test_one_level_walks_keep_the_reference_tie(twin_leaves, family, dtype):
    """`_twin_leaves`: every hit ties two leaves, which the walks reach in
    either order; each must keep the reference's (material 0, never the
    twin's 1)."""
    (verts, norms, mats, o, d), refs = twin_leaves
    dtype = DTYPES[dtype]
    bvh = build_bvh(verts, norms, mats, dtype=dtype, device="cpu")
    got = _one_level(family)(bvh, torch.as_tensor(o).to(dtype), torch.as_tensor(d).to(dtype))
    mat = got.mat_id.numpy()[_assert_same_hits(got, refs[dtype], dtype)]
    assert (mat == 0).mean() > 0.9 and not (mat == 1).any()


def _coincident(copy):
    meshes, base = _build_instanced_scene(2, 7, seed=11)
    twin_mesh = 0
    if copy == "wider_mesh":
        v, n = meshes[0].vertices, meshes[0].normals
        meshes = meshes + [_FakeMesh(np.concatenate([v, v + np.array([1.2, 0.0, 0.0])]), np.concatenate([n, n]))]
        twin_mesh = 2
    instances = base + [(twin_mesh if k == 0 else k, m, (mat + 1) % 4) for k, m, mat in base]
    o, d = _rays_at_instances(400, meshes, instances, seed=12)
    return meshes, instances, np.array(o), np.array(d)


@pytest.fixture(scope="module")
def coincident():
    cases = {}
    for copy in ("same_mesh", "wider_mesh"):
        meshes, instances, o, d = _coincident(copy)
        for dtype in (F32, F64):
            with jax.enable_x64(dtype == F64):
                ref = ref_instanced_closest_hit(ref_build_instanced(meshes, instances, _jnp(dtype)), _np(o, dtype),
                                                _np(d, dtype), T_MIN)
            cases[copy, dtype] = (meshes, instances, o, d, ref)
    return cases


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("copy", ["same_mesh", "wider_mesh"])
@pytest.mark.parametrize("family", ["tlas8", "tlas2", "instanced_closest_hit"])
def test_two_level_walks_keep_the_reference_tie(coincident, family, copy, dtype):
    """Every instance has a twin under the same transform with another
    material, so every hit is a tie between the two (with the wider mesh
    the near-first walks often reach the later twin first); each walk must
    return the reference's material on every hit."""
    dtype = DTYPES[dtype]
    meshes, instances, o, d, ref = coincident[copy, dtype]
    im = build_instanced(meshes, instances, dtype=dtype, device="cpu")
    got = _two_level(family)(im, torch.as_tensor(o).to(dtype), torch.as_tensor(d).to(dtype))
    _assert_same_hits(got, ref, dtype)


def _edge_twins(dtype):
    """`_edge_scene` with every instance doubled under its transform (the
    twin another material): ties on flat leaves, world rays; and the
    one-level analogue, the mesh twice (materials 0 and 1) under the rays
    in each instance's frame."""
    (verts, norms, instances), o, d, delta, inst, dist = _edge_scene()
    twins = instances + [(0, m, mat + 10) for _, m, mat in instances]
    A = np.stack([np.linalg.inv(m)[:3] for _, m, _ in instances])[inst]
    o_local = np.einsum("nij,nj->ni", A[:, :, :3], o.numpy()) + A[:, :, 3]
    d_local = np.einsum("nij,nj->ni", A[:, :, :3], d.numpy())
    return (verts, norms, twins), (o.to(dtype), d.to(dtype)), (o_local, d_local)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", ["bvh8", "bvh2", "tlas8", "tlas2"])
def test_closest_hit_keeps_the_reference_tie_on_a_flat_leaf(family, dtype):
    """A tie whose leaves are flat: the later twin's hit sets the running
    best to the tied t, and the earlier twin's leaf, whose entry can round
    past it, must still be visited. Held to the XLA loop where both hit
    (float32 rounds the edge rays each its own way; float64 also the mask)."""
    dtype = DTYPES[dtype]
    (verts, norms, twins), (o, d), (o_local, d_local) = _edge_twins(dtype)
    with jax.enable_x64(dtype == F64):
        if family in ("tlas8", "tlas2"):
            ref = ref_instanced_closest_hit(ref_build_instanced([_FakeMesh(verts, norms)], twins, _jnp(dtype)),
                                            o.numpy(), d.numpy(), T_MIN)
        else:
            tv, tn = np.concatenate([verts, verts]), np.concatenate([norms, norms])
            tm = np.repeat(np.int32([0, 1]), verts.shape[0])
            ref = ref_bvh_closest_hit(ref_build_bvh(_np(tv, dtype), tn, tm, _jnp(dtype)), _np(o_local, dtype),
                                      _np(d_local, dtype), T_MIN)
    if family in ("tlas8", "tlas2"):
        im = build_instanced([rpt_tpu_torch.shapes.Mesh(vertices=verts, normals=norms)], twins, dtype=dtype,
                             device="cpu")
        got = _two_level(family)(im, o, d)
    else:
        bvh = build_bvh(tv, tn, tm, dtype=dtype, device="cpu")
        got = _one_level(family)(bvh, torch.as_tensor(o_local).to(dtype), torch.as_tensor(d_local).to(dtype))
    _assert_same_hits(got, ref, dtype, both_only=dtype == F32)


# ---------------------------------------------------------------------------
# The any hit at t_max = the closest hit's t
# ---------------------------------------------------------------------------

FAMILIES = {"bvh8": (bvh8.pack_bvh8, bvh8.bvh8_closest_hit, bvh8.bvh8_occluded),
            "bvh2": (bvh2.pack_bvh2, bvh2.bvh2_closest_hit, bvh2.bvh2_occluded),
            "tlas8": (tlas8.pack_tlas8, tlas8.tlas8_closest_hit, tlas8.tlas8_occluded),
            "tlas2": (tlas2.pack_tlas2, tlas2.tlas2_closest_hit, tlas2.tlas2_occluded)}


def _edge_case(family, frame, dtype):
    """(scene data, o, d) of `_edge_scene` for the family: two-level its
    instances; one-level its mesh under the rays in each instance's frame
    (`local`, `walk_scenes.walk_scene`) or its instances' triangles in world
    space (`world`)."""
    if frame == "local" or family in ("tlas8", "tlas2"):
        return walk_scenes.walk_scene(family, "edge", dtype)
    (verts, norms, instances), o, d, _, _, _ = _edge_scene()
    verts = np.concatenate([verts @ m[:3, :3].T + m[:3, 3] for _, m, _ in instances])
    norms = np.concatenate([norms for _ in instances])
    bvh = build_bvh(verts, norms, np.zeros(verts.shape[0], np.int32), dtype=dtype, device="cpu")
    return bvh, o.to(dtype), d.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family,frame", [("bvh8", "local"), ("bvh8", "world"), ("bvh2", "local"),
                                          ("bvh2", "world"), ("tlas8", "world"), ("tlas2", "world")])
def test_any_hit_finds_the_closest_hit_at_t_max_equal_to_its_t(family, frame, dtype):
    """On `_edge_scene` (flat leaves whose entry is their exit, hits at a
    leaf's face), the any hit at t_max = the closest hit's t answers
    `closest.t <= t_max`: true on every hit, false on every miss (whose
    t_max is 12, past the scene)."""
    dtype = DTYPES[dtype]
    sd, o, d = _edge_case(family, frame, dtype)
    pack_fn, closest, occluded = FAMILIES[family]
    pack = pack_fn(sd)
    t = closest(sd, pack, o, d, T_MIN).t
    hit = torch.isfinite(t)
    assert hit.sum() > 100 and (~hit).any()
    t_max = torch.where(hit, t, torch.full_like(t, 12.0))
    assert torch.equal(occluded(sd, pack, o, d, T_MIN, t_max), hit)


def test_float_boxes_take_every_box_the_double_test_takes():
    """The float64 tlas8 walk's box test (`bvh8._slab_f32` against t_min
    rounded down and upper rounded up to float) takes every box that the
    widened double test (`_slab_hit` against `box_upper`) takes: each node
    of the pack, TLAS nodes against the world rays, BLAS nodes against the
    rays in every instance's frame, at upper = each ray's closest t (the
    prune of a tie) and at random t_max."""
    cases = []
    (verts, norms, instances), o, d, _, _, _ = _edge_scene()
    cases.append(([rpt_tpu_torch.shapes.Mesh(vertices=verts, normals=norms)], instances, o, d))
    meshes, instances = _build_instanced_scene(3, 17, seed=5)
    o, d = _rays_at_instances(300, meshes, instances, seed=6)
    cases.append((meshes, instances, torch.as_tensor(np.array(o), dtype=F64), torch.as_tensor(np.array(d), dtype=F64)))
    rng = np.random.default_rng(7)
    t_min_f = bvh8._to_f32(torch.tensor(T_MIN, dtype=F64), up=False).item()
    taken = extra = 0
    for meshes, instances, o, d in cases:
        im = build_instanced(meshes, instances, dtype=F64, device="cpu")
        pack = tlas8.pack_tlas8(im)
        t = tlas8.tlas8_closest_plain(pack, o, d, T_MIN)[0]
        for upper in (torch.where(t < 1e38, t, torch.full_like(t, 30.0)),
                      torch.as_tensor(rng.uniform(0.5, 30.0, t.shape[0]))):
            frames = [(o, d, slice(0, pack.n_tlas))]
            aff = pack.inst_rows[:, :12].reshape(-1, 3, 4)
            for k in range(aff.shape[0]):
                ol, dl, _ = bvh8._to_local(aff[k].expand(o.shape[0], 3, 4), o, d)
                frames.append((ol, dl, slice(pack.n_tlas, pack.num_nodes)))
            for ol, dl, nodes in frames:
                boxes = pack.bounds[nodes].view(-1, 6, 8)
                M = boxes.shape[0]
                b = boxes.repeat(ol.shape[0], 1, 1)
                filled = ((pack.refs[nodes] & 3) != bvh8.KIND_EMPTY).repeat(ol.shape[0], 1)
                orr, drr = ol.repeat_interleave(M, 0), dl.repeat_interleave(M, 0)
                up = upper.repeat_interleave(M, 0)[:, None]
                double = bvh8._slab_hit(b, orr, bvh8._safe_inv(drr), T_MIN, bvh8.box_upper(up))
                lo, hi = bvh8._slab_f32(b, bvh8._float_ray(orr, drr))
                single = (lo <= hi) & (hi >= t_min_f) & (lo <= bvh8._to_f32(up, up=True))
                double, single = double & filled, single & filled
                assert not (double & ~single).any()
                taken += int(double.sum())
                extra += int((single & ~double).sum())
    assert taken > 5_000 and extra > 0


def _slab_sweep(kind: str, n: int, seed: int):
    """Float boxes b (n, 6, 8) and double rays o, d (n, 3) for the box tests
    of a one-level float64 walk, each ray aimed at a point in (or on a face
    of) its first box, in one of three kinds: `far` boxes 1e2 to 1e5 from
    the world's origin and ray origins 1e-2 to 1e5 from them, off the float
    grid, where the slack of the rounded origin matters; `axis` directions
    along an axis (two components 0, -0.0 or 1e-30), from origins on the
    box's own planes; `near` origins within a few box sizes, in any
    direction."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-2.0, 2.0, (n, 8, 3))
    if kind == "far":
        lo += rng.normal(size=(n, 1, 3)) * 10.0 ** rng.uniform(2.0, 5.0, (n, 1, 1))
    size = np.exp(rng.uniform(-12.0, 0.0, (n, 8, 3)))
    size[rng.random((n, 8, 3)) < 0.1] = 0.0  # flat boxes
    lo = lo.astype(np.float32)
    hi = np.maximum((lo + size).astype(np.float32), lo)
    b = np.concatenate([lo.transpose(0, 2, 1), hi.transpose(0, 2, 1)], axis=1)  # (n, 6, 8)
    u = rng.random((n, 3))
    on = rng.random((n, 3)) < 0.3  # a coordinate on a face of the box
    u = np.where(on, rng.integers(0, 2, (n, 3)).astype(float), u)
    target = lo[:, 0].astype(np.float64) + u * (hi[:, 0].astype(np.float64) - lo[:, 0])
    if kind == "axis":
        axis = rng.integers(0, 3, n)
        d = np.zeros((n, 3))
        d[np.arange(n), axis] = rng.choice([-1.0, 1.0], n)
        d[rng.random((n, 3)) < 0.2] *= -0.0
        d = np.where((d == 0) & (rng.random((n, 3)) < 0.2), rng.choice([-1e-30, 1e-30], (n, 3)), d)
        o = target - d * rng.uniform(0.0, 8.0, (n, 1))
    else:
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dist = 10.0 ** rng.uniform(-2.0, 5.0, (n, 1)) if kind == "far" else rng.uniform(0.0, 6.0, (n, 1))
        o = target - d * dist
        o += rng.uniform(-1.0, 1.0, (n, 3)) * np.abs(o) * 2.0**-30  # off the float grid
    return torch.as_tensor(b), torch.as_tensor(o), torch.as_tensor(d)


@pytest.mark.parametrize("kind", ["far", "axis", "near"])
def test_float_slabs_take_every_box_the_double_slabs_take(kind):
    """The one-level float64 walk's box test, `bvh8._slab_f32` against
    t_min rounded down and upper rounded up to float, takes every box that
    the widened double test (`_slab_hit` against `box_upper`) takes, on
    float boxes (flat ones too) and double rays: from far origins, along
    axes, near the box; at upper equal to the double test's entry into or
    exit from each box (a face), an ulp below it and at random, and at
    t_min 0, 1e-3 and each box's exit."""
    b, o, d = _slab_sweep(kind, 4000, {"far": 31, "axis": 32, "near": 33}[kind])
    inv = bvh8._safe_inv(d)
    entry, exit_ = bvh8._slab(b, o, inv)
    fr = bvh8._float_ray(o, d)
    lo_f, hi_f = bvh8._slab_f32(b, fr)
    rng = np.random.default_rng(34)
    uppers = [entry, exit_, torch.nextafter(entry, torch.full_like(entry, -math.inf)),
              torch.as_tensor(rng.uniform(0.0, 20.0, entry.shape))]
    taken = extra = 0
    for t_min in (torch.tensor(0.0, dtype=F64), torch.tensor(T_MIN, dtype=F64), exit_):
        for upper in uppers:
            double = bvh8._slab_hit(b, o, inv, t_min, bvh8.box_upper(upper))
            single = (lo_f <= hi_f) & (hi_f >= bvh8._to_f32(t_min, up=False)) & (lo_f <= bvh8._to_f32(upper, up=True))
            assert not (double & ~single).any(), f"{int((double & ~single).sum())} boxes taken in double only"
            taken += int(double.sum())
            extra += int((single & ~double).sum())
    assert taken > 20_000 and extra > 0
