"""The port's BVH build and wide-BVH walks against the JAX package.

The plain torch walks (`bvh8_closest_plain`, `bvh8_occluded_plain`) carry
the contract of the CUDA kernels in `rpt_tpu_torch/csrc/bvh8.cu`. Here on the
CPU they are held to the JAX package's own parity bar
(`tests/test_bvh8_pallas.py`): exact hit mask and material id, `t` to
rtol/atol 2e-5, and the any-hit query exactly equal to `closest.t <= t_max`.
The kernels themselves are held against the plain walks in
`tests/test_torch_cuda.py`, which imports no JAX so that it runs on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rpt_tpu.ops.bvh import build_bvh as ref_build_bvh
from rpt_tpu.ops.bvh import bvh_closest_hit as ref_bvh_closest_hit
from rpt_tpu.ops.bvh8_pallas import bvh8_closest_hit_pallas
from rpt_tpu_torch.ops import bvh2, bvh8
from rpt_tpu_torch.ops.bvh import build_bvh
from test_bvh_pallas import _random_mesh, _rays_at_mesh
from test_torch_reference_native import reference_native

reference_native()

T_MIN = 1e-3


def _case(n_tris, seed=0, n_rays=333, ray_seed=1):
    verts, norms, mats = _random_mesh(n_tris, seed=seed)
    o, d = _rays_at_mesh(n_rays, verts, seed=ray_seed)
    bvh = build_bvh(verts, norms, mats, device="cpu")
    return (verts, norms, mats), bvh, (o, d), (torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d)))


def _assert_hits_agree(got, want_t, want_mat):
    hit = np.isfinite(want_t)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(np.isfinite(got.t.numpy()), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], want_t[hit], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.mat_id.numpy()[hit], want_mat[hit])


@pytest.mark.parametrize("n_tris", [5, 64, 300, 2000])
def test_build_bvh_matches_reference(n_tris):
    verts, norms, mats = _random_mesh(n_tris, seed=n_tris)
    want = ref_build_bvh(verts, norms, mats)
    got = build_bvh(verts, norms, mats, device="cpu")
    for f in dataclasses.fields(want):
        w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name).numpy()
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_pack_covers_every_leaf_once():
    _, bvh, _, _ = _case(500, seed=2)
    pack = bvh8.pack_bvh8(bvh)
    starts, counts = bvh8._decode_refs(pack.refs.numpy().astype(np.int64))
    leaf_count = bvh.leaf_count.numpy()
    want = bvh.leaf_start.numpy()[leaf_count > 0]
    np.testing.assert_array_equal(np.sort(starts[counts > 0]), np.sort(want))
    assert counts[counts > 0].sum() == leaf_count.sum()
    # Internal children point at later wide nodes (DFS order).
    internal = counts == 0
    rows = np.nonzero(internal)[0]
    assert (starts[internal] > rows).all()
    assert 1 <= pack.stack_need <= bvh8.STACK_CAP


def test_pack_refuses_a_tree_deeper_than_the_stack(monkeypatch):
    _, bvh, _, _ = _case(800, seed=9)
    monkeypatch.setattr(bvh8, "STACK_CAP", 1)
    with pytest.raises(ValueError, match="stack"):
        bvh8.pack_bvh8(bvh)


@pytest.mark.parametrize("n_tris", [5, 40, 300])
def test_closest_matches_reference_walks(n_tris):
    (verts, norms, mats), bvh, (o, d), (to, td) = _case(n_tris)
    ref_bvh = ref_build_bvh(verts, norms, mats)
    xla = ref_bvh_closest_hit(ref_bvh, o, d, T_MIN)
    # One 128-ray subgroup per packet: the same per-ray result as the default
    # eight, at a third of the interpret-mode trace time.
    pallas = bvh8_closest_hit_pallas(ref_bvh, o, d, T_MIN, interpret=True, subs=1)
    got = bvh8.bvh8_closest_hit(bvh, bvh8.pack_bvh8(bvh), to, td, T_MIN)
    _assert_hits_agree(got, np.asarray(xla.t), np.asarray(xla.mat_id))
    _assert_hits_agree(got, np.asarray(pallas.t), np.asarray(pallas.mat_id))


def test_closest_normals_match_reference():
    (verts, norms, mats), bvh, (o, d), (to, td) = _case(300, seed=4)
    xla = ref_bvh_closest_hit(ref_build_bvh(verts, norms, mats), o, d, T_MIN)
    got = bvh8.bvh8_closest_hit(bvh, bvh8.pack_bvh8(bvh), to, td, T_MIN)
    hit = np.isfinite(np.asarray(xla.t))
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(xla.normal)[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [5, 6])
def test_occluded_equals_closest_rule(seed):
    _, bvh, _, (to, td) = _case(400, seed=seed, ray_seed=seed + 1)
    pack = bvh8.pack_bvh8(bvh)
    closest_t = bvh8.bvh8_closest_hit(bvh, pack, to, td, T_MIN).t
    t_max = torch.as_tensor(np.random.default_rng(seed).uniform(2.0, 6.0, to.shape[0]), dtype=torch.float32)
    # Include rays whose t_max is exactly their hit time: the interval is closed.
    t_max[:20] = torch.where(torch.isfinite(closest_t[:20]), closest_t[:20], t_max[:20])
    want = (closest_t <= t_max).numpy()
    assert want.any() and (~want).any()
    got = bvh8.bvh8_occluded(bvh, pack, to, td, T_MIN, t_max)
    np.testing.assert_array_equal(got.numpy(), want)


def test_active_mask_parks_lanes():
    _, bvh, _, (to, td) = _case(100, n_rays=256)
    pack = bvh8.pack_bvh8(bvh)
    active = torch.arange(256) % 2 == 0
    full = bvh8.bvh8_closest_hit(bvh, pack, to, td, T_MIN)
    got = bvh8.bvh8_closest_hit(bvh, pack, to, td, T_MIN, active=active)
    assert not torch.isfinite(got.t[1::2]).any()
    np.testing.assert_array_equal(got.t[0::2].numpy(), full.t[0::2].numpy())
    occ = bvh8.bvh8_occluded(bvh, pack, to, td, T_MIN, 100.0, active=active)
    assert not occ[1::2].any()
    np.testing.assert_array_equal(occ[0::2].numpy(), torch.isfinite(full.t[0::2]).numpy())


def test_plain_walk_counts_its_tests():
    _, bvh, _, (to, td) = _case(300)
    stats = {}
    bvh8.bvh8_closest_plain(bvh8.pack_bvh8(bvh), to, td, T_MIN, stats=stats)
    assert stats["box_tests"] > to.shape[0] and stats["tri_tests"] > 0


@pytest.mark.parametrize("kind", ["closest", "any_hit"])
@pytest.mark.parametrize("n_tris,seed", [(40, 11), (700, 12), (3000, 13)])
def test_group_walk_equals_the_exact_walk(n_tris, seed, kind):
    """The node-group walk (the kernels' plain version) against the binary
    child-pair walk of the same tree (`ops/bvh2.py`), which tests the same
    f32 boxes two at a time and the same triangle rows: t bit for bit
    and triangle ids equal but for ties, or the any-hit bool equal."""
    _, bvh, _, (to, td) = _case(n_tris, seed=seed, n_rays=2000, ray_seed=seed + 1)
    pack, binary = bvh8.pack_bvh8(bvh), bvh2.pack_bvh2(bvh)
    active = torch.arange(to.shape[0]) % 5 != 0
    if kind == "closest":
        t, tri = bvh8.bvh8_closest_plain(pack, to, td, T_MIN, active)
        t_x, tri_x = bvh2.bvh2_closest_plain(binary, to, td, T_MIN, active)
        hit = t_x < 1e38
        assert hit.any() and (~hit[active]).any()
        np.testing.assert_array_equal(t.numpy(), t_x.numpy())
        assert (tri != tri_x)[hit].float().mean() <= 1e-3  # a tie: two triangles at one t
    else:
        t_max = torch.as_tensor(np.random.default_rng(seed).uniform(1.0, 6.0, to.shape[0]), dtype=torch.float32)
        occ = bvh8.bvh8_occluded_plain(pack, to, td, T_MIN, t_max, active)
        occ_x = bvh2.bvh2_occluded_plain(binary, to, td, T_MIN, t_max, active)
        assert occ_x.any() and (~occ_x[active]).any()
        np.testing.assert_array_equal(occ.numpy(), occ_x.numpy())


def test_group_depth_is_exact():
    """`group_depth` is the deepest group stack the walk reaches on rays
    from every side of a random mesh, and never above `stack_need`."""
    _, bvh, _, (to, td) = _case(2000, seed=2, n_rays=3000, ray_seed=3)
    pack = bvh8.pack_bvh8(bvh)
    stats = {}
    bvh8.bvh8_closest_plain(pack, to, td, T_MIN, stats=stats)
    assert pack.group_depth >= 3
    assert stats["max_group_depth"] == pack.group_depth <= pack.stack_need


def test_pack_refuses_ids_that_overflow_the_references(monkeypatch):
    _, bvh, _, _ = _case(300, seed=4)
    monkeypatch.setattr(bvh8, "_MAX_NODES", bvh8.pack_bvh8(bvh).num_nodes)
    with pytest.raises(bvh8.WidePackRefused, match="overflow"):
        bvh8.pack_bvh8(bvh)



def test_occluded_closed_at_t_min_and_open_ended_t_max():
    _, bvh, _, (to, td) = _case(400, seed=5, ray_seed=6)
    pack = bvh8.pack_bvh8(bvh)
    t = bvh8.bvh8_closest_hit(bvh, pack, to, td, T_MIN).t
    # t_min equal to a ray's own hit time: the hit still counts, as in the
    # closest-hit walk.
    for i in np.flatnonzero(np.isfinite(t.numpy()))[:8]:
        t_i = float(t[i])
        closest = bvh8.bvh8_closest_hit(bvh, pack, to, td, t_i).t
        np.testing.assert_array_equal(bvh8.bvh8_occluded(bvh, pack, to, td, t_i, t_i).numpy(),
                                      (closest <= t_i).numpy())
    # An infinite t_max (a directional light's distance) counts every ray as
    # occluded, hit or miss: closest.t <= inf holds for a miss's t = inf too.
    occ = bvh8.bvh8_occluded(bvh, pack, to, td, T_MIN, float("inf"))
    assert occ.all() and not torch.isfinite(t).all()
