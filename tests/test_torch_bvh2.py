"""The port's binary child-pair walks against the JAX package.

The plain torch walks (`bvh2_closest_plain`, `bvh2_occluded_plain`) carry
the contract of the CUDA kernels in `rpt_tpu_torch/csrc/bvh2.cu`. Here on the
CPU they are held to the JAX package's binary packet kernel (run in
interpret mode) and to its XLA walk, at the reference's own parity bar
(`tests/test_bvh_pallas.py`): exact hit mask and material id, `t` to
rtol/atol 2e-5, and the any-hit query exactly equal to `closest.t <= t_max`;
also where every hit is a tie between coincident triangles in two leaves
that the near-first walk reaches in the other order. The pack is held to
the tree, the stack depth to the tree's longest far chain. The kernels
themselves are held against the plain walks in `tests/test_torch_cuda.py`,
which imports no JAX.
"""

import numpy as np
import pytest
import torch

from rpt_tpu.ops.bvh import build_bvh as ref_build_bvh
from rpt_tpu.ops.bvh import bvh_closest_hit as ref_bvh_closest_hit
from rpt_tpu.ops.bvh_pallas import bvh_closest_hit_pallas, bvh_occluded_pallas
from rpt_tpu_torch.ops import bvh2, bvh8
from rpt_tpu_torch.ops.bvh import build_bvh
from rpt_tpu_torch.ops.bvh8 import KIND_LEAF, KIND_NODE
import walk_scenes
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
    assert hit.sum() > 50 and (~hit).any()
    np.testing.assert_array_equal(np.isfinite(got.t.numpy()), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], want_t[hit], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.mat_id.numpy()[hit], want_mat[hit])


def test_pack_holds_the_tree_in_preorder():
    """One pair node per internal node of the tree, in preorder, holding its
    two children's boxes and references (a pair node, or a leaf's 8-aligned
    triangle rows); every leaf appears once; the triangle rows are the wide
    pack's."""
    _, bvh, _, _ = _case(500, seed=2)
    pack = bvh2.pack_bvh2(bvh)
    skip, leaf = bvh.skip.numpy(), bvh.leaf_count.numpy() > 0
    start, count = bvh.leaf_start.numpy(), bvh.leaf_count.numpy()
    internal = np.flatnonzero(~leaf)
    assert pack.nodes.shape == (internal.size, 16) and pack.node_bytes == 64
    assert pack.tris.shape == (bvh.num_tris, 20)
    pair_of = {int(i): k for k, i in enumerate(internal)}
    refs = pack.refs.numpy()
    seen = []
    for k, i in enumerate(internal):
        for slot, c in enumerate((i + 1, skip[i + 1])):
            box = pack.nodes[k, 6 * slot:6 * slot + 6].numpy()
            np.testing.assert_array_equal(box, np.concatenate([bvh.node_min[c].numpy(), bvh.node_max[c].numpy()]))
            if leaf[c]:
                assert start[c] % 8 == 0 and 0 < count[c] <= 8
                assert refs[k, slot] == ((start[c] // 8) << 3 | (count[c] - 1)) << 2 | KIND_LEAF
                seen.append(c)
            else:
                assert refs[k, slot] == pair_of[int(c)] << 2 | KIND_NODE
    assert sorted(seen) == np.flatnonzero(leaf).tolist()
    # The tie key: the leaves' rows rise in preorder.
    assert (np.diff(start[leaf]) > 0).all()
    # The same triangle rows as the wide pack: one triangle test for all kernels.
    np.testing.assert_array_equal(pack.tris.numpy(), bvh8.pack_bvh8(bvh).tris.numpy())


def _far_chain(bvh) -> int:
    """The longest chain of far children of the binary tree as built: a node
    whose two children are both internal pushes one of them."""
    skip, leaf = bvh.skip.numpy(), bvh.leaf_count.numpy() > 0

    def need(i):
        if leaf[i]:
            return 0
        kids = [c for c in (i + 1, skip[i + 1]) if not leaf[c]]
        return (len(kids) == 2) + max(map(need, kids), default=0)

    return need(0)


@pytest.mark.parametrize("n_tris,seed", [(40, 7), (300, 8), (2000, 9)])
def test_stack_depth_is_the_longest_far_chain(n_tris, seed):
    _, bvh, _, (to, td) = _case(n_tris, seed=seed, n_rays=1000, ray_seed=seed + 1)
    pack = bvh2.pack_bvh2(bvh)
    assert pack.stack_depth == _far_chain(bvh) >= 1
    stats = {}
    bvh2.bvh2_closest_plain(pack, to, td, T_MIN, stats=stats)
    bvh2.bvh2_occluded_plain(pack, to, td, T_MIN, torch.full((to.shape[0],), 30.0), stats=stats)
    assert 1 <= stats["max_stack_depth"] <= pack.stack_depth


def test_single_leaf_tree():
    """A tree that is one leaf is one pair node: the leaf and an empty slot,
    no stack; it walks as the reference does."""
    (verts, norms, mats), bvh, (o, d), (to, td) = _case(5, seed=4, n_rays=400)
    pack = bvh2.pack_bvh2(bvh)
    assert bvh.num_nodes == 1 and pack.num_nodes == 1 and pack.stack_depth == 0
    assert pack.refs[0, 0] == (0 << 3 | 4) << 2 | KIND_LEAF and pack.refs[0, 1] == 0
    ref_bvh = ref_build_bvh(verts, norms, mats)
    xla = ref_bvh_closest_hit(ref_bvh, o, d, T_MIN)
    got = bvh2.bvh2_closest_hit(bvh, pack, to, td, T_MIN)
    want_t = np.asarray(xla.t)
    hit = np.isfinite(want_t)
    assert hit.sum() > 20 and (~hit).any()
    np.testing.assert_array_equal(np.isfinite(got.t.numpy()), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], want_t[hit], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.mat_id.numpy()[hit], np.asarray(xla.mat_id)[hit])
    t_max = torch.full((to.shape[0],), 100.0)
    np.testing.assert_array_equal(bvh2.bvh2_occluded(bvh, pack, to, td, T_MIN, t_max).numpy(), hit)


_twin_leaves = walk_scenes.twin_leaves


def test_coincident_triangles_in_two_leaves_keep_the_reference_tie():
    """Every hit on a twin is a tie in t between two leaves, which the
    reference breaks by its preorder walk: the first leaf's triangle (its
    material 0, the twin's 1). The near-first walk reaches the twin first
    and must still return the reference's triangle, equal to its XLA walk
    and Pallas kernel on every hit."""
    verts, norms, mats, o, d = _twin_leaves(24, seed=21)
    bvh = build_bvh(verts, norms, mats, device="cpu")
    pack = bvh2.pack_bvh2(bvh)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    got = bvh2.bvh2_closest_hit(bvh, pack, to, td, T_MIN)
    ref_bvh = ref_build_bvh(verts, norms, mats)
    xla = ref_bvh_closest_hit(ref_bvh, o, d, T_MIN)
    _assert_hits_agree(got, np.asarray(xla.t), np.asarray(xla.mat_id))
    pallas = bvh_closest_hit_pallas(ref_bvh, o, d, T_MIN, interpret=True, subs=1)
    _assert_hits_agree(got, np.asarray(pallas.t), np.asarray(pallas.mat_id))
    mat = got.mat_id.numpy()[torch.isfinite(got.t).numpy()]
    assert (mat == 0).mean() > 0.9 and not (mat == 1).any()


@pytest.mark.parametrize("n_tris", [40, 300, 2000])
def test_closest_matches_reference_walks(n_tris):
    (verts, norms, mats), bvh, (o, d), (to, td) = _case(n_tris)
    ref_bvh = ref_build_bvh(verts, norms, mats)
    xla = ref_bvh_closest_hit(ref_bvh, o, d, T_MIN)
    # One 128-ray subgroup per packet: the same per-ray result as the default
    # eight, at a fraction of the interpret-mode trace time.
    pallas = bvh_closest_hit_pallas(ref_bvh, o, d, T_MIN, interpret=True, subs=1)
    got = bvh2.bvh2_closest_hit(bvh, bvh2.pack_bvh2(bvh), to, td, T_MIN)
    _assert_hits_agree(got, np.asarray(xla.t), np.asarray(xla.mat_id))
    _assert_hits_agree(got, np.asarray(pallas.t), np.asarray(pallas.mat_id))
    hit = np.isfinite(np.asarray(xla.t))
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(xla.normal)[hit], rtol=1e-3, atol=1e-3)


def test_closest_equals_the_wide_walk():
    """Both kernels' plain walks find the same hit: same t (one triangle
    test) and the same triangle, ties apart."""
    _, bvh, _, (to, td) = _case(2000, seed=3, n_rays=1024, ray_seed=4)
    t2, id2 = bvh2.bvh2_closest_plain(bvh2.pack_bvh2(bvh), to, td, T_MIN)
    t8, id8 = bvh8.bvh8_closest_plain(bvh8.pack_bvh8(bvh), to, td, T_MIN)
    assert torch.equal(t2, t8)
    hit = t2 < 1e38
    assert (id2[hit] == id8[hit]).float().mean() > 0.999


@pytest.mark.parametrize("seed", [5, 6])
def test_occluded_equals_closest_rule(seed):
    (verts, norms, mats), bvh, (o, d), (to, td) = _case(400, seed=seed, ray_seed=seed + 1)
    pack = bvh2.pack_bvh2(bvh)
    closest_t = bvh2.bvh2_closest_hit(bvh, pack, to, td, T_MIN).t
    t_max = torch.as_tensor(np.random.default_rng(seed).uniform(2.0, 6.0, to.shape[0]), dtype=torch.float32)
    # Include rays whose t_max is exactly their hit time: the interval is closed.
    t_max[:20] = torch.where(torch.isfinite(closest_t[:20]), closest_t[:20], t_max[:20])
    want = (closest_t <= t_max).numpy()
    assert want.any() and (~want).any()
    got = bvh2.bvh2_occluded(bvh, pack, to, td, T_MIN, t_max)
    np.testing.assert_array_equal(got.numpy(), want)
    # The reference's binary any-hit kernel gives the same answer, apart from
    # the rays whose t_max is their own hit time to the last bit (its f32
    # rounding of t may differ in the last place).
    ref = bvh_occluded_pallas(ref_build_bvh(verts, norms, mats), o, d, T_MIN, t_max.numpy(), interpret=True, subs=1)
    np.testing.assert_array_equal(got.numpy()[20:], np.asarray(ref)[20:])


def test_occluded_closed_at_t_min_and_open_ended_t_max():
    _, bvh, _, (to, td) = _case(400, seed=5, ray_seed=6)
    pack = bvh2.pack_bvh2(bvh)
    t = bvh2.bvh2_closest_hit(bvh, pack, to, td, T_MIN).t
    # t_min equal to a ray's own hit time: the hit still counts, as in the
    # closest-hit walk.
    for i in np.flatnonzero(np.isfinite(t.numpy()))[:8]:
        t_i = float(t[i])
        closest = bvh2.bvh2_closest_hit(bvh, pack, to, td, t_i).t
        np.testing.assert_array_equal(bvh2.bvh2_occluded(bvh, pack, to, td, t_i, t_i).numpy(),
                                      (closest <= t_i).numpy())
    # An infinite t_max (a directional light's distance) counts every ray as
    # occluded, hit or miss, as closest.t <= inf does.
    occ = bvh2.bvh2_occluded(bvh, pack, to, td, T_MIN, float("inf"))
    assert occ.all() and not torch.isfinite(t).all()


def test_active_mask_parks_lanes():
    _, bvh, _, (to, td) = _case(100, n_rays=256)
    pack = bvh2.pack_bvh2(bvh)
    active = torch.arange(256) % 2 == 0
    full = bvh2.bvh2_closest_hit(bvh, pack, to, td, T_MIN)
    got = bvh2.bvh2_closest_hit(bvh, pack, to, td, T_MIN, active=active)
    assert not torch.isfinite(got.t[1::2]).any()
    np.testing.assert_array_equal(got.t[0::2].numpy(), full.t[0::2].numpy())
    occ = bvh2.bvh2_occluded(bvh, pack, to, td, T_MIN, 100.0, active=active)
    assert not occ[1::2].any()
    np.testing.assert_array_equal(occ[0::2].numpy(), torch.isfinite(full.t[0::2]).numpy())


def test_plain_walk_counts_its_tests():
    _, bvh, _, (to, td) = _case(300)
    pack = bvh2.pack_bvh2(bvh)
    stats, stats_occ = {}, {}
    bvh2.bvh2_closest_plain(pack, to, td, T_MIN, stats=stats)
    # Every ray tests at least the root; every hit tested a leaf.
    assert stats["box_tests"] > to.shape[0] and stats["tri_tests"] > 0
    bvh2.bvh2_occluded_plain(pack, to, td, T_MIN, torch.full((to.shape[0],), 100.0), stats=stats_occ)
    # The any-hit walk stops at its first occluder: it tests no more.
    assert stats_occ["box_tests"] <= stats["box_tests"] and stats_occ["tri_tests"] <= stats["tri_tests"]
