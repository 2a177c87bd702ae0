"""The port's instanced meshes against the JAX package.

`build_instanced` must give the reference's arrays exactly. The plain
two-level walks (`tlas8_closest_plain` / `tlas8_occluded_plain`, which
carry the contract of the CUDA kernels in `rpt_tpu_torch/csrc/tlas8.cu`;
the binary two-level walks are in `tests/test_torch_tlas2.py`) are held to
the reference's own bar
(`tests/test_tlas8_pallas.py`): exact hit mask and material id, `t` to
rtol/atol 2e-5, normals to 1e-3, and the any-hit query exactly equal to
`closest.t <= t_max`. The kernels themselves are held against the plain
walks in `tests/test_torch_cuda.py`, which imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rpt_tpu.ops import tlas8_pallas as ref_t8
from rpt_tpu.ops.tlas import build_instanced as ref_build_instanced
from rpt_tpu.ops.tlas import instanced_closest_hit as ref_instanced_closest_hit
from rpt_tpu_torch.ops import bvh8, tlas2, tlas8
from rpt_tpu_torch.ops.tlas import build_instanced
from test_tlas_pallas import _build_instanced_scene, _rays_at_instances
from test_torch_reference_native import reference_native

reference_native()

T_MIN = 1e-3


def _case(n_meshes, n_instances, seed=0, n_rays=333, ray_seed=1, **kw):
    meshes, instances = _build_instanced_scene(n_meshes, n_instances, seed=seed, **kw)
    o, d = _rays_at_instances(n_rays, meshes, instances, seed=ray_seed)
    im = build_instanced(meshes, instances, device="cpu")
    return (meshes, instances), im, (o, d), (torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d)))


def _assert_hits_agree(got, want):
    want_t = np.asarray(want.t)
    hit = np.isfinite(want_t)
    assert hit.sum() > 60, "test geometry too sparse to be meaningful"
    assert (~hit).any()
    np.testing.assert_array_equal(np.isfinite(got.t.numpy()), hit)
    np.testing.assert_allclose(got.t.numpy()[hit], want_t[hit], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(want.normal)[hit], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.mat_id.numpy()[hit], np.asarray(want.mat_id)[hit])


@pytest.mark.parametrize("n_meshes,n_instances", [(1, 5), (3, 17)])
def test_build_instanced_matches_reference(n_meshes, n_instances):
    meshes, instances = _build_instanced_scene(n_meshes, n_instances)
    want = ref_build_instanced(meshes, instances)
    got = build_instanced(meshes, instances, device="cpu")
    assert len(dataclasses.fields(got)) == len(dataclasses.fields(want)) == 16
    for f in dataclasses.fields(want):
        w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name).numpy()
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


@pytest.mark.parametrize("n_meshes,n_instances", [(1, 5), (3, 17)])
def test_closest_matches_reference_walks(n_meshes, n_instances):
    (meshes, instances), im, (o, d), (to, td) = _case(n_meshes, n_instances)
    ref_im = ref_build_instanced(meshes, instances)
    xla = ref_instanced_closest_hit(ref_im, o, d, T_MIN)
    # One 128-ray subgroup per packet: the same per-ray result as the
    # default eight, at a fraction of the interpret-mode trace time.
    pallas = ref_t8.tlas8_closest_hit_pallas(ref_im, o, d, T_MIN, interpret=True, subs=1)
    pack = tlas8.pack_tlas8(im)
    got = tlas8.tlas8_closest_hit(im, pack, to, td, T_MIN)
    _assert_hits_agree(got, xla)
    _assert_hits_agree(got, pallas)


def test_pack_matches_reference_structure():
    """Every instance is a TLAS child exactly once, every BLAS leaf start
    appears, instance roots point past the TLAS part, and the wide tables
    hold the reference's children, instance rows and packed triangles."""
    (meshes, instances), im, _, _ = _case(2, 6, tris_per_mesh=30)
    pack = tlas8.pack_tlas8(im)
    ref_pack = ref_t8.pack_tlas8_for_pallas(ref_build_instanced(meshes, instances))
    ca, cb = bvh8._decode_refs(pack.refs.numpy().astype(np.int64))
    np.testing.assert_array_equal(np.sort(ca[cb == tlas8.INST_CHILD]), np.arange(6))
    leaves = cb > 0
    assert leaves.any()
    n_leaves = int((im.b_leaf_tris[:, 0] >= 0).sum())
    np.testing.assert_array_equal(np.sort(ca[leaves]), 8 * np.arange(n_leaves))
    assert cb[leaves].sum() == int((im.b_leaf_tris >= 0).sum())
    # The same tables as the reference's pack, in the port's layout.
    assert pack.num_nodes == ref_pack.bounds.shape[0]
    np.testing.assert_array_equal(pack.inst_root.numpy(), np.asarray(ref_pack.inst_i))
    np.testing.assert_array_equal(pack.inst.numpy().reshape(-1), np.asarray(ref_pack.inst_f))
    np.testing.assert_array_equal(pack.p_verts.numpy(), np.asarray(ref_pack.p_verts))
    n_tlas = int(pack.inst_root.min())
    assert n_tlas > 0 and (pack.inst_root.numpy() < pack.num_nodes).all()
    inst_nodes = np.flatnonzero((cb == tlas8.INST_CHILD).any(1))
    assert inst_nodes.max() < n_tlas
    meta_ref = np.asarray(ref_pack.meta).reshape(-1, 24)
    # An instance child's payload is its TLAS leaf rank, the reference's its id.
    inst_child = cb == tlas8.INST_CHILD
    ca[inst_child] = pack.rank_inst.numpy()[ca[inst_child]]
    np.testing.assert_array_equal(ca, meta_ref[:, 0:16:2])
    np.testing.assert_array_equal(cb, meta_ref[:, 1:16:2])


@pytest.mark.parametrize("n_meshes,n_instances", [(1, 5), (3, 17)])
def test_stack_need_matches_reference(n_meshes, n_instances, monkeypatch):
    (meshes, instances), im, _, _ = _case(n_meshes, n_instances)
    captured = []
    orig = ref_t8._tlas_stack_need

    def spy(out_nodes, inst_blas_root):
        captured.append(orig(out_nodes, inst_blas_root))
        return captured[-1]

    monkeypatch.setattr(ref_t8, "_tlas_stack_need", spy)
    ref_t8.pack_tlas8_for_pallas(ref_build_instanced(meshes, instances))
    assert tlas8.pack_tlas8(im).stack_need == captured[0]


def test_pack_refuses_a_walk_deeper_than_the_stack(monkeypatch):
    _, im, _, _ = _case(3, 17)
    need = tlas8.pack_tlas8(im).stack_need
    monkeypatch.setattr(tlas8, "STACK_CAP", need - 1)
    with pytest.raises(ValueError, match=f"stack of {need}"):
        tlas8.pack_tlas8(im)


@pytest.mark.parametrize("seed", [7, 8])
def test_occluded_equals_closest_rule(seed):
    _, im, _, (to, td) = _case(2, 11, seed=seed, ray_seed=seed + 1)
    pack = tlas8.pack_tlas8(im)
    closest_t = tlas8.tlas8_closest_hit(im, pack, to, td, T_MIN).t
    t_max = torch.as_tensor(np.random.default_rng(seed).uniform(6.0, 14.0, to.shape[0]), dtype=torch.float32)
    # Include rays whose t_max is exactly their hit time: the interval is closed.
    t_max[:20] = torch.where(torch.isfinite(closest_t[:20]), closest_t[:20], t_max[:20])
    want = (closest_t <= t_max).numpy()
    assert want.any() and (~want).any()
    np.testing.assert_array_equal(tlas8.tlas8_occluded(im, pack, to, td, T_MIN, t_max).numpy(), want)


def test_occluded_closed_at_t_min_and_open_ended_t_max():
    _, im, _, (to, td) = _case(2, 11, seed=7, ray_seed=8)
    pack = tlas8.pack_tlas8(im)
    t = tlas8.tlas8_closest_hit(im, pack, to, td, T_MIN).t
    # t_min equal to a ray's own hit time: the hit still counts, as in the
    # closest-hit walk.
    for i in np.flatnonzero(np.isfinite(t.numpy()))[:4]:
        t_i = float(t[i])
        closest = tlas8.tlas8_closest_hit(im, pack, to, td, t_i).t
        np.testing.assert_array_equal(tlas8.tlas8_occluded(im, pack, to, td, t_i, t_i).numpy(),
                                      (closest <= t_i).numpy())
    # An infinite t_max counts every ray as occluded, hit or miss, as the
    # reference's closest.t <= t_max does.
    occ = tlas8.tlas8_occluded(im, pack, to, td, T_MIN, float("inf"))
    assert occ.all() and not torch.isfinite(t).all()


def test_active_mask_parks_lanes():
    _, im, _, (to, td) = _case(2, 7, seed=5, n_rays=256, ray_seed=6)
    pack = tlas8.pack_tlas8(im)
    active = torch.arange(256) % 2 == 0
    full = tlas8.tlas8_closest_hit(im, pack, to, td, T_MIN)
    got = tlas8.tlas8_closest_hit(im, pack, to, td, T_MIN, active=active)
    assert not torch.isfinite(got.t[1::2]).any()
    np.testing.assert_array_equal(got.t[0::2].numpy(), full.t[0::2].numpy())
    occ = tlas8.tlas8_occluded(im, pack, to, td, T_MIN, 100.0, active=active)
    assert not occ[1::2].any()
    np.testing.assert_array_equal(occ[0::2].numpy(), torch.isfinite(full.t[0::2]).numpy())


@pytest.mark.parametrize("kind", ["closest", "any_hit"])
@pytest.mark.parametrize("seed", [3, 4])
def test_group_walk_properties(seed, kind):
    """On random instanced scenes: `group_depth` is the deepest group stack
    the walk reaches; and the walk equals the binary two-level walk of the
    same trees (`ops/tlas2.py`, the same f32 boxes and triangle rows): t bit
    for bit, triangle and instance ids equal but for ties, or the any-hit
    bool equal."""
    meshes, instances = _build_instanced_scene(3, 60, seed=seed)
    o, d = _rays_at_instances(3000, meshes, instances, seed=seed + 10)
    to, td = torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d))
    im = build_instanced(meshes, instances, device="cpu")
    pack, binary = tlas8.pack_tlas8(im), tlas2.pack_tlas2(im)
    stats = {}
    if kind == "closest":
        t, tri, inst = tlas8.tlas8_closest_plain(pack, to, td, T_MIN, stats=stats)
        t_x, tri_x, inst_x = tlas2.tlas2_closest_plain(binary, to, td, T_MIN)
        hit = t_x < 1e38
        assert hit.sum() > 1000 and (~hit).any()
        np.testing.assert_array_equal(t.numpy(), t_x.numpy())
        assert ((tri != tri_x) | (inst != inst_x))[hit].float().mean() <= 1e-3  # ties: one t, two triangles
    else:
        t_max = torch.as_tensor(np.random.default_rng(seed).uniform(6.0, 14.0, to.shape[0]), dtype=torch.float32)
        occ = tlas8.tlas8_occluded_plain(pack, to, td, T_MIN, t_max, stats=stats)
        occ_x = tlas2.tlas2_occluded_plain(binary, to, td, T_MIN, t_max)
        assert occ_x.any() and (~occ_x).any()
        np.testing.assert_array_equal(occ.numpy(), occ_x.numpy())
    assert pack.group_depth >= 2
    assert stats["max_group_depth"] == pack.group_depth


def test_plain_walk_counts_its_tests():
    _, im, _, (to, td) = _case(3, 17)
    stats = {}
    tlas8.tlas8_closest_plain(tlas8.pack_tlas8(im), to, td, T_MIN, stats=stats)
    assert stats["box_tests"] > to.shape[0]
    assert stats["tri_tests"] > 0 and stats["inst_entries"] > 0
