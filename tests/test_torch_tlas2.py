"""The port's binary two-level skip-link walks against the JAX package.

The plain torch walks (`tlas2_closest_plain`, `tlas2_occluded_plain`) carry
the contract of the CUDA kernels in `rpt_tpu_torch/csrc/tlas2.cu`. Here on the
CPU they are held to the JAX package's binary two-level packet kernel (run
in interpret mode) and to its XLA walk, at the reference's own bar
(`tests/test_tlas_pallas.py`): exact hit mask and material id, `t` to
rtol/atol 2e-5, normals to 1e-3, and the any-hit query exactly equal to
`closest.t <= t_max`. The kernels themselves are held against the plain
walks in `tests/test_torch_cuda.py`, which imports no JAX.
"""

import numpy as np
import pytest
import torch

from rpt_tpu.ops.tlas import build_instanced as ref_build_instanced
from rpt_tpu.ops.tlas import instanced_closest_hit as ref_instanced_closest_hit
from rpt_tpu.ops.tlas_pallas import pack_tlas_for_pallas, tlas_closest_hit_pallas, tlas_occluded_pallas
from rpt_tpu_torch.ops import tlas2, tlas8
from rpt_tpu_torch.ops.tlas import build_instanced
from test_tlas_pallas import _build_instanced_scene, _rays_at_instances

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


def test_pack_holds_the_reference_tables():
    """The reference's binary two-level tables (`pack_tlas_for_pallas`), in
    the port's row layout: node boxes, skip links, instance leaves, BLAS
    leaf rows and counts, instance rows and ranges, packed triangles."""
    (meshes, instances), im, _, _ = _case(2, 6, tris_per_mesh=30)
    pack = tlas2.pack_tlas2(im)
    ref = pack_tlas_for_pallas(ref_build_instanced(meshes, instances))
    np.testing.assert_array_equal(pack.t_bounds.numpy(), np.asarray(ref.t_bounds).reshape(-1, 8))
    np.testing.assert_array_equal(pack.t_meta.numpy(), np.asarray(ref.t_meta).reshape(-1, 4))
    np.testing.assert_array_equal(pack.b_bounds.numpy(), np.asarray(ref.b_bounds).reshape(-1, 8))
    np.testing.assert_array_equal(pack.b_meta.numpy(), np.asarray(ref.b_meta).reshape(-1, 4))
    np.testing.assert_array_equal(pack.inst.numpy().reshape(-1), np.asarray(ref.inst_f))
    np.testing.assert_array_equal(pack.inst_range.numpy(), np.asarray(ref.inst_i).reshape(-1, 4)[:, :2])
    np.testing.assert_array_equal(pack.p_verts.numpy(), np.asarray(ref.p_verts))
    # The wide pack keeps the same packed triangle rows: one finalize for both.
    np.testing.assert_array_equal(pack.tris.numpy(), tlas8.pack_tlas8(im).tris.numpy())


@pytest.mark.parametrize("n_meshes,n_instances", [(1, 5), (3, 17)])
def test_closest_matches_reference_walks(n_meshes, n_instances):
    (meshes, instances), im, (o, d), (to, td) = _case(n_meshes, n_instances)
    ref_im = ref_build_instanced(meshes, instances)
    xla = ref_instanced_closest_hit(ref_im, o, d, T_MIN)
    # One 128-ray subgroup per packet: the same per-ray result as the
    # default eight, at a fraction of the interpret-mode trace time.
    pallas = tlas_closest_hit_pallas(ref_im, o, d, T_MIN, interpret=True, subs=1)
    got = tlas2.tlas2_closest_hit(im, tlas2.pack_tlas2(im), to, td, T_MIN)
    _assert_hits_agree(got, xla)
    _assert_hits_agree(got, pallas)


def test_closest_equals_the_wide_walk():
    """Both two-level kernels' plain walks find the same hit: the same t
    (one triangle test), triangle row and instance, ties apart."""
    _, im, _, (to, td) = _case(3, 17, seed=2, n_rays=1024, ray_seed=3)
    t2, id2, k2 = tlas2.tlas2_closest_plain(tlas2.pack_tlas2(im), to, td, T_MIN)
    t8, id8, k8 = tlas8.tlas8_closest_plain(tlas8.pack_tlas8(im), to, td, T_MIN)
    assert torch.equal(t2, t8)
    hit = t2 < 1e38
    assert ((id2 == id8) & (k2 == k8))[hit].float().mean() > 0.999


@pytest.mark.parametrize("seed", [7, 8])
def test_occluded_equals_closest_rule(seed):
    (meshes, instances), im, (o, d), (to, td) = _case(2, 11, seed=seed, ray_seed=seed + 1)
    pack = tlas2.pack_tlas2(im)
    closest_t = tlas2.tlas2_closest_hit(im, pack, to, td, T_MIN).t
    t_max = torch.as_tensor(np.random.default_rng(seed).uniform(6.0, 14.0, to.shape[0]), dtype=torch.float32)
    # Include rays whose t_max is exactly their hit time: the interval is closed.
    t_max[:20] = torch.where(torch.isfinite(closest_t[:20]), closest_t[:20], t_max[:20])
    want = (closest_t <= t_max).numpy()
    assert want.any() and (~want).any()
    got = tlas2.tlas2_occluded(im, pack, to, td, T_MIN, t_max)
    np.testing.assert_array_equal(got.numpy(), want)
    # The reference's binary two-level any-hit kernel agrees, apart from the
    # rays whose t_max is their own hit time to the last bit.
    ref = tlas_occluded_pallas(ref_build_instanced(meshes, instances), o, d, T_MIN, t_max.numpy(),
                               interpret=True, subs=1)
    np.testing.assert_array_equal(got.numpy()[20:], np.asarray(ref)[20:])


def test_occluded_closed_at_t_min_and_open_ended_t_max():
    _, im, _, (to, td) = _case(2, 11, seed=7, ray_seed=8)
    pack = tlas2.pack_tlas2(im)
    t = tlas2.tlas2_closest_hit(im, pack, to, td, T_MIN).t
    for i in np.flatnonzero(np.isfinite(t.numpy()))[:4]:
        t_i = float(t[i])
        closest = tlas2.tlas2_closest_hit(im, pack, to, td, t_i).t
        np.testing.assert_array_equal(tlas2.tlas2_occluded(im, pack, to, td, t_i, t_i).numpy(),
                                      (closest <= t_i).numpy())
    occ = tlas2.tlas2_occluded(im, pack, to, td, T_MIN, float("inf"))
    assert occ.all() and not torch.isfinite(t).all()


def test_active_mask_parks_lanes():
    _, im, _, (to, td) = _case(2, 7, seed=5, n_rays=256, ray_seed=6)
    pack = tlas2.pack_tlas2(im)
    active = torch.arange(256) % 2 == 0
    full = tlas2.tlas2_closest_hit(im, pack, to, td, T_MIN)
    got = tlas2.tlas2_closest_hit(im, pack, to, td, T_MIN, active=active)
    assert not torch.isfinite(got.t[1::2]).any()
    np.testing.assert_array_equal(got.t[0::2].numpy(), full.t[0::2].numpy())
    occ = tlas2.tlas2_occluded(im, pack, to, td, T_MIN, 100.0, active=active)
    assert not occ[1::2].any()
    np.testing.assert_array_equal(occ[0::2].numpy(), torch.isfinite(full.t[0::2]).numpy())


def test_plain_walk_counts_its_tests():
    _, im, _, (to, td) = _case(3, 17)
    stats = {}
    tlas2.tlas2_closest_plain(tlas2.pack_tlas2(im), to, td, T_MIN, stats=stats)
    assert stats["box_tests"] > to.shape[0]
    assert stats["tri_tests"] > 0 and stats["inst_entries"] > 0
