"""The port's binary two-level walk (near first over child-pair nodes)
against the JAX package.

The plain torch walks (`tlas2_closest_plain`, `tlas2_occluded_plain`) carry
the contract of the CUDA kernels in `rpt_tpu_torch/csrc/tlas2.cu`. Here on the
CPU they are held to the JAX package's binary two-level packet kernel (run
in interpret mode) and to its XLA walk, at the reference's own bar
(`tests/test_tlas_pallas.py`): exact hit mask and material id, `t` to
rtol/atol 2e-5, normals to 1e-3, and the any-hit query exactly equal to
`closest.t <= t_max`; also where every hit is a tie between two coincident
instances. The pack is held to the reference's tables, the stack depth to
the trees, and the launch plan to its three branches. The kernels
themselves are held against the plain walks in `tests/test_torch_cuda.py`,
which imports no JAX.
"""

import numpy as np
import pytest
import torch

from rpt_tpu.ops.tlas import build_instanced as ref_build_instanced
from rpt_tpu.ops.tlas import instanced_closest_hit as ref_instanced_closest_hit
from rpt_tpu.ops.tlas_pallas import pack_tlas_for_pallas, tlas_closest_hit_pallas, tlas_occluded_pallas
from rpt_tpu_torch.ops import tlas2, tlas8, walk
from rpt_tpu_torch.ops.bvh8 import KIND_INST, KIND_LEAF, KIND_NODE
from rpt_tpu_torch.ops.tlas import build_instanced
from test_tlas_pallas import _build_instanced_scene, _FakeMesh, _rays_at_instances
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


def test_pack_holds_the_reference_tables():
    """The pair nodes decode to the reference's binary two-level tables
    (`pack_tlas_for_pallas`): every internal node, TLAS first, in preorder,
    holds its two children's boxes and kinds (a node, an instance, or a
    leaf's triangle rows); every instance and every BLAS leaf appears once;
    the instance records hold the reference's rows by TLAS leaf rank; the
    triangle rows are the wide pack's."""
    (meshes, instances), im, _, _ = _case(2, 6, tris_per_mesh=30)
    pack = tlas2.pack_tlas2(im)
    ref = pack_tlas_for_pallas(ref_build_instanced(meshes, instances))
    t_bounds, t_meta = np.asarray(ref.t_bounds).reshape(-1, 8), np.asarray(ref.t_meta).reshape(-1, 4)
    b_bounds, b_meta = np.asarray(ref.b_bounds).reshape(-1, 8), np.asarray(ref.b_meta).reshape(-1, 4)
    inst_f, inst_i = np.asarray(ref.inst_f).reshape(-1, 12), np.asarray(ref.inst_i).reshape(-1, 4)
    rec = pack.nodes.numpy()
    refs = pack.refs.numpy().astype(np.int64)
    kind, payload = refs & 3, refs >> 2
    rank_root, rank_inst = pack.inst_rows.numpy()[:, 12:14].view(np.int32).T
    # Binary node -> pair node: the internal nodes in preorder, TLAS first
    # (both trees' roots are internal here, so no root is wrapped).
    t_int, b_int = t_meta[:, 1] < 0, b_meta[:, 2] == 0
    t_pid, b_pid = np.cumsum(t_int) - 1, t_int.sum() + np.cumsum(b_int) - 1
    assert (pack.n_tlas, pack.num_nodes) == (t_int.sum(), t_int.sum() + b_int.sum())
    np.testing.assert_array_equal(rank_inst, t_meta[~t_int, 1])  # ranks: TLAS leaves in preorder
    for bounds, meta, internal, pid, tlas in ((t_bounds, t_meta, t_int, t_pid, True),
                                              (b_bounds, b_meta, b_int, b_pid, False)):
        for i in np.flatnonzero(internal):
            p = pid[i]
            for s, c in enumerate((i + 1, meta[i + 1, 0])):
                np.testing.assert_array_equal(rec[p, 6 * s:6 * s + 6], bounds[c, :6])
                if internal[c]:
                    assert (kind[p, s], payload[p, s]) == (KIND_NODE, pid[c])
                elif tlas:
                    assert kind[p, s] == KIND_INST and rank_inst[payload[p, s]] == meta[c, 1]
                else:
                    assert kind[p, s] == KIND_LEAF
                    assert ((payload[p, s] >> 3) * 8, (payload[p, s] & 7) + 1) == (meta[c, 1], meta[c, 2])
    np.testing.assert_array_equal(np.sort(rank_inst[payload[kind == KIND_INST]]), np.arange(6))
    np.testing.assert_array_equal(np.sort(payload[kind == KIND_LEAF] >> 3) * 8, np.sort(b_meta[~b_int, 1]))
    np.testing.assert_array_equal(pack.inst_rows.numpy()[:, :12], inst_f[rank_inst])
    np.testing.assert_array_equal(rank_root, b_pid[inst_i[rank_inst, 0]])
    np.testing.assert_array_equal(pack.inst.numpy(), inst_f)
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
    pack = tlas2.pack_tlas2(im)
    tlas2.tlas2_closest_plain(pack, to, td, T_MIN, stats=stats)
    assert stats["box_tests"] > to.shape[0]
    assert stats["tri_tests"] > 0 and stats["inst_entries"] > 0
    assert 0 < stats["max_stack_depth"] <= pack.stack_depth


@pytest.mark.parametrize("copy", ["same_mesh", "wider_mesh"])
def test_coincident_instances_keep_the_reference_tie(copy):
    """Every instance has a twin under the same transform with another
    material, so every hit is a tie in t between the two, which the
    reference breaks by its preorder visit order. The twin is an instance
    of the same mesh, or of a mesh that holds the same triangles and a
    displaced copy (a wider box, so the near-first walk often reaches the
    twin that comes later in preorder first). The material ids must equal
    the reference's XLA walk and Pallas kernel on every hit."""
    meshes, base = _build_instanced_scene(2, 7, seed=11)
    twin_mesh = 0
    if copy == "wider_mesh":
        v, n = meshes[0].vertices, meshes[0].normals
        meshes = meshes + [_FakeMesh(np.concatenate([v, v + np.array([1.2, 0.0, 0.0])]), np.concatenate([n, n]))]
        twin_mesh = 2
    instances = base + [(twin_mesh if k == 0 else k, m, (mat + 1) % 4) for k, m, mat in base]
    o, d = _rays_at_instances(400, meshes, instances, seed=12)
    im = build_instanced(meshes, instances, device="cpu")
    to, td = torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d))
    ref_im = ref_build_instanced(meshes, instances)
    got = tlas2.tlas2_closest_hit(im, tlas2.pack_tlas2(im), to, td, T_MIN)
    _assert_hits_agree(got, ref_instanced_closest_hit(ref_im, o, d, T_MIN))
    _assert_hits_agree(got, tlas_closest_hit_pallas(ref_im, o, d, T_MIN, interpret=True, subs=1))
    if copy == "wider_mesh":  # the ties go both ways
        _, _, inst = tlas2.tlas2_closest_plain(tlas2.pack_tlas2(im), to, td, T_MIN)
        twin = (inst >= len(base))[torch.isfinite(got.t)].float().mean()
        assert 0.1 < twin < 0.9


def _far_chain(im) -> int:
    """The longest chain of far children of the binary trees as built: a
    TLAS node pushes one of its two children (both are nodes or instances),
    a BLAS node one of two internal children; an instance leads into its
    BLAS root."""
    t_skip, t_inst = im.t_skip.numpy(), im.t_leaf_inst.numpy()
    b_skip, b_leaf = im.b_skip.numpy(), im.b_is_leaf.numpy().astype(bool)
    roots = im.inst_root.numpy()

    def blas(i):
        if b_leaf[i]:
            return 0
        kids = [c for c in (i + 1, b_skip[i + 1]) if not b_leaf[c]]
        return (len(kids) == 2) + max(map(blas, kids), default=0)

    def tlas(i):
        if t_inst[i] >= 0:
            return blas(roots[t_inst[i]])
        return 1 + max(tlas(i + 1), tlas(t_skip[i + 1]))

    return tlas(0)


@pytest.mark.parametrize("scene", ["3x60", "2x40", "one_small_instance"])
def test_stack_depth_is_the_longest_far_chain(scene):
    """`stack_depth` is the longest far-child chain of the two trees, the
    walk never goes deeper, and a tree whose root is a leaf (one instance
    of a mesh of one leaf) walks through its wrapped roots as the reference
    does."""
    n_meshes, n_inst, tris, seed = {"3x60": (3, 60, 60, 3), "2x40": (2, 40, 60, 4),
                                    "one_small_instance": (1, 1, 5, 5)}[scene]
    meshes, instances = _build_instanced_scene(n_meshes, n_inst, tris_per_mesh=tris, seed=seed)
    o, d = _rays_at_instances(1500, meshes, instances, seed=seed + 10)
    to, td = torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d))
    im = build_instanced(meshes, instances, device="cpu")
    pack = tlas2.pack_tlas2(im)
    assert pack.stack_depth == _far_chain(im)
    stats = {}
    t, _, _ = tlas2.tlas2_closest_plain(pack, to, td, T_MIN, stats=stats)
    tlas2.tlas2_occluded_plain(pack, to, td, T_MIN, torch.full((to.shape[0],), 30.0), stats=stats)
    assert stats["max_stack_depth"] <= pack.stack_depth
    if scene == "one_small_instance":
        assert (pack.n_tlas, pack.num_nodes, pack.stack_depth) == (1, 2, 0)
        xla = ref_instanced_closest_hit(ref_build_instanced(meshes, instances), o, d, T_MIN)
        np.testing.assert_array_equal(t.numpy() < 1e38, np.isfinite(np.asarray(xla.t)))
    else:
        assert pack.stack_depth >= 5 and stats["max_stack_depth"] >= 3


@pytest.mark.parametrize("depth,plan", [
    (0, (128, 0, False)), (24, (128, 12288, False)), (454, (128, 232448, False)),  # a 128-ray block
    (455, (64, 116480, False)), (908, (64, 232448, False)), (1816, (32, 232448, False)),  # a smaller block
    (1817, (128, 0, True)),  # past one block's shared memory: a global stack
])
def test_launch_plan_places_every_stack_depth(depth, plan):
    assert walk.launch_plan(depth) == plan
