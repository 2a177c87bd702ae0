"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need a CUDA card and `nvcc` (the kernels are CUDA C++ for sm_90a
with no CPU mode); without a card they skip. The file imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import rpt_tpu_torch
import rpt_tpu_torch.scene as scene_mod
import walk_scenes
from rpt_tpu_torch import (
    Buffer, Camera, Material, Object, Renderer, Scene, Transformed, kernels, profiling, sphere, triangle_mesh,
)
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch import renderer as renderer_mod
from rpt_tpu_torch import scenes
from rpt_tpu_torch.ops import bvh2, bvh8, tlas2, tlas8, walk
from rpt_tpu_torch.ops.bvh import build_bvh
from rpt_tpu_torch.ops.tlas import build_instanced

T_MIN = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the BVH kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _mesh_and_rays(n_tris, n_rays, seed=0):
    """Random triangle soup in [-1, 1]^3 and rays from a sphere of radius 4
    aimed at jittered centroids, so most rays hit."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, (n_tris, 1, 3))
    verts = np.concatenate([base, base + rng.uniform(-0.15, 0.15, (n_tris, 2, 3))], axis=1)
    n = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    norms = np.repeat(n[:, None, :], 3, axis=1)
    mats = rng.integers(0, 4, n_tris).astype(np.int32)
    o = rng.normal(size=(n_rays, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = verts.mean(axis=1)[rng.integers(0, n_tris, n_rays)] + rng.uniform(-0.05, 0.05, (n_rays, 3))
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    return (verts, norms, mats), torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32)


def test_kernels_match_plain_walks(card):
    """Built with -fmad=false, the kernels repeat the plain walks' f32
    arithmetic op for op: hit times and triangle ids agree exactly."""
    (verts, norms, mats), o, d = _mesh_and_rays(3000, 5000)
    pack = bvh8.pack_bvh8(build_bvh(verts, norms, mats, device="cpu"), device=card)
    o, d = o.to(card), d.to(card)
    active = torch.arange(o.shape[0], device=card) % 3 != 0
    t_k, id_k = walk.launch(pack, o, d, T_MIN, active=active)
    t_p, id_p = bvh8.bvh8_closest_plain(pack, o, d, T_MIN, active)
    torch.cuda.synchronize()
    hit = t_p < 1e38
    assert hit.float().mean() > 0.3
    assert torch.equal(t_k, t_p)
    assert torch.equal(id_k, id_p)
    t_max = torch.where(hit, t_p, torch.full_like(t_p, 4.0))  # closed interval: t == t_max counts
    t_max[::5] = 2.0
    occ_k = walk.launch(pack, o, d, T_MIN, t_max, active)
    occ_p = bvh8.bvh8_occluded_plain(pack, o, d, T_MIN, t_max, active)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p)
    assert torch.equal(occ_k, (t_p <= t_max) & active)


def test_bvh8_kernels_match_plain_walks_at_the_deepest_group_stack(card):
    """Of a few meshes, the one with the deepest node-group stack: the plain
    walk reaches the pack's exact `group_depth` on these rays, both kernels
    agree with it bit for bit, and with the binary walk of the same tree in
    t bit for bit and in triangle ids but for ties."""
    cases = [_mesh_and_rays(n, 6000, seed=s) for n, s in ((500, 4), (3000, 5), (5000, 7))]
    bvhs = [build_bvh(verts, norms, mats, device="cpu") for (verts, norms, mats), _, _ in cases]
    packs = [bvh8.pack_bvh8(bvh, device=card) for bvh in bvhs]
    deepest = max(range(len(cases)), key=lambda j: packs[j].group_depth)
    pack, binary, (_, o, d) = packs[deepest], bvh2.pack_bvh2(bvhs[deepest], device=card), cases[deepest]
    assert pack.group_depth >= 3
    o, d = o.to(card), d.to(card)
    stats = {}
    t_p, id_p = bvh8.bvh8_closest_plain(pack, o, d, T_MIN, stats=stats)
    t_k, id_k = walk.launch(pack, o, d, T_MIN)
    t_x, id_x = walk.launch(binary, o, d, T_MIN)
    torch.cuda.synchronize()
    assert stats["max_group_depth"] == pack.group_depth
    assert torch.equal(t_k, t_p) and torch.equal(id_k, id_p)
    assert torch.equal(t_k, t_x) and (id_k != id_x)[t_x < 1e38].float().mean() <= 1e-3
    t_max = torch.where(t_p < 1e38, t_p, torch.full_like(t_p, 8.0))
    t_max[1::4] = 3.0
    occ_k = walk.launch(pack, o, d, T_MIN, t_max)
    occ_p = bvh8.bvh8_occluded_plain(pack, o, d, T_MIN, t_max)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p)
    assert torch.equal(occ_k, t_p <= t_max)


def test_bvh8_kernels_refuse_a_stack_deeper_than_a_block_holds(card):
    """The group stack lives in one block's shared memory: a depth past its
    227 KB is refused at launch, never truncated."""
    (verts, norms, mats), o, d = _mesh_and_rays(100, 64)
    pack = bvh8.pack_bvh8(build_bvh(verts, norms, mats, device="cpu"), device=card)
    deep = dataclasses.replace(pack, group_depth=1000)
    with pytest.raises(RuntimeError, match="CUDA error"):
        walk.launch(deep, o.to(card), d.to(card), T_MIN)
    with pytest.raises(RuntimeError, match="CUDA error"):
        walk.launch(deep, o.to(card), d.to(card), T_MIN, torch.full((64,), 3.0, device=card))


@pytest.mark.cuda
def test_bvh8_kernels_take_a_stack_past_the_default_48_kb(card):
    """A group stack of 100 levels (51,200 bytes a block) needs the kernels'
    shared-memory limit raised on this card (`csrc/walk.cuh`
    `once_per_card`): both walks launch, twice, and equal the plain walk on
    300 rays (a partial last block)."""
    (verts, norms, mats), o, d = _mesh_and_rays(100, 300)
    pack = bvh8.pack_bvh8(build_bvh(verts, norms, mats, device="cpu"), device=card)
    deep = dataclasses.replace(pack, group_depth=100)
    o, d = o.to(card), d.to(card)
    t_max = torch.full((o.shape[0],), 3.0, device=card)
    for _ in range(2):
        got, want = walk.launch(deep, o, d, T_MIN), bvh8.bvh8_closest_plain(deep, o, d, T_MIN)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(walk.launch(deep, o, d, T_MIN, t_max),
                           bvh8.bvh8_occluded_plain(deep, o, d, T_MIN, t_max))


def _counts():
    counts = kernels.launch_counts()
    return {name: counts[fn] for name, fn in (
        ("bvh8_closest", bvh8.bvh8_closest_hit), ("bvh8_occluded", bvh8.bvh8_occluded),
        ("bvh2_closest", bvh2.bvh2_closest_hit), ("bvh2_occluded", bvh2.bvh2_occluded),
        ("tlas8_closest", tlas8.tlas8_closest_hit), ("tlas8_occluded", tlas8.tlas8_occluded),
        ("tlas2_closest", tlas2.tlas2_closest_hit), ("tlas2_occluded", tlas2.tlas2_occluded))}


def _pack_of(sd, family):
    """The one traversal pack of a compiled scene, which must be `family`'s."""
    (pack,) = sd.packs
    assert pack.library == family
    return pack


def _closest_wrapper(family):
    """The counted closest-hit wrapper of `family`."""
    mod = {"bvh8": bvh8, "bvh2": bvh2, "tlas8": tlas8, "tlas2": tlas2}[family]
    return getattr(mod, f"{family}_closest_hit")


def _assert_goes_through(scene, family, o, d, t_max):
    """The scene compiled on the card answers through `family`'s two
    kernels, one launch each and no other, and equals its CPU compile."""
    sd = scene.compile()  # the default device is the card
    assert _pack_of(sd, family).tris.is_cuda
    before = _counts()
    hit = sd.intersect(o.to("cuda"), d.to("cuda"), T_MIN)
    occ = sd.occluded(o.to("cuda"), d.to("cuda"), T_MIN, t_max)
    after = _counts()
    want = {name: n + (name.startswith(family + "_")) for name, n in before.items()}
    assert after == want
    cpu = scene.compile(device="cpu")
    expect = cpu.intersect(o, d, T_MIN)
    torch.testing.assert_close(hit.t.cpu(), expect.t, rtol=0, atol=0)
    assert torch.equal(hit.mat_id.cpu(), expect.mat_id)
    assert torch.equal(occ.cpu(), cpu.occluded(o, d, T_MIN, t_max))


def test_scene_on_the_card_goes_through_the_kernels(card):
    """A 500-triangle mesh is under WIDE_KERNEL_MIN_TRIS: the binary kernels."""
    (verts, norms, _), o, d = _mesh_and_rays(500, 2000, seed=3)
    scene = Scene()
    scene.add(Object(triangle_mesh(verts, norms)).material(Material.diffuse((0.5, 0.5, 0.5))))
    _assert_goes_through(scene, "bvh2", o, d, 3.0)


def test_scene_over_the_wide_threshold_goes_through_the_bvh8_kernels(card, monkeypatch):
    (verts, norms, _), o, d = _mesh_and_rays(500, 2000, seed=3)
    monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 256)
    scene = Scene()
    scene.add(Object(triangle_mesh(verts, norms)).material(Material.diffuse((0.5, 0.5, 0.5))))
    _assert_goes_through(scene, "bvh8", o, d, 3.0)


def _assert_bvh2_kernels_equal_plain(pack, o, d, active=None):
    """Both bvh2 kernels against the plain walk, bit for bit: t, triangle
    ids and the any-hit bool."""
    t_k, id_k = walk.launch(pack, o, d, T_MIN, active=active)
    t_p, id_p = bvh2.bvh2_closest_plain(pack, o, d, T_MIN, active)
    torch.cuda.synchronize()
    hit = t_p < 1e38
    assert hit.float().mean() > 0.3
    assert torch.equal(t_k, t_p)
    assert torch.equal(id_k, id_p)
    t_max = torch.where(hit, t_p, torch.full_like(t_p, 4.0))  # closed interval: t == t_max counts
    t_max[::5] = 2.0
    occ_k = walk.launch(pack, o, d, T_MIN, t_max, active)
    occ_p = bvh2.bvh2_occluded_plain(pack, o, d, T_MIN, t_max, active)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p)
    want = t_p <= t_max
    assert torch.equal(occ_k, want if active is None else want & active)


def test_bvh2_kernels_match_plain_walks(card):
    """Built with -fmad=false, the binary kernels repeat the plain walks'
    f32 arithmetic op for op, the tie key included: hit times and triangle
    ids agree exactly."""
    (verts, norms, mats), o, d = _mesh_and_rays(3000, 5000)
    pack = bvh2.pack_bvh2(build_bvh(verts, norms, mats, device="cpu"), device=card)
    o, d = o.to(card), d.to(card)
    _assert_bvh2_kernels_equal_plain(pack, o, d, torch.arange(o.shape[0], device=card) % 3 != 0)


@pytest.mark.parametrize("branch", ["block_128", "smaller_block", "global_stack"])
def test_bvh2_kernels_take_every_launch_plan_at_the_deepest_stack(card, branch, monkeypatch):
    """Of a few meshes, the one with the deepest `stack_depth`: the walk
    stays within it, and both kernels equal the plain walk in each launch
    plan, the stack in a 128-ray block's shared memory, in a smaller
    block's (the shared memory the plan sees shrunk to 64 rays' stacks), or
    in a global scratch buffer (no shared memory)."""
    cases = [_mesh_and_rays(n, 6000, seed=s) for n, s in ((500, 4), (3000, 5), (5000, 7))]
    packs = [bvh2.pack_bvh2(build_bvh(verts, norms, mats, device="cpu"), device=card) for (verts, norms, mats), _, _ in cases]
    deepest = max(range(len(cases)), key=lambda j: packs[j].stack_depth)
    pack, (_, o, d) = packs[deepest], cases[deepest]
    assert pack.stack_depth >= 8
    o, d = o.to(card), d.to(card)
    stats = {}
    bvh2.bvh2_closest_plain(pack, o, d, T_MIN, stats=stats)
    assert 0 < stats["max_stack_depth"] <= pack.stack_depth
    limit = {"block_128": walk.SMEM_PER_BLOCK, "smaller_block": 64 * pack.stack_depth * 4, "global_stack": 0}[branch]
    monkeypatch.setattr(walk, "SMEM_PER_BLOCK", limit)
    block, _, on_global = walk.launch_plan(pack.stack_depth)
    assert (block, on_global) == {"block_128": (128, False), "smaller_block": (64, False),
                                  "global_stack": (128, True)}[branch]
    _assert_bvh2_kernels_equal_plain(pack, o, d)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    (verts, norms, mats), o, d = _mesh_and_rays(100, 64)
    pack = bvh8.pack_bvh8(build_bvh(verts, norms, mats, device="cpu"), device=card)
    with pytest.raises(ValueError):
        walk.launch(pack, o, d, T_MIN)  # rays on the CPU
    with pytest.raises(TypeError):
        walk.launch(pack, o.double().to(card), d.double().to(card), T_MIN)


def test_bvh2_wrappers_refuse_what_the_kernels_do_not_take(card):
    (verts, norms, mats), o, d = _mesh_and_rays(100, 64)
    pack = bvh2.pack_bvh2(build_bvh(verts, norms, mats, device="cpu"), device=card)
    with pytest.raises(ValueError):
        walk.launch(pack, o, d, T_MIN)  # rays on the CPU
    with pytest.raises(TypeError):
        walk.launch(pack, o.double().to(card), d.double().to(card), T_MIN)
    with pytest.raises(ValueError):
        walk.launch(pack, o.to(card)[:, :2], d.to(card)[:, :2], T_MIN)
    with pytest.raises(ValueError):
        walk.launch(pack, o.to(card), d.to(card), T_MIN, torch.ones(3, device=card))


def _instanced_and_rays(n_meshes, n_instances, n_rays, seed=0):
    """Random triangle soups shared by randomly rotated, scaled and moved
    instances, and rays aimed at the instances' world-space centroids."""
    rng = np.random.default_rng(seed)
    meshes = [triangle_mesh(*_mesh_and_rays(60, 1, seed=seed + i)[0][:2]) for i in range(n_meshes)]
    instances = []
    for _ in range(n_instances):
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        m = np.eye(4)
        m[:3, :3] = rot @ np.diag(rng.uniform(0.5, 1.8, 3))
        m[:3, 3] = rng.uniform(-3.0, 3.0, 3)
        instances.append((int(rng.integers(0, n_meshes)), m, int(rng.integers(0, 4))))
    cents = np.concatenate([meshes[k].vertices.mean(axis=1) @ m[:3, :3].T + m[:3, 3] for k, m, _ in instances])
    o = rng.normal(size=(n_rays, 3))
    o = 10.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = cents[rng.integers(0, cents.shape[0], n_rays)] + rng.uniform(-0.01, 0.01, (n_rays, 3))
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    return meshes, instances, torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32)


def test_tlas8_kernels_match_plain_walks(card):
    """Built with -fmad=false, the two-level kernels repeat the plain walk's
    f32 arithmetic op for op, the instance transform included."""
    meshes, instances, o, d = _instanced_and_rays(3, 40, 5000)
    pack = tlas8.pack_tlas8(build_instanced(meshes, instances, device="cpu"), device=card)
    o, d = o.to(card), d.to(card)
    active = torch.arange(o.shape[0], device=card) % 3 != 0
    t_k, id_k, inst_k = walk.launch(pack, o, d, T_MIN, active=active)
    t_p, id_p, inst_p = tlas8.tlas8_closest_plain(pack, o, d, T_MIN, active)
    torch.cuda.synchronize()
    hit = t_p < 1e38
    assert hit.float().mean() > 0.3
    assert torch.equal(t_k, t_p)
    assert torch.equal(id_k, id_p)
    assert torch.equal(inst_k, inst_p)
    t_max = torch.where(hit, t_p, torch.full_like(t_p, 12.0))  # closed interval: t == t_max counts
    t_max[::5] = 8.0
    occ_k = walk.launch(pack, o, d, T_MIN, t_max, active)
    occ_p = tlas8.tlas8_occluded_plain(pack, o, d, T_MIN, t_max, active)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p)
    assert torch.equal(occ_k, (t_p <= t_max) & active)


def test_tlas8_kernels_match_plain_walks_at_the_deepest_group_stack(card):
    """Of a few instanced scenes, the one with the deepest node-group stack:
    the plain walk reaches the pack's exact `group_depth` on these rays, and
    both kernels agree with it bit for bit."""
    cases = [_instanced_and_rays(m, k, 6000, seed=s) for m, k, s in ((3, 40, 0), (2, 150, 1), (4, 400, 2))]
    packs = [tlas8.pack_tlas8(build_instanced(meshes, inst, device="cpu"), device=card) for meshes, inst, _, _ in cases]
    deepest = max(range(len(cases)), key=lambda j: packs[j].group_depth)
    pack, (_, _, o, d) = packs[deepest], cases[deepest]
    assert pack.group_depth >= 3
    o, d = o.to(card), d.to(card)
    stats = {}
    t_p, id_p, inst_p = tlas8.tlas8_closest_plain(pack, o, d, T_MIN, stats=stats)
    t_k, id_k, inst_k = walk.launch(pack, o, d, T_MIN)
    torch.cuda.synchronize()
    assert stats["max_group_depth"] == pack.group_depth
    assert torch.equal(t_k, t_p) and torch.equal(id_k, id_p) and torch.equal(inst_k, inst_p)
    t_max = torch.where(t_p < 1e38, t_p, torch.full_like(t_p, 30.0))
    t_max[1::4] = 9.0
    occ_k = walk.launch(pack, o, d, T_MIN, t_max)
    occ_p = tlas8.tlas8_occluded_plain(pack, o, d, T_MIN, t_max)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p)
    assert torch.equal(occ_k, t_p <= t_max)


def test_tlas8_kernels_refuse_a_stack_deeper_than_a_block_holds(card):
    """The group stack lives in one block's shared memory: a depth past its
    227 KB is refused at launch, never truncated."""
    meshes, instances, o, d = _instanced_and_rays(1, 5, 64)
    pack = tlas8.pack_tlas8(build_instanced(meshes, instances, device="cpu"), device=card)
    deep = dataclasses.replace(pack, group_depth=1000)
    with pytest.raises(RuntimeError, match="CUDA error"):
        walk.launch(deep, o.to(card), d.to(card), T_MIN)
    with pytest.raises(RuntimeError, match="CUDA error"):
        walk.launch(deep, o.to(card), d.to(card), T_MIN, torch.full((64,), 9.0, device=card))


def _shared_mesh_scene(seed=3):
    meshes, instances, o, d = _instanced_and_rays(2, 12, 2000, seed=seed)
    scene = Scene()
    for k, m, mat in instances:
        scene.add(Object(Transformed(meshes[k], m)).material(Material.diffuse((0.2 + 0.2 * mat, 0.5, 0.5))))
    return scene, o, d


def test_shared_mesh_scene_on_the_card_goes_through_the_tlas8_kernels(card):
    scene, o, d = _shared_mesh_scene()
    _assert_goes_through(scene, "tlas8", o, d, 9.0)


def test_binary_choice_takes_the_tlas2_kernels(card, monkeypatch):
    monkeypatch.setattr(scene_mod, "_BVH_KERNEL", "binary")
    scene, o, d = _shared_mesh_scene()
    _assert_goes_through(scene, "tlas2", o, d, 9.0)


def _assert_tlas2_kernels_equal_plain(pack, o, d, active=None):
    """Both tlas2 kernels against the plain walk, bit for bit: t, triangle
    ids, instance ids and the any-hit bool."""
    t_k, id_k, inst_k = walk.launch(pack, o, d, T_MIN, active=active)
    t_p, id_p, inst_p = tlas2.tlas2_closest_plain(pack, o, d, T_MIN, active)
    torch.cuda.synchronize()
    hit = t_p < 1e38
    assert hit.float().mean() > 0.3
    assert torch.equal(t_k, t_p)
    assert torch.equal(id_k, id_p)
    assert torch.equal(inst_k, inst_p)
    t_max = torch.where(hit, t_p, torch.full_like(t_p, 12.0))  # closed interval: t == t_max counts
    t_max[::5] = 8.0
    occ_k = walk.launch(pack, o, d, T_MIN, t_max, active)
    occ_p = tlas2.tlas2_occluded_plain(pack, o, d, T_MIN, t_max, active)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p)
    want = t_p <= t_max
    assert torch.equal(occ_k, want if active is None else want & active)


def test_tlas2_kernels_match_plain_walks(card):
    """Built with -fmad=false, the binary two-level kernels repeat the plain
    walk's f32 arithmetic op for op, the instance transform and the tie key
    included."""
    meshes, instances, o, d = _instanced_and_rays(3, 40, 5000)
    pack = tlas2.pack_tlas2(build_instanced(meshes, instances, device="cpu"), device=card)
    o, d = o.to(card), d.to(card)
    _assert_tlas2_kernels_equal_plain(pack, o, d, torch.arange(o.shape[0], device=card) % 3 != 0)


def test_tlas2_kernels_match_plain_walks_at_the_deepest_stack(card):
    """Of a few instanced scenes, the one with the deepest `stack_depth`:
    the walk stays within it, and both kernels equal the plain walk."""
    cases = [_instanced_and_rays(m, k, 6000, seed=s) for m, k, s in ((3, 40, 0), (2, 150, 1), (4, 400, 2))]
    packs = [tlas2.pack_tlas2(build_instanced(meshes, inst, device="cpu"), device=card) for meshes, inst, _, _ in cases]
    deepest = max(range(len(cases)), key=lambda j: packs[j].stack_depth)
    pack, (_, _, o, d) = packs[deepest], cases[deepest]
    assert pack.stack_depth >= 8
    o, d = o.to(card), d.to(card)
    stats = {}
    tlas2.tlas2_closest_plain(pack, o, d, T_MIN, stats=stats)
    assert 0 < stats["max_stack_depth"] <= pack.stack_depth
    _assert_tlas2_kernels_equal_plain(pack, o, d)


@pytest.mark.parametrize("branch", ["smaller_block", "global_stack"])
def test_tlas2_kernels_take_every_launch_plan(card, branch, monkeypatch):
    """The stack of a scene too deep for a 128-ray block's shared memory goes
    to a smaller block, and past what one block holds to a global scratch
    buffer: shrinking the shared memory the plan sees runs both branches on
    a small scene, equal to the plain walk."""
    meshes, instances, o, d = _instanced_and_rays(2, 30, 3000, seed=4)
    pack = tlas2.pack_tlas2(build_instanced(meshes, instances, device="cpu"), device=card)
    limit = 64 * pack.stack_depth * 4 if branch == "smaller_block" else 0
    monkeypatch.setattr(walk, "SMEM_PER_BLOCK", limit)
    block, _, on_global = walk.launch_plan(pack.stack_depth)
    assert (block, on_global) == ((64, False) if branch == "smaller_block" else (128, True))
    _assert_tlas2_kernels_equal_plain(pack, o.to(card), d.to(card))


def test_tlas2_wrappers_refuse_what_the_kernels_do_not_take(card):
    meshes, instances, o, d = _instanced_and_rays(1, 5, 64)
    pack = tlas2.pack_tlas2(build_instanced(meshes, instances, device="cpu"), device=card)
    with pytest.raises(ValueError):
        walk.launch(pack, o, d, T_MIN)  # rays on the CPU
    with pytest.raises(TypeError):
        walk.launch(pack, o.double().to(card), d.double().to(card), T_MIN)
    with pytest.raises(ValueError):
        walk.launch(pack, o.to(card)[:, :2], d.to(card)[:, :2], T_MIN)
    with pytest.raises(ValueError):
        walk.launch(pack, o.to(card), d.to(card), T_MIN, torch.ones(3, device=card))


def test_tlas8_wrappers_refuse_what_the_kernels_do_not_take(card):
    meshes, instances, o, d = _instanced_and_rays(1, 5, 64)
    pack = tlas8.pack_tlas8(build_instanced(meshes, instances, device="cpu"), device=card)
    with pytest.raises(ValueError):
        walk.launch(pack, o, d, T_MIN)  # rays on the CPU
    with pytest.raises(TypeError):
        walk.launch(pack, o.double().to(card), d.double().to(card), T_MIN)
    with pytest.raises(ValueError):
        walk.launch(pack, o.to(card)[:, :2], d.to(card)[:, :2], T_MIN)
    with pytest.raises(ValueError):
        walk.launch(pack, o.to(card), d.to(card), T_MIN, torch.ones(3, device=card))


# ---------------------------------------------------------------------------
# The threefry kernel and the captured sample pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["keys", "bits", "uniform", "randint"])
def test_threefry_kernel_matches_plain(card, mode):
    """Every mode, a host key and a tensor key (keys also from a device
    counter), ragged sizes and the main path's: bit for bit."""
    params = {
        "keys": [(rnd.KEYS, {})],
        "bits": [(rnd.BITS, {})],
        "uniform": [(rnd.UNIFORM, dict(lo=lo, span=float(np.float32(hi) - np.float32(lo))))
                    for lo, hi in ((0.0, 1.0), (-1.0 / 960.0, 1.0 / 960.0), (1e-7, 1.0), (0.0, 2.0 * np.pi),
                                   (-3.0, 5.5))],
        "randint": [(rnd.RANDINT, rnd._randint_params(lo, hi)) for lo, hi in ((0, 6), (0, 1), (-100, 123457),
                                                                              (3, 2**31 - 1))],
    }[mode]
    host = rnd.fold_in(rnd.PRNGKey(42), 7)
    counter = torch.tensor([2**32 + 99], dtype=torch.int64, device=card)
    for m, kw in params:
        kw = {k: float(np.float32(v)) if isinstance(v, float) else v for k, v in kw.items()}
        for n in (1, 7, 255, 257, 1000, 518_400, 2 * 518_400 + 5):
            if m == rnd.KEYS and n > 1000:
                continue
            for key in (host, rnd.to_device(host, card)):
                for ctr in (None, counter) if m == rnd.KEYS else (None,):
                    got = rnd.threefry_kernel(m, key, n, card, counter=ctr, **kw)
                    want = rnd.threefry_plain(m, key, n, card, counter=ctr, **kw)
                    torch.cuda.synchronize()
                    assert got.dtype == want.dtype and torch.equal(got, want), (mode, kw, n)


def test_tensor_keys_on_the_card_match_host_keys(card):
    """split / fold_in of a tensor key (one kernel launch each) and draws
    from it equal the host key's, and each launch is counted once, under
    its mode."""
    host = rnd.PRNGKey(3)
    dev = rnd.to_device(host, card)
    before = kernels.launch_counts(by_slot=True)[rnd._threefry]
    assert np.array_equal(rnd.split(dev, 5).cpu().numpy(), rnd.split(host, 5).astype(np.int64))
    assert np.array_equal(rnd.fold_in(dev, 9).cpu().numpy(), rnd.fold_in(host, 9).astype(np.int64))
    ctr = torch.tensor([11], dtype=torch.int64, device=card)
    assert np.array_equal(rnd.fold_in(dev, ctr).cpu().numpy(), rnd.fold_in(host, 11).astype(np.int64))
    got = rnd.uniform(rnd.split(dev)[1], (3, 77), minval=-2.0, maxval=3.0)
    assert torch.equal(got.cpu(), rnd.uniform(rnd.split(host)[1], (3, 77), minval=-2.0, maxval=3.0, device="cpu"))
    after = kernels.launch_counts(by_slot=True)[rnd._threefry]
    assert [a - b for a, b in zip(after, before)] == [4, 0, 1, 0]  # keys, bits, uniform, randint


def _small_renderer(name, monkeypatch):
    if name == "dragon":
        monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 4096)
        scene, cam = scenes.build_dragon_scene(segments=125, sides=20), scenes.dragon_camera()
    else:
        scene, cam = scenes.build_brick_city(n_instances=96), scenes.lego_camera()
    return Renderer(scene, cam, width=96, height=64, max_bounces=2, num_samples=3, seed=5)


@pytest.mark.parametrize("name,family", [("dragon", "bvh8"), ("lego", "tlas8")])
def test_graphed_render_matches_eager(card, name, family, monkeypatch):
    """A render through the captured graph equals the same render run
    eagerly, and two chunks equal one call, bit for bit; `k` replays count
    `k` times one eager pass's launches (and shadow lanes; the live lanes
    among them depend on each sample's paths)."""
    from rpt_tpu_torch import integrator

    r = _small_renderer(name, monkeypatch)
    _pack_of(r.scene_data(), family)
    graphed = r.render_buffer()
    before = kernels.launch_counts()
    eager = r._sample_into_eager(Buffer.new(r.width, r.height), 1)
    per_pass = {fn: n - before[fn] for fn, n in kernels.launch_counts().items()
                if n != before[fn] and fn is not integrator.shadow_live_lanes}
    eager = r._sample_into_eager(eager, 2, start_iter=1)
    assert torch.equal(graphed.sum, eager.sum) and torch.equal(graphed.sum_sq, eager.sum_sq)
    chunked = r.sample_into(r.sample_into(Buffer.new(r.width, r.height), 1), 2, start_iter=1)
    assert torch.equal(graphed.sum, chunked.sum) and torch.equal(graphed.sum_sq, chunked.sum_sq)
    assert per_pass[rnd._threefry] > 0 and per_pass[_closest_wrapper(family)] == 3
    before = kernels.launch_counts()
    r.sample_into(Buffer.new(r.width, r.height), 4)
    after = kernels.launch_counts()
    assert {fn: after[fn] - n for fn, n in before.items()
            if after[fn] != n and fn is not integrator.shadow_live_lanes} == {fn: 4 * n for fn, n in per_pass.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dragon", "lego"])
def test_every_wavefront_order_renders_the_masked_render(card, name, monkeypatch):
    """Under each RPT_COMPACT order the pass gets a graph of its own (the
    order is in its cache key), equal to the same order run eagerly and to
    the masked render, bit for bit, with the same kernels counted per
    replay."""
    r = _small_renderer(name, monkeypatch)
    sd = r.scene_data()
    renders, counts = {}, {}
    for value in ("0", "1", "octant", "morton"):
        monkeypatch.setenv("RPT_COMPACT", value)
        graphed = r.render_buffer()  # captures this order's graph if no earlier test did
        kernels.reset_launch_counts()
        again = r.render_buffer()  # replays only
        counts[value] = kernels.launch_counts()
        eager = r._sample_into_eager(Buffer.new(r.width, r.height), r.num_samples)
        assert torch.equal(graphed.sum, eager.sum) and torch.equal(graphed.sum_sq, eager.sum_sq)
        assert torch.equal(again.sum, graphed.sum) and torch.equal(again.sum_sq, graphed.sum_sq)
        renders[value] = graphed
    fns = {id(renderer_mod._MANY_CACHE.get((renderer_mod.scene_cache_key(sd), r.width, r.height, r.max_bounces, m)))
           for m in (False, True, "octant", "morton")}
    assert len(fns) == 4 and id(None) not in fns
    for value in ("1", "octant", "morton"):
        assert torch.equal(renders[value].sum, renders["0"].sum)
        assert torch.equal(renders[value].sum_sq, renders["0"].sum_sq)
        assert counts[value] == counts["0"]


@pytest.mark.cuda
def test_replays_count_the_shadow_wavefront_s_lanes(card, monkeypatch):
    """The shadow wavefront's lane counts are adds on the card, captured in
    the sample's graph: n replays of one sample add n times what one eager
    pass of it adds, every lane of every depth and the live ones among them,
    through the bvh8 any-hit walk."""
    from rpt_tpu_torch import integrator

    monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 4096)
    r = Renderer(scenes.build_wine_glass_trefoil_scene(scenes.trefoil_mesh(125, 20)), scenes.wine_glass_camera(),
                 width=96, height=54, max_bounces=3, num_samples=1, seed=7)
    assert r.scene_data().mesh_pack.library == "bvh8"

    def counts():
        c = kernels.launch_counts()
        return [c[integrator.shadow_lanes], c[integrator.shadow_live_lanes], c[bvh8.bvh8_occluded]]

    r.render_buffer()  # captures the sample's graph
    before = counts()
    r._sample_into_eager(Buffer.new(r.width, r.height), 1)
    one = [a - b for a, b in zip(counts(), before)]
    assert one[0] == 96 * 54 * 4 and 0 < one[1] < one[0] and one[2] == 4
    for n in (1, 3):
        before = counts()
        for _ in range(n):
            r.sample_into(Buffer.new(r.width, r.height), 1)
        assert [a - b for a, b in zip(counts(), before)] == [n * c for c in one]


def test_launches_around_the_wrappers_are_not_counted(card):
    """Only a counted wrapper's launch counts: the same kernels launched
    directly, as a comparison with the plain walks does, leave every count
    as it was, and a reset sets them to 0."""
    (verts, norms, mats), o, d = _mesh_and_rays(300, 500)
    pack = bvh8.pack_bvh8(build_bvh(verts, norms, mats, device="cpu"), device=card)
    rnd.uniform(rnd.to_device(rnd.PRNGKey(1), card), 10)  # makes the card's table
    before = kernels.launch_counts(by_slot=True)
    walk.launch(pack, o.to(card), d.to(card), T_MIN)
    rnd.threefry_kernel(rnd.UNIFORM, rnd.PRNGKey(1), 100, card)
    assert kernels.launch_counts(by_slot=True) == before
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_environment_color_edited_in_place_renders_anew_on_the_card(card):
    """The graphed pass reads the environment's color from the compiled
    scene: an in-place edit recompiles, and the next render draws it."""
    def sphere_scene():
        scene = Scene()
        scene.add(Object(sphere()).material(Material.diffuse((0.5, 0.5, 0.5))))
        return scene

    scene, cam = sphere_scene(), Camera.look_at([0.0, 0.0, 5.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 0.8)
    r = Renderer(scene, cam, width=32, height=24, max_bounces=1, seed=4)
    black = r.render_buffer()
    scene.environment.color[:] = (0.25, 0.5, 0.75)
    edited = r.render_buffer()
    fresh = sphere_scene()
    fresh.environment.color[:] = (0.25, 0.5, 0.75)
    want = Renderer(fresh, cam, width=32, height=24, max_bounces=1, seed=4).render_buffer()
    assert not torch.equal(edited.sum, black.sum)
    assert torch.equal(edited.sum, want.sum) and torch.equal(edited.sum_sq, want.sum_sq)


def test_a_missing_kernel_library_raises(card, monkeypatch):
    """No kernel, no render: a library that cannot be loaded raises."""
    def missing(name):
        raise RuntimeError(f"no library {name}")

    monkeypatch.setattr(kernels, "load_library", missing)
    scene, cam = scenes.build_cornell_scene(), scenes.cornell_camera()
    r = Renderer(scene, cam, width=32, height=24, max_bounces=1, seed=10)
    with pytest.raises(RuntimeError, match="no library threefry"):
        r.render_buffer()


# ---------------------------------------------------------------------------
# float64: the kernels' double instantiations, the 64-bit draws, f64 renders
# ---------------------------------------------------------------------------


def _f64_case(family, card):
    """A float64 pack of `family` on the card and float64 rays at it."""
    if family in ("bvh8", "bvh2"):
        (verts, norms, mats), o, d = _mesh_and_rays(3000, 5000, seed=11)
        tree = build_bvh(verts, norms, mats, device=card, dtype=torch.float64)
    else:
        meshes, instances, o, d = _instanced_and_rays(3, 40, 5000, seed=11)
        tree = build_instanced(meshes, instances, device=card, dtype=torch.float64)
    mod = {"bvh8": bvh8, "bvh2": bvh2, "tlas8": tlas8, "tlas2": tlas2}[family]
    pack = getattr(mod, f"pack_{family}")(tree, device=card)
    # The rays in float64, off the float32 grid.
    jitter = torch.as_tensor(np.random.default_rng(5).uniform(-1e-9, 1e-9, (o.shape[0], 3)))
    o64 = (o.double() + jitter).to(card)
    d64 = torch.nn.functional.normalize(d.double() + jitter, dim=-1).to(card)
    return mod, tree, pack, o64, d64


@pytest.mark.parametrize("family", ["bvh8", "bvh2", "tlas8", "tlas2"])
def test_f64_kernels_match_plain_walks(card, family):
    """The double instantiations repeat their float64 plain walks op for op:
    t, triangle ids, instance ids and the any-hit bool, bit for bit; and the
    wrappers launch them, counted in their float64 slot."""
    mod, tree, pack, o, d = _f64_case(family, card)
    assert pack.tris.dtype == torch.float64
    active = torch.arange(o.shape[0], device=card) % 3 != 0
    out_k = walk.launch(pack, o, d, T_MIN, active=active)
    out_p = getattr(mod, f"{family}_closest_plain")(pack, o, d, T_MIN, active)
    torch.cuda.synchronize()
    t_p = out_p[0]
    assert t_p.dtype == torch.float64 and (t_p < 1e38).float().mean() > 0.3
    assert all(torch.equal(k, p) for k, p in zip(out_k, out_p))
    t_max = torch.where(t_p < 1e38, t_p, torch.full_like(t_p, 12.0))  # closed interval: t == t_max counts
    t_max[::5] = 3.0
    occ_k = walk.launch(pack, o, d, T_MIN, t_max, active)
    occ_p = getattr(mod, f"{family}_occluded_plain")(pack, o, d, T_MIN, t_max, active)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p) and torch.equal(occ_k, (t_p <= t_max) & active)
    closest, occluded = getattr(mod, f"{family}_closest_hit"), getattr(mod, f"{family}_occluded")
    before = kernels.launch_counts(by_slot=True)
    closest(tree, pack, o, d, T_MIN)
    after = kernels.launch_counts(by_slot=True)
    assert [a - b for a, b in zip(after[closest], before[closest])] == [0, 1]
    with pytest.raises(TypeError):
        walk.launch(pack, o.float(), d.float(), T_MIN)
    assert occluded in after


def _walk_scene(family, scene, dtype, card):
    """The `family` pack of `walk_scenes.walk_scene`, on the card, and its rays."""
    tree, o, d = walk_scenes.walk_scene(family, scene, dtype)
    mod = {"bvh8": bvh8, "bvh2": bvh2, "tlas8": tlas8, "tlas2": tlas2}[family]
    return mod, getattr(mod, f"pack_{family}")(tree, device=card), o.to(card), d.to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("family,scene", [("bvh8", "twin_leaves"), ("bvh2", "twin_leaves"), ("tlas8", "same_mesh"),
                                          ("tlas8", "wider_mesh"), ("tlas2", "same_mesh"), ("tlas2", "wider_mesh")])
def test_kernels_keep_the_tie_of_their_plain_walks(card, family, scene, dtype):
    """On scenes where every hit is a tie (two leaves or two instances at
    one t), each closest-hit kernel returns its plain walk's t, triangle and
    instance bit for bit: the reference's preorder choice, kept by the key
    (row, or TLAS leaf rank and row)."""
    mod, pack, o, d = _walk_scene(family, scene, dtype, card)
    out_k = walk.launch(pack, o, d, T_MIN)
    out_p = getattr(mod, f"{family}_closest_plain")(pack, o, d, T_MIN)
    torch.cuda.synchronize()
    assert (out_p[0] < 1e38).sum() > 200
    assert all(torch.equal(k, p) for k, p in zip(out_k, out_p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("family", ["bvh8", "bvh2", "tlas8", "tlas2"])
def test_any_hit_kernels_find_the_hit_at_t_max_equal_to_its_t(card, family, dtype):
    """`walk_scenes.edge_scene` (flat leaves, hits at a leaf's face): each
    closest-hit kernel equals its plain walk, and each any-hit kernel at
    t_max = the closest hit's t answers `closest.t <= t_max` (true on every
    hit; 12, past the scene, on a miss) and equals its plain walk."""
    mod, pack, o, d = _walk_scene(family, "edge", dtype, card)
    out_k = walk.launch(pack, o, d, T_MIN)
    out_p = getattr(mod, f"{family}_closest_plain")(pack, o, d, T_MIN)
    torch.cuda.synchronize()
    assert all(torch.equal(k, p) for k, p in zip(out_k, out_p))
    hit = out_p[0] < 1e38
    assert hit.sum() > 100 and (~hit).any()
    t_max = torch.where(hit, out_p[0], torch.full_like(out_p[0], 12.0))
    occ_k = walk.launch(pack, o, d, T_MIN, t_max)
    occ_p = getattr(mod, f"{family}_occluded_plain")(pack, o, d, T_MIN, t_max)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p) and torch.equal(occ_k, hit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tlas8_occupancy_query(card, dtype):
    """`walk.occupancy` of the tlas8 kernels reads their registers and
    blocks per SM at `walk.launch`'s launch: a deeper group stack never
    fits more blocks."""
    for occluded in (False, True):
        shallow = walk.occupancy(tlas8.Tlas8Pack, 4, occluded, dtype)
        deep = walk.occupancy(tlas8.Tlas8Pack, 120, occluded, dtype)
        assert 0 < shallow["registers"] <= 255 and shallow["local_bytes"] >= 0
        assert shallow["warps_per_sm"] == 4 * shallow["blocks_per_sm"] > 0
        assert deep["blocks_per_sm"] <= shallow["blocks_per_sm"] and deep["smem_bytes"] == 128 * 120 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_bvh8_occupancy_query(card, dtype):
    """`walk.occupancy` of the bvh8 kernels reads their registers and
    blocks per SM at `walk.launch`'s launch (the float32 pair under its cap
    of 64 registers): a deeper group stack never fits more blocks."""
    for occluded in (False, True):
        shallow = walk.occupancy(bvh8.Bvh8Pack, 4, occluded, dtype)
        deep = walk.occupancy(bvh8.Bvh8Pack, 120, occluded, dtype)
        assert 0 < shallow["registers"] <= (64 if dtype == torch.float32 else 255) and shallow["local_bytes"] >= 0
        assert shallow["warps_per_sm"] == 4 * shallow["blocks_per_sm"] > 0
        assert deep["blocks_per_sm"] <= shallow["blocks_per_sm"] and deep["smem_bytes"] == 128 * 120 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_bvh2_occupancy_query(card, dtype):
    """`walk.occupancy` of the bvh2 kernels reads their registers and
    blocks per SM at the launch `walk.launch_plan` makes: a deeper shared stack never fits more
    blocks, and a stack past what one block holds reads the global-stack
    kernel with no shared memory."""
    for occluded in (False, True):
        shallow = walk.occupancy(bvh2.Bvh2Pack, 4, occluded, dtype)
        deep = walk.occupancy(bvh2.Bvh2Pack, 120, occluded, dtype)
        on_global = walk.occupancy(bvh2.Bvh2Pack, 2000, occluded, dtype)
        assert 0 < shallow["registers"] <= 255 and shallow["local_bytes"] >= 0
        assert shallow["warps_per_sm"] == 4 * shallow["blocks_per_sm"] > 0
        assert deep["blocks_per_sm"] <= shallow["blocks_per_sm"] and deep["smem_bytes"] == 128 * 120 * 4
        assert on_global["global_stack"] and on_global["smem_bytes"] == 0 and on_global["blocks_per_sm"] > 0


@pytest.mark.parametrize("branch", ["block_128", "smaller_block", "global_stack"])
@pytest.mark.parametrize("family", ["bvh2", "tlas2"])
def test_tlas2_f64_kernels_take_every_launch_plan(card, family, branch, monkeypatch):
    """The float64 pair walks, one-level (float box tests, the closest hit
    prefetching) and two-level (float box tests, plane-first triangle rows,
    register caps), in a 128-ray block's shared stack, a smaller block's and
    the global scratch stack, each over a ray count that leaves the last
    block partial: t, ids and the any hit bit for bit with the plain walk."""
    mod, _, pack, o, d = _f64_case(family, card)
    limit = {"block_128": walk.SMEM_PER_BLOCK, "smaller_block": 64 * pack.stack_depth * 4, "global_stack": 0}[branch]
    monkeypatch.setattr(walk, "SMEM_PER_BLOCK", limit)
    block, _, on_global = walk.launch_plan(pack.stack_depth)
    assert (block, on_global) == {"block_128": (128, False), "smaller_block": (64, False),
                                  "global_stack": (128, True)}[branch]
    assert o.shape[0] % block != 0
    active = torch.arange(o.shape[0], device=card) % 3 != 0
    out_k = walk.launch(pack, o, d, T_MIN, active=active)
    out_p = getattr(mod, f"{family}_closest_plain")(pack, o, d, T_MIN, active)
    torch.cuda.synchronize()
    assert (out_p[0] < 1e38).float().mean() > 0.3
    assert all(torch.equal(k, p) for k, p in zip(out_k, out_p))
    t_max = torch.where(out_p[0] < 1e38, out_p[0], torch.full_like(out_p[0], 12.0))
    t_max[::5] = 3.0
    occ_k = walk.launch(pack, o, d, T_MIN, t_max, active)
    occ_p = getattr(mod, f"{family}_occluded_plain")(pack, o, d, T_MIN, t_max, active)
    torch.cuda.synchronize()
    assert torch.equal(occ_k, occ_p)


@pytest.mark.parametrize("mode", ["uniform64", "randint64"])
def test_threefry_64_bit_modes_match_plain(card, mode):
    """The float64 uniform and the int64 randint, a host key and a tensor
    key, ragged sizes and the main path's: bit for bit with the plain
    versions (whose float64 multiply-add is emulated in one rounding)."""
    params = {
        "uniform64": [(rnd.UNIFORM64, dict(lo=lo, span=hi - lo))
                      for lo, hi in ((0.0, 1.0), (-1.0 / 960.0, 1.0 / 960.0), (1e-7, 1.0), (0.0, 2.0 * np.pi),
                                     (-3.0, 5.5))],
        # Spans 6, 1, 120000, 123557, then 2, 3, 7, 2^32 - 1, 2^32, 2^32 + 1,
        # 2^40 + 3, 2^63 - 1, 2^63 and 2^64 - 1: every kind of reciprocal.
        "randint64": [(rnd.RANDINT64, rnd._randint_params(lo, hi, 64))
                      for lo, hi in ((0, 6), (0, 1), (0, 120_000), (-100, 123457), (5, 7), (-1, 2), (0, 7),
                                     (0, 2**32 - 1), (-2**31, 2**31), (0, 2**32 + 1), (0, 2**40 + 3), (0, 2**63 - 1),
                                     (-2**62, 2**62), (-2**63, 2**63 - 1))],
    }[mode]
    host = rnd.fold_in(rnd.PRNGKey(42, x64=True), 7)
    for m, kw in params:
        for n in (1, 7, 255, 257, 1000, 518_400, 518_403, 2 * 518_400 + 5):
            for key in (host, rnd.to_device(host, card)):
                got = rnd.threefry_kernel(m, key, n, card, **kw)
                want = rnd.threefry_plain(m, key, n, card, **kw)
                torch.cuda.synchronize()
                assert got.dtype == want.dtype and torch.equal(got, want), (mode, kw, n)


def test_f64_draws_are_counted_apart(card):
    """A float64 uniform and an int64 randint launch the 64-bit modes,
    counted by `_threefry64`, and leave the 32-bit modes' counts alone."""
    dev = rnd.to_device(rnd.PRNGKey(3, x64=True), card)
    rnd.uniform(dev, 10)  # makes the card's table
    before = kernels.launch_counts(by_slot=True)
    u = rnd.uniform(dev, (3, 77), dtype=torch.float64, minval=-2.0, maxval=3.0)
    i = rnd.randint(dev, (100,), 0, 6, dtype=torch.int64)
    after = kernels.launch_counts(by_slot=True)
    assert u.dtype == torch.float64 and i.dtype == torch.int64
    assert after[rnd._threefry] == before[rnd._threefry]
    assert [a - b for a, b in zip(after[rnd._threefry64], before[rnd._threefry64])] == [1, 1]


@pytest.mark.parametrize("name,family", [("dragon", "bvh8"), ("lego", "tlas8")])
def test_f64_graphed_render_matches_eager(card, name, family, monkeypatch):
    """A float64 render through its graph equals the same render run
    eagerly, bit for bit, and launches only float64 kernels and draws."""
    small = _small_renderer(name, monkeypatch)
    r = Renderer(small.scene, small.camera, width=small.width, height=small.height, max_bounces=2, num_samples=3,
                 seed=5, dtype=torch.float64)
    sd = r.scene_data()
    assert sd.dtype == torch.float64 and _pack_of(sd, family).tris.dtype == torch.float64
    graphed = r.render_buffer()
    assert graphed.sum.dtype == torch.float64
    kernels.reset_launch_counts()
    eager = r._sample_into_eager(Buffer.new(r.width, r.height, dtype=torch.float64), r.num_samples)
    counts = kernels.launch_counts(by_slot=True)
    assert torch.equal(graphed.sum, eager.sum) and torch.equal(graphed.sum_sq, eager.sum_sq)
    walk = _closest_wrapper(family)
    assert counts[walk] == [0, 3 * r.num_samples]
    assert counts[rnd._threefry][1:] == [0, 0, 0] and counts[rnd._threefry64][0] > 0


def test_f32_render_after_f64_replays_the_f32_graph(card):
    """f32, f64, f32: each type renders through its own graph, captured
    once, and the two f32 renders are equal bit for bit."""
    scene, cam = scenes.build_cornell_scene(), scenes.cornell_camera()
    r32 = Renderer(scene, cam, width=64, height=48, max_bounces=2, num_samples=2, seed=6)
    r64 = Renderer(scene, cam, width=64, height=48, max_bounces=2, num_samples=2, seed=6, dtype=torch.float64)
    first = r32.render_buffer()
    fn32 = renderer_mod.make_render_many_fn(r32.scene_data(), 64, 48, 2)
    graph32 = fn32.capture(1e-3).graph
    wide = r64.render_buffer()
    fn64 = renderer_mod.make_render_many_fn(r64.scene_data(), 64, 48, 2)
    again = r32.render_buffer()
    assert fn64 is not fn32 and len(fn32.captures) == 1 and len(fn64.captures) == 1
    assert fn32.capture(1e-3).graph is graph32
    assert wide.sum.dtype == torch.float64 and first.sum.dtype == torch.float32
    assert torch.equal(first.sum, again.sum) and torch.equal(first.sum_sq, again.sum_sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["monomial_glass", "monomial_glass_gather", "monomial_light"])
def test_monomial_and_hdri_renders_graphed_match_eager(card, name, dtype, monkeypatch):
    """A monomial surface under an HDRI (its quad table, or its four
    gathers), and a monomial light: the render through the captured graph
    equals the same render run eagerly, and two chunks one call, bit for
    bit. The pass reads the map from the compiled scene's device tensors."""
    from rpt_tpu_torch import environment as env_mod

    if name == "monomial_glass_gather":
        monkeypatch.setattr(env_mod, "_QUAD_MAX_TEXELS", 0)
    if name == "monomial_light":
        scene, cam = scenes.build_monomial_light_scene(), scenes.monomial_light_camera()
    else:
        scene, cam = scenes.build_monomial_glass_scene(sky_height=64), scenes.monomial_glass_camera()
    r = Renderer(scene, cam, width=96, height=64, max_bounces=1, num_samples=3, seed=5, dtype=dtype)
    sd = r.scene_data()
    if name == "monomial_light":
        assert sd.env_hdri is None and type(sd.lights[0]).__name__ == "MonomialLightData"
    else:
        assert sd.monomials.height.dtype == dtype and sd.env_hdri.device.type == "cuda"
        assert (sd.env_quad is None) == (name == "monomial_glass_gather")
    graphed = r.render_buffer()
    eager = r._sample_into_eager(Buffer.new(r.width, r.height, dtype), r.num_samples)
    assert graphed.sum.dtype == dtype and bool(torch.isfinite(graphed.sum).all()) and float(graphed.sum.mean()) > 0
    assert torch.equal(graphed.sum, eager.sum) and torch.equal(graphed.sum_sq, eager.sum_sq)
    chunked = r.sample_into(r.sample_into(Buffer.new(r.width, r.height, dtype), 1), 2, start_iter=1)
    assert torch.equal(graphed.sum, chunked.sum) and torch.equal(graphed.sum_sq, chunked.sum_sq)


def _grad_of_mean(fn, mats0, fields=("color", "index", "roughness", "metallic", "emittance")):
    """{leaf: d mean(image) / d leaf} of the differentiable render `fn`."""
    from rpt_tpu_torch.materials import MaterialTable

    leaves = {f.name: getattr(mats0, f.name).detach().clone().requires_grad_(f.name in fields)
              for f in dataclasses.fields(MaterialTable)}
    fn(MaterialTable(**leaves)).mean().backward()
    return {f: leaves[f].grad for f in fields}


@pytest.mark.cuda
@pytest.mark.parametrize("name,family", [("dragon", "bvh8"), ("lego", "tlas8"), ("dragon", "bvh2"), ("lego", "tlas2"),
                                         ("dragon_f64", "bvh8"), ("lego_f64", "tlas8")])
def test_material_gradient_through_the_kernels_equals_the_plain_walks(card, name, family, monkeypatch):
    """The walks carry no gradient and agree bit for bit, so the material
    gradient through the kernels is the plain walks' on the card, bit for
    bit under deterministic algorithms; each kernel launches twice per
    sample and path vertex (the backward recomputes the forward). The
    binary walks run under RPT_BVH_KERNEL=binary, the `_f64` scenes in
    float64 (the wrapper's float64 slot)."""
    from rpt_tpu_torch.grad import make_diff_render

    if family in ("bvh2", "tlas2"):
        monkeypatch.setattr(scene_mod, "_BVH_KERNEL", "binary")
    dtype = torch.float64 if name.endswith("_f64") else torch.float32
    r = _small_renderer(name.removesuffix("_f64"), monkeypatch)
    assert [pack.library for pack in r.scene.compile(dtype).packs] == [family]
    fn, mats0 = make_diff_render(r.scene, r.camera, 64, 48, max_bounces=2, spp=2, device=card, dtype=dtype)
    mod = {"bvh8": bvh8, "tlas8": tlas8, "bvh2": bvh2, "tlas2": tlas2}[family]
    wrapper = getattr(mod, f"{family}_closest_hit")
    slot = 0 if dtype == torch.float32 else 1
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        before = kernels.launch_counts(by_slot=True)
        got = _grad_of_mean(fn, mats0)
        after = kernels.launch_counts(by_slot=True)
        monkeypatch.setattr(walk, "launch", lambda pack, o, d, t_min, t_max=None, active=None, launches=None:
                            pack.plain(o, d, t_min, t_max, active))
        want = _grad_of_mean(fn, mats0)
    finally:
        torch.use_deterministic_algorithms(False)
    assert after[wrapper][slot] - before[wrapper][slot] == 2 * 3 * 2
    assert after[wrapper][1 - slot] == before[wrapper][1 - slot]
    assert any(float(g.abs().max()) > 0.0 for g in want.values())
    for f in want:
        assert bool(torch.isfinite(got[f]).all()) and torch.equal(got[f], want[f]), f


@pytest.mark.cuda
def test_camera_gradient_through_a_mesh_raises_on_the_card(card, monkeypatch):
    from rpt_tpu_torch.grad import render_with_camera

    r = _small_renderer("dragon", monkeypatch)
    eye = r.camera.eye.detach().clone().requires_grad_()
    with pytest.raises(ValueError, match="require grad"):
        render_with_camera(dataclasses.replace(r.camera, eye=eye), r.scene_data(), rnd.PRNGKey(0), 32, 24, 1,
                           T_MIN, 1.0)


@pytest.mark.cuda
def test_camera_gradient_without_a_bvh_equals_the_cpu(card):
    """`cornell` (analytic boxes, small brute-force meshes, a mesh light):
    the camera gradient on the card is the CPU's to 1e-3 of its largest
    component."""
    from rpt_tpu_torch.grad import render_with_camera

    scene, cam = scenes.build_cornell_scene(), scenes.cornell_camera()
    grads = {}
    for dev in ("cpu", card):
        leaves = {f: getattr(cam, f).detach().clone().requires_grad_() for f in ("eye", "direction", "fov")}
        img = render_with_camera(dataclasses.replace(cam, **leaves), scene.compile(device=dev), rnd.PRNGKey(0), 48,
                                 32, 2, scenes.CORNELL_EPSILON, 1.0)
        img.mean().backward()
        grads[str(dev)] = {f: v.grad for f, v in leaves.items()}
    for f, want in grads["cpu"].items():
        got = grads[str(card)][f]
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max()), f


def _dynamic_frames(family, monkeypatch, frames=3):
    """Frames of one topology through `family`'s kernels: the small trefoil
    (bvh8, bvh2) under a sphere light that moves, or shared meshes (tlas8,
    tlas2) whose instances all move by one offset, which keeps the TLAS's
    shape. The binary walks run under RPT_BVH_KERNEL=binary."""
    if family in ("bvh2", "tlas2"):
        monkeypatch.setattr(scene_mod, "_BVH_KERNEL", "binary")
    if family in ("bvh8", "bvh2"):
        monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 4096)
        mesh = scenes.trefoil_mesh(segments=125, sides=20)
        return [scenes.build_dragon_scene(mesh=mesh, light_position=(3.0 * np.sin(i), 20.0, 3.0 * np.cos(i)))
                for i in range(frames)], scenes.dragon_camera()
    meshes, instances, _, _ = _instanced_and_rays(2, 12, 1, seed=3)
    out = []
    for i in range(frames):
        scene = Scene()
        for k, m, mat in instances:
            m = m.copy()
            m[0, 3] += 0.5 * i
            scene.add(Object(Transformed(meshes[k], m)).material(Material.diffuse((0.2 + 0.2 * mat, 0.5, 0.5))))
        scene.add(rpt_tpu_torch.PointLight((30.0, 30.0, 30.0), (0.0, 8.0, 4.0)))
        out.append(scene)
    return out, Camera.look_at((0.0, 4.0, 12.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.8)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["bvh8", "tlas8", "bvh2", "tlas2", "bvh8_f64"])
def test_dynamic_frames_equal_static_renders_with_one_capture(card, family, monkeypatch):
    """Each frame through the dynamic path's one graph equals its static
    render (a graph of its own), bit for bit, with the same kernels counted
    per pass (the first frame's capture runs one eager warm-up pass more);
    the loop captures once. `bvh8_f64` renders the bvh8 frames in float64."""
    dtype = torch.float64 if family.endswith("_f64") else torch.float32
    family = family.removesuffix("_f64")
    monkeypatch.setattr(renderer_mod, "_DYNAMIC_CACHE", renderer_mod.SceneCache())
    frames, cam = _dynamic_frames(family, monkeypatch)
    keys = {renderer_mod._topology_key(f.compile(dtype), 64, 48, 2) for f in frames}
    assert len(keys) == 1
    _pack_of(frames[0].compile(dtype), family)
    for i, scene in enumerate(frames):
        r = dict(width=64, height=48, max_bounces=2, num_samples=2, seed=4, dtype=dtype)
        before = _counts()
        dyn = Renderer(scene, cam, dynamic=True, **r).render_buffer()
        mid = _counts()
        static_r = Renderer(scene, cam, **r)
        static_r.render_buffer()  # captures the static graph
        mid2 = _counts()
        static = static_r.render_buffer()
        after = _counts()
        passes = 2 + (i == 0)
        assert torch.equal(dyn.sum, static.sum) and torch.equal(dyn.sum_sq, static.sum_sq)
        assert {k: 2 * (mid[k] - before[k]) for k in mid} == {k: passes * (after[k] - mid2[k]) for k in mid}
        assert mid[f"{family}_closest"] - before[f"{family}_closest"] == 3 * passes
    assert len(renderer_mod._DYNAMIC_CACHE) == 1 and renderer_mod._DYNAMIC_CACHE.captures() == 1


@pytest.mark.cuda
def test_dynamic_pack_of_another_depth_gets_its_own_capture(card, monkeypatch):
    """The same tensors with a deeper group stack: another key, another
    capture (its launch geometry differs), the same image."""
    monkeypatch.setattr(renderer_mod, "_DYNAMIC_CACHE", renderer_mod.SceneCache())
    (scene,), cam = _dynamic_frames("bvh8", monkeypatch, frames=1)
    sd = scene.compile()
    deeper = dataclasses.replace(sd, mesh_pack=dataclasses.replace(sd.mesh_pack, group_depth=sd.mesh_pack.group_depth + 1))
    r = Renderer(scene, cam, width=64, height=48, max_bounces=1, num_samples=1, seed=2, dynamic=True)
    a = r.render_buffer(scene_data=sd)
    b = r.render_buffer(scene_data=deeper)
    assert renderer_mod._DYNAMIC_CACHE.captures() == 2 and len(renderer_mod._DYNAMIC_CACHE) == 2
    assert torch.equal(a.sum, b.sum) and torch.equal(a.sum_sq, b.sum_sq)


@pytest.mark.cuda
def test_graphed_rk4_equals_eager(card):
    """`rk4_integrate` replays one captured step; the eager loop runs the
    same kernels: positions and velocities bit for bit, and the next call
    does not overwrite a state the caller holds."""
    from rpt_tpu_torch.ode import MarblesSystem, ParticleState

    packed = np.random.RandomState(42).randn(25, 3) * 0.3 + np.array([0.0, 2.0, 0.0])
    system = MarblesSystem(0.15)
    for pos in (scenes.marbles_initial_state().pos, packed):
        state = ParticleState.create(pos)
        graphed = system.rk4_integrate(state, 1.0 / 16.0, 1.0 / 2000.0)
        held = graphed.pos.clone()
        eager = system._rk4_eager(state, 1.0 / 16.0, 1.0 / 2000.0)
        assert torch.equal(graphed.pos, eager.pos) and torch.equal(graphed.vel, eager.vel)
        system.rk4_integrate(eager, 1.0 / 16.0, 1.0 / 2000.0)
        assert torch.equal(graphed.pos, held)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 7])
def test_sharded_render_graphed_matches_eager(card, n_shards, monkeypatch):
    """`render_distributed` on shards of the one card (7 pads 96x64 = 6,144
    pixels by 1), each shard a CUDA graph of its own, equals the same
    shards run eagerly and two chunks equal one call, bit for bit; each
    replayed sample launches each shard's walks once per path vertex."""
    from rpt_tpu_torch.parallel import make_ray_mesh, make_sharded_many_fn, render_distributed, sharding

    r = _small_renderer("dragon", monkeypatch)
    mesh = make_ray_mesh(n_shards, device=card)
    assert mesh.devices == (torch.device("cuda", torch.cuda.current_device()),) * n_shards
    sd, t_min, ev = r._pass_args()
    graphed = render_distributed(r, mesh)  # captures every shard's graph
    assert sd.mesh_pack.library == "bvh8" and graphed.sum.device.type == "cuda"
    eager = sharding._eager_sharded_many_fn(sd, r.width, r.height, r.max_bounces, mesh)(
        r.camera, r.base_key(), 0, r.num_samples, t_min, ev)
    assert torch.equal(graphed.sum, eager[0]) and torch.equal(graphed.sum_sq, eager[1])
    fn = make_sharded_many_fn(sd, r.width, r.height, r.max_bounces, mesh)
    assert len(fn.shards) == n_shards and all(len(p.captures) == 1 for p in fn.shards)
    kernels.reset_launch_counts()
    first = fn(r.camera, r.base_key(), 0, 1, t_min, ev)
    counts = kernels.launch_counts()
    chunked = fn(r.camera, r.base_key(), 1, r.num_samples - 1, t_min, ev, into=first)
    assert torch.equal(graphed.sum, chunked[0]) and torch.equal(graphed.sum_sq, chunked[1])
    assert counts[bvh8.bvh8_closest_hit] == 3 * n_shards and counts[rnd._threefry] > 0
    assert bool(torch.isfinite(graphed.sum).all()) and float(graphed.sum.mean()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,packs", [("compound", []), ("teapot", ["bvh2"])])
def test_example_main_on_the_card_renders_as_the_cpu(card, name, packs, monkeypatch, tmp_path):
    """An example module through its `main` with no `--device` (so on the
    card), at 64x64 and 1 spp, `teapot` on the stand-in mesh: the PNG is
    written, every kernel of its path launched, and the card's image agrees
    with the CPU's render of the same recorded scene on 99% of pixels
    (rtol 1e-3 / atol 1e-4), the mean to 1e-3."""
    import importlib

    from rpt_tpu_torch.examples import _stand_ins

    mod = importlib.import_module(f"rpt_tpu_torch.examples.{name}")
    flags = _stand_ins.write_stand_ins(str(tmp_path), glass_knot=(100, 20), sky_height=16).get(name, [])
    made = []

    class Recording(mod.Renderer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(mod, "Renderer", Recording)
    out = tmp_path / f"{name}.png"
    kernels.reset_launch_counts()
    img = mod.main([*flags, "--size", "64", "--spp", "1", "--out", str(out)])
    counts = kernels.launch_counts()
    (r,) = made
    assert r.device.type == "cuda" and img.shape == (64, 64, 3) and out.stat().st_size > 0
    sd = r.scene_data()
    assert [pack.library for pack in sd.packs] == packs
    assert counts[rnd._threefry] > 0
    for f in packs:
        ops = {"bvh8": bvh8, "tlas8": tlas8, "bvh2": bvh2, "tlas2": tlas2}[f]
        assert counts[getattr(ops, f"{f}_closest_hit")] > 0 and counts[getattr(ops, f"{f}_occluded")] > 0
    images = {}
    for dev in ("cpu", "cuda"):
        s = Renderer(r.scene, r.camera, width=64, height=64, max_bounces=r.max_bounces, num_samples=1,
                     epsilon=r.epsilon, seed=r.seed, device=dev)
        images[dev] = s.render_buffer().mean_image().cpu().numpy()
    got, want = images["cuda"], images["cpu"]
    assert np.isfinite(got).all() and got.mean() > 0.0
    assert np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1).mean() >= 0.99
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


def test_capture_fails_loudly(card, monkeypatch):
    """A pass that waits on the device cannot be captured: the render
    raises, it does not fall back to eager passes. (Last in the file: the
    failed capture is left behind on the card.)"""
    scene, cam = scenes.build_cornell_scene(), scenes.cornell_camera()
    orig = renderer_mod._sample_pass

    def syncing(sd, inp, *a):
        orig(sd, inp, *a)
        float(inp.s.sum())  # a host read, illegal inside a capture

    monkeypatch.setattr(renderer_mod, "_sample_pass", syncing)
    r = Renderer(scene, cam, width=40, height=24, max_bounces=1, seed=9)
    with pytest.raises(RuntimeError, match="capturing the sample pass"):
        r.render_buffer()


def _covered(start: float, end: float, intervals) -> float:
    """The length of [start, end] inside the union of `intervals`."""
    total, last = 0.0, start
    for s, e in sorted(intervals):
        s, e = max(s, last), min(e, end)
        if e > s:
            total += e - s
            last = e
    return total


@pytest.mark.cuda
def test_the_device_idles_inside_the_entry_s_spans(card, tmp_path):
    """One `render()` of the 120k-triangle trefoil under
    `profiling.device_trace`: every interval over 1 ms in which no device
    operation runs lies, for at least 90% of its length, inside a span
    below `rpt.render` (the digest, the image's tone map, ...). A profiler
    the program did not start sees no `rpt.*` event, on the host or on the
    device's timeline."""
    cuda = torch.autograd.DeviceType.CUDA
    r = Renderer(scenes.build_pegasus_trefoil_scene(), scenes.pegasus_camera(), width=400, height=400,
                 exposure_value=-1.5, max_bounces=8, num_samples=2)
    r.render()  # the scene's build and the graph's capture
    with profiling.device_trace(str(tmp_path)) as prof:
        # The profiler's first launch waits 3-5 ms for its activity buffer
        # ("Activity Buffer Request"): the profiler's time, kept out of the render.
        torch.zeros(1, device=card)
        torch.cuda.synchronize()
        r.render()
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("rpt.") and e.device_type != cuda]
    ops = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == cuda and not e.name.startswith("rpt."))
    (root,) = [(s, e) for n, s, e in spans if n == "rpt.render"]
    below = [(s, e) for n, s, e in spans if n != "rpt.render"]
    gaps, last = [], root[0]
    for s, e in ops:
        if s > last:
            gaps.append((last, min(s, root[1])))
        last = max(last, e)
    gaps.append((last, root[1]))
    idle = [(s, e) for s, e in gaps if e - s > 1000.0]  # microseconds
    assert ops and idle
    for s, e in idle:
        assert _covered(s, e, below) >= 0.9 * (e - s), (s - root[0], e - s, sorted(spans, key=lambda x: x[1]))

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as bare:
        r.render()
    assert bare.events() and not [e.name for e in bare.events() if e.name.startswith("rpt.")]


def test_the_image_is_tone_mapped_on_the_card(card):
    """`Buffer.image()` maps the mean on the card (`rpt.image.tonemap` says
    `on="cuda"`) and copies one byte a channel (`rpt.image.to_host`): the
    numpy map's bytes of the same mean, bit for bit. The float64 table on
    the card gives the numpy map's bytes on the values at each side of every
    threshold, the signed zeros, infinities and NaN."""
    import time

    from rpt_tpu_torch.color import byte_thresholds, color_bytes

    scene = Scene()
    scene.add(Object(sphere()).material(Material.diffuse((0.7, 0.6, 0.5))))
    scene.environment.color[:] = (1.5, 1.0, 0.5)
    cam = Camera.look_at([0.0, 0.0, 5.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 0.8)
    buf = Renderer(scene, cam, width=40, height=24, max_bounces=2, num_samples=2, seed=9).render_buffer()
    t0 = time.perf_counter_ns()
    with profiling.recording():
        img = buf.image()
    recorded = [s for s in profiling.spans() if s.start_ns >= t0]
    assert img.dtype == np.uint8 and np.array_equal(img, color_bytes(buf.mean_image().cpu().numpy()))
    (image,) = [s for s in recorded if s.name == "rpt.image"]
    tonemap, to_host = sorted((s for s in recorded if s.parent == image.id), key=lambda s: s.start_ns)
    assert (tonemap.name, to_host.name) == ("rpt.image.tonemap", "rpt.image.to_host")
    assert tonemap.attrs == {"on": "cuda"} and to_host.attrs == {"bytes": 40 * 24 * 3}

    t, _ = byte_thresholds(np.float64)
    x = np.concatenate([np.nextafter(t, -np.inf), t, np.nextafter(t, np.inf),
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 5e-324], np.linspace(-0.5, 2.0, 100_001)])
    with np.errstate(invalid="ignore"):
        want64, want32 = color_bytes(x), color_bytes(x.astype(np.float32))
    assert np.array_equal(color_bytes(torch.from_numpy(x).to(card)), want64)
    assert np.array_equal(color_bytes(torch.from_numpy(x).to(card, torch.float32)), want32)


# ---------------------------------------------------------------------------
# The scatter kernel
# ---------------------------------------------------------------------------


def _scatter_wavefronts(dtype, monkeypatch):
    """The scatter inputs (key, mat, n, wo, found) of depths 0 and 3 of one
    eager sample of the pegasus_trefoil and wine_glass_trefoil scenes at a
    reduced size, by (scene, depth)."""
    from rpt_tpu_torch import integrator

    seen = []
    scatter = integrator.scatter

    def recording(*args):
        seen.append(args)
        return scatter(*args)

    monkeypatch.setattr(integrator, "scatter", recording)
    # The 5,000-triangle knot takes the bvh8 walk and the morton-sorted
    # wavefront, whose normals come back as a column slice of a packed gather.
    monkeypatch.setattr(scene_mod, "WIDE_KERNEL_MIN_TRIS", 4096)
    mesh = scenes.trefoil_mesh(125, 20)
    cases = {"pegasus": (scenes.build_pegasus_trefoil_scene(mesh, sky_height=64), scenes.pegasus_camera()),
             "wine_glass": (scenes.build_wine_glass_trefoil_scene(mesh), scenes.wine_glass_camera())}
    out = {}
    for name, (scene, cam) in cases.items():
        seen.clear()
        r = Renderer(scene, cam, width=96, height=72, max_bounces=4, num_samples=1, seed=3, dtype=dtype)
        r._sample_into_eager(Buffer.new(r.width, r.height, dtype=dtype), 1)
        assert len(seen) == 4
        out[name, 0], out[name, 3] = seen[0], seen[3]
    return out


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32) if t.is_floating_point() else t


def _assert_scatter_bits(got, want, label):
    for name, g, w in zip(("wi", "w", "ok"), got, want):
        bad = (_bits(g) != _bits(w)).reshape(g.shape[0], -1).any(-1)
        first = bad.nonzero()[:3].flatten().tolist()
        assert not bad.any(), f"{label} {name}: {int(bad.sum())} lanes differ, first {first}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_scatter_kernel_matches_plain(card, dtype, monkeypatch):
    """On the depth-0 and depth-3 wavefronts of both configurations (hits
    and misses, rough ice, near-specular clear glass, the diffuse floors,
    lanes in total internal reflection), the kernel's wi, w and ok are the
    plain version's bit for bit, launched eagerly and inside a captured
    graph; the counted wrapper adds one launch a call, in its type's slot."""
    from rpt_tpu_torch.materials import sample_draws, sample_f_drawn
    from rpt_tpu_torch.ops import scatter as scatter_mod
    from rpt_tpu_torch.utils.cuda_graph import Capture

    slot = 0 if dtype == torch.float32 else 1
    tir, rough = {}, {}
    for (name, depth), (key, mat, n, wo, found) in _scatter_wavefronts(dtype, monkeypatch).items():
        label = f"{name} depth {depth}"
        assert n.dtype == dtype and found.any() and (~found).any(), label
        draws = sample_draws(key, (n.shape[0],), card, dtype)
        want = scatter_mod.scatter_plain(draws, mat, n, wo, found)
        _assert_scatter_bits(scatter_mod.scatter_kernel(draws, mat, n, wo, found), want, label)
        rough[name] = rough.get(name, set()) | set(mat.roughness[found].tolist())
        valid = sample_f_drawn(draws, mat, n, wo)[2]
        tir[name] = tir.get(name, 0) + int((found & ~valid).sum())

        before = kernels.launch_counts(by_slot=True)[scatter_mod.scatter][slot]
        _assert_scatter_bits(scatter_mod.scatter(key, mat, n, wo, found), want, label + " (counted)")
        outs = []
        graph = Capture(lambda: outs.append(scatter_mod.scatter(key, mat, n, wo, found)), card, "scatter").graph
        after_capture = kernels.launch_counts(by_slot=True)[scatter_mod.scatter][slot]
        graph.replay()
        torch.cuda.synchronize()
        _assert_scatter_bits(outs[-1], want, label + " (graph)")
        after = kernels.launch_counts(by_slot=True)[scatter_mod.scatter]
        assert after_capture - before == 2 and after[slot] - after_capture == 1, label
    # Both materials of each scene (the light's roughness is the floor's), and
    # lanes in total internal reflection in both.
    assert all(len(r) == 2 and 1.0 in r for r in rough.values()) and len(rough) == 2
    assert tir["pegasus"] > 0 and tir["wine_glass"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_scatter_kernel_under_autograd_matches_plain(card, dtype, monkeypatch):
    """Where the material columns, the normals and wo require grad, the
    wrapper still launches the kernel (once, counted), which also returns
    the weight's divisor, and rebuilds the weight in torch on its samples:
    values and gradient are the plain version's bit for bit on the depth-0
    and depth-3 wavefronts of both configurations."""
    import dataclasses

    from rpt_tpu_torch.materials import sample_draws
    from rpt_tpu_torch.ops import scatter as scatter_mod

    slot = 0 if dtype == torch.float32 else 1
    weights = torch.tensor([0.3, 0.5, 0.7], dtype=dtype, device=card)
    for (name, depth), (key, mat, n, wo, found) in _scatter_wavefronts(dtype, monkeypatch).items():
        label = f"{name} depth {depth}"
        out = {}
        for way in ("kernel", "plain"):
            # The gathered columns are the leaves: no gather's backward, whose
            # atomic adds would reorder sums.
            cols = {f.name: getattr(mat, f.name).detach().clone().requires_grad_() for f in dataclasses.fields(mat)}
            rays = {"n": n.detach().clone().requires_grad_(), "wo": wo.detach().clone().requires_grad_()}
            leaves = type(mat)(**cols)
            before = kernels.launch_counts(by_slot=True)[scatter_mod.scatter][slot]
            if way == "kernel":
                got = scatter_mod.scatter(key, leaves, rays["n"], rays["wo"], found)
            else:
                draws = sample_draws(key, (n.shape[0],), card, dtype)
                got = scatter_mod.scatter_plain(draws, leaves, rays["n"], rays["wo"], found)
            inputs = {**cols, **rays}
            grads = torch.autograd.grad((got[1] * weights).sum(), list(inputs.values()), allow_unused=True)
            torch.cuda.synchronize()
            launched = kernels.launch_counts(by_slot=True)[scatter_mod.scatter][slot] - before
            out[way] = (tuple(t.detach() for t in got), dict(zip(inputs, grads)), launched)
        (got, g_kern, launched), (want, g_plain, plain_launched) = out["kernel"], out["plain"]
        assert launched == 1 and plain_launched == 0, label
        _assert_scatter_bits(got, want, label + " (autograd)")
        for f, g in g_plain.items():
            assert (g_kern[f] is None) == (g is None), f"{label} {f}"
            if g is not None:
                assert torch.equal(_bits(g_kern[f]), _bits(g)), f"{label}: the gradient of {f} differs"
        assert float(g_kern["roughness"].abs().max()) > 0.0 and float(g_kern["n"].abs().max()) > 0.0, label
