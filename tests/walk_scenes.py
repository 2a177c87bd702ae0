"""Scenes on which the walks' edge cases show, in numpy (and torch for the
rays): no JAX, so the card tests and chip_smoke.py build them too.

- `twin_leaves`: coincident triangles in two leaves of one tree, which a
  near-first walk reaches in either order (ties at one t);
- `edge_scene`: flat leaves whose box entry is their exit, under scaled
  instances, with rays that meet a triangle just inside or outside its edge
  (a box test at its edge, the any hit at t_max = t);
- `coincident_instances`: every instance doubled under its transform with
  another material (ties between instances), of the same mesh or of a
  wider one holding the same triangles;
- `walk_scene`: one of them built for a walk family, with its rays.
"""

import numpy as np
import torch

from rpt_tpu_torch.ops.bvh import build_bvh
from rpt_tpu_torch.ops.tlas import build_instanced
from rpt_tpu_torch.shapes import Mesh


def twin_leaves(n_groups, seed):
    """Groups of twenty triangles whose boxes share one center (the
    builder's centroid; every coordinate a multiple of 1/8, so exactly), so
    the builder chops each group, in input order, into two subtrees of two
    leaves each: the first holds a horizontal triangle and nine small
    vertical ones, the second its exact twin (another material) and nine
    tall vertical ones, whose box reaches up towards rays from above. A ray
    down onto the twins enters the second subtree first, finds the twin,
    and ties with the first subtree's triangle, which comes first in
    preorder and must win."""
    rng = np.random.default_rng(seed)
    flat = np.array([[-0.25, -0.25, 0.0], [0.25, -0.25, 0.0], [-0.25, 0.25, 0.0]])
    small = np.array([[0.0, -0.125, -0.125], [0.0, 0.125, -0.125], [0.0, -0.125, 0.125]])
    tall = np.array([[0.0, -0.125, -1.0], [0.0, 0.125, -1.0], [0.0, -0.125, 1.0]])
    verts, mats = [], []
    for c in rng.permutation([(3.0 * i, 3.0 * j, 0.125 * ((i + j) % 5)) for i in range(-3, 4) for j in range(-3, 4)])[:n_groups]:
        verts += [c + flat] + [c + small] * 9 + [c + flat] + [c + tall] * 9
        mats += [0] + [2] * 9 + [1] + [3] * 9
    verts = np.array(verts, np.float32)
    e = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    norms = np.repeat((e / np.linalg.norm(e, axis=-1, keepdims=True))[:, None], 3, axis=1).astype(np.float32)
    flats = verts[0::20]
    w = rng.dirichlet(np.ones(3), 400)
    target = np.einsum("rk,rkj->rj", w, flats[rng.integers(0, n_groups, 400)])
    d = np.concatenate([rng.uniform(-0.05, 0.05, (400, 2)), -np.ones((400, 1))], axis=1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = target - 4.0 * d
    o[::10, 0] += 50.0  # every tenth ray misses
    return verts, norms, np.array(mats, np.int32), o.astype(np.float32), d.astype(np.float32)


def edge_scene():
    """One mesh under four instances of non-unit, unequal scales: a flat
    triangle (z = 0) whose right edge stands at x = 1, six smaller flat
    triangles left of it (the leaf that holds them all is flat, and its
    x-face is that edge), and a far cluster that widens the mesh's box.
    Rays meet the triangle at x = 1 - delta, one unit in from its ends, at
    a slant that leaves the leaf's box just past the hit: a ray's z-slab
    entry is its exit, and its x-slab exit follows the hit by about
    20 delta. Negative delta lands just outside the edge. Half the rays
    start 2 from the hit, half 300: there a float copy of the origin is
    off by far more than the box's outward ulp. The smallest instance
    (scales of 1/400 and less) puts a ray's local origin some 1,000 units
    out, on a local direction of some 400 a unit of t."""
    rng = np.random.default_rng(21)
    edge = np.array([[[1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]])
    base = rng.uniform([-1.0, -1.0, 0.0], [0.5, 0.7, 0.0], (6, 1, 3))
    small = base + np.array([[0.0, 0.0, 0.0], [0.3, 0.05, 0.0], [0.1, 0.3, 0.0]])
    far = rng.uniform([2.0, 4.0, -1.0], [3.5, 5.0, 1.0], (20, 1, 3)) + rng.uniform(-0.2, 0.2, (20, 3, 3))
    verts = np.concatenate([edge, small, far])
    e = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    norms = np.repeat((e / np.linalg.norm(e, axis=-1, keepdims=True))[:, None], 3, axis=1)
    instances = []
    for k, (scale, angle, shift) in enumerate([((2.5, 0.75, 1.5), 0.3, (0.0, 0.0, 0.0)),
                                                ((0.3, 1.7, 0.9), -1.1, (6.0, -2.0, 1.0)),
                                                ((1.3, 1.3, 0.6), 2.0, (-5.0, 3.0, -2.0)),
                                                ((0.002, 0.003, 0.0025), 0.7, (2.0, 7.0, 3.0))]):
        c, s = np.cos(angle), np.sin(angle)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]) @ np.diag(scale)
        m[:3, 3] = shift
        instances.append((0, m, k + 1))
    o, d, delta, inst, dist = [], [], [], [], []
    for k, (_, m, _) in enumerate(instances):
        # The smallest instance's local origins lie up to 150,000 units out,
        # where double rounding alone moves a hit by some 2e-11: its rays
        # start at 1e-10 inside.
        for dlt in (1e-12 if k < 3 else 1e-10, 1e-10, 1e-8, 1e-6, -1e-9, -1e-6):
            y = rng.uniform(-0.5, 0.5, 12)
            p = np.stack([np.full(12, 1.0 - dlt), y, np.zeros(12)], -1)
            dl = np.stack([np.full(12, 0.05), rng.uniform(-0.2, 0.2, 12), np.full(12, -1.0)], -1)
            dw = dl @ m[:3, :3].T
            dw /= np.linalg.norm(dw, axis=-1, keepdims=True)
            t0 = np.tile([2.0, 300.0], 6)
            o.append((p @ m[:3, :3].T + m[:3, 3]) - t0[:, None] * dw)
            d.append(dw)
            delta.append(np.full(12, dlt))
            inst.append(np.full(12, k))
            dist.append(t0)
    o, d, delta, inst, dist = (np.concatenate(a) for a in (o, d, delta, inst, dist))
    return (verts, norms, instances), torch.as_tensor(o), torch.as_tensor(d), delta, inst, dist


def _random_mesh(n_tris, rng):
    base = rng.uniform(-1.0, 1.0, (n_tris, 1, 3))
    verts = np.concatenate([base, base + rng.uniform(-0.2, 0.2, (n_tris, 2, 3))], axis=1)
    e = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    e /= np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
    return verts, np.repeat(e[:, None], 3, axis=1)


def coincident_instances(copy: str, seed: int = 11, n_rays: int = 400):
    """Two random meshes under seven random transforms, every instance
    doubled under its transform with material + 1 (mod 4): a hit is a tie
    between twins. With `copy == "wider_mesh"` the first instance's twin is
    a third mesh, the first one's triangles and a copy moved by 1.2 in x (a
    wider box, so a near-first walk often reaches the later twin first).
    Returns ((verts, normals) per mesh, instances (mesh, 4x4, material), o,
    d float64 (N, 3)), the rays aimed at jittered world centroids from a
    sphere of radius 10."""
    rng = np.random.default_rng(seed)
    meshes = [_random_mesh(60, rng) for _ in range(2)]
    base = []
    for _ in range(7):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.eye(4)
        m[:3, :3] = q * rng.uniform(0.5, 1.5)
        m[:3, 3] = rng.uniform(-4.0, 4.0, 3)
        base.append((int(rng.integers(0, 2)), m, int(rng.integers(0, 4))))
    twin_mesh = None
    if copy == "wider_mesh":
        v, n = meshes[base[0][0]]
        meshes.append((np.concatenate([v, v + np.array([1.2, 0.0, 0.0])]), np.concatenate([n, n])))
        twin_mesh = 2
    instances = base + [(twin_mesh if (k == 0 and twin_mesh is not None) else mesh, m, (mat + 1) % 4)
                        for k, (mesh, m, mat) in enumerate(base)]
    cents = np.concatenate([meshes[mesh][0].mean(axis=1) @ m[:3, :3].T + m[:3, 3] for mesh, m, _ in base])
    o = rng.normal(size=(n_rays, 3))
    o *= 10.0 / np.linalg.norm(o, axis=-1, keepdims=True)
    d = cents[rng.integers(0, cents.shape[0], n_rays)] + rng.uniform(-0.01, 0.01, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return meshes, instances, o, d


def walk_scene(family: str, name: str, dtype, offset=(0.0, 0.0, 0.0)):
    """The scene `name` for the walk `family` on the CPU, in `dtype`, and its
    rays (o, d) in `dtype`: `twin_leaves` (one-level), `same_mesh` /
    `wider_mesh` coincident instances (two-level), or `edge` (two-level its
    instances; one-level the mesh under the rays re-expressed in each
    instance's frame, direction unnormalized, so t is the world t, the
    mesh and the origins translated by `offset`)."""
    if name == "twin_leaves":
        verts, norms, mats, o, d = twin_leaves(24, seed=21)
        tree = build_bvh(verts, norms, mats, dtype=dtype, device="cpu")
    elif name == "edge":
        (verts, norms, instances), o, d, _, inst, _ = edge_scene()
        o, d = o.numpy(), d.numpy()
        if family in ("bvh8", "bvh2"):
            A = np.stack([np.linalg.inv(m)[:3] for _, m, _ in instances])[inst]
            o = np.einsum("nij,nj->ni", A[:, :, :3], o) + A[:, :, 3] + offset
            d = np.einsum("nij,nj->ni", A[:, :, :3], d)
            tree = build_bvh(verts + offset, norms, np.zeros(verts.shape[0], np.int32), dtype=dtype, device="cpu")
        else:
            tree = build_instanced([Mesh(vertices=verts, normals=norms)], instances, dtype=dtype, device="cpu")
    else:
        meshes, instances, o, d = coincident_instances(name)
        tree = build_instanced([Mesh(vertices=v, normals=n) for v, n in meshes], instances, dtype=dtype, device="cpu")
    return tree, torch.as_tensor(o).to(dtype), torch.as_tensor(d).to(dtype)
