"""Two-level instanced BVH: a TLAS over instances, one shared BLAS per mesh
(`rpt_tpu/ops/tlas.py`).

Every unique mesh gets ONE binary BLAS over its local-space triangles, and
all BLASes are concatenated so a node index can point into any of them. The
TLAS is a binary BVH over the instances' world boxes, one instance per leaf.
An instance is an affine world->local transform, a normal matrix, a material
and its mesh's BLAS. Memory is O(unique triangles + instances) instead of
O(instances x triangles) for a bake.

Both trees come from the native SAH builder (a copy of the JAX package's),
so `build_instanced` gives arrays identical to the reference's on the same
meshes and instances. The binary kernels of `ops/tlas2.py` walk the two
trees as built, each internal node re-encoded with both children's boxes;
the wide kernels of `ops/tlas8.py` walk them collapsed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..native import build_bvh_sah
from ..utils.vmath import normalize
from .bvh import LEAF_SIZE, _tri_hit_t, outward, widen
from .intersect import INF, Hit

__all__ = ["InstancedMeshes", "build_instanced", "instanced_closest_hit", "instanced_from_arrays", "packed_leaves",
           "holding_boxes", "finish_instanced"]

_FLOAT_FIELDS = ("t_min", "t_max", "b_min", "b_max", "verts", "norms", "inst_inv", "inst_nmat")


@dataclasses.dataclass(frozen=True)
class InstancedMeshes:
    """Flattened two-level BVH over mesh instances."""

    # TLAS over instances (one instance per leaf)
    t_min: torch.Tensor  # (Mt, 3) world space
    t_max: torch.Tensor  # (Mt, 3)
    t_leaf_inst: torch.Tensor  # (Mt,) instance id at leaves, -1 internal
    t_skip: torch.Tensor  # (Mt,)
    # Concatenated BLAS nodes (skip links are global indices)
    b_min: torch.Tensor  # (Mb, 3) local space
    b_max: torch.Tensor  # (Mb, 3)
    b_is_leaf: torch.Tensor  # (Mb,)
    b_skip: torch.Tensor  # (Mb,)
    b_leaf_tris: torch.Tensor  # (Mb, LEAF_SIZE) global triangle ids, -1 pad
    # Concatenated local-space triangles
    verts: torch.Tensor  # (T, 3, 3)
    norms: torch.Tensor  # (T, 3, 3)
    # Instances
    inst_inv: torch.Tensor  # (K, 3, 4) world->local affine
    inst_nmat: torch.Tensor  # (K, 3, 3) inverse-transpose linear
    inst_mat: torch.Tensor  # (K,) material id
    inst_root: torch.Tensor  # (K,) global BLAS root node of this instance
    inst_end: torch.Tensor  # (K,) global index one past this instance's BLAS

    @property
    def num_tlas_nodes(self) -> int:
        return self.t_min.shape[0]


def instanced_from_arrays(arrays: dict, device=None, dtype=torch.float32) -> InstancedMeshes:
    """InstancedMeshes from host arrays keyed by field name (floats in
    `dtype`, indices int32)."""
    return InstancedMeshes(**{
        f.name: torch.as_tensor(
            np.ascontiguousarray(arrays[f.name]),
            dtype=dtype if f.name in _FLOAT_FIELDS else torch.int32,
            device=device,
        )
        for f in dataclasses.fields(InstancedMeshes)
    })


def _build_flat_bvh(prim_min: np.ndarray, prim_max: np.ndarray, leaf_size: int):
    """Binned-SAH BVH over primitive boxes, flattened in DFS preorder with
    skip links. Returns (node_min, node_max, skip, leaf_lists) where
    leaf_lists[i] is the primitive-index array at node i, or None for an
    internal node."""
    node_min, node_max, is_leaf, skip, leaf_start, leaf_count, perm = build_bvh_sah(
        np.asarray(prim_min, np.float32), np.asarray(prim_max, np.float32), leaf_size
    )
    leaf_lists = [
        perm[leaf_start[i]:leaf_start[i] + leaf_count[i]] if is_leaf[i] else None
        for i in range(node_min.shape[0])
    ]
    return node_min, node_max, skip, leaf_lists


def _transform_bbox(matrix: np.ndarray, p_min: np.ndarray, p_max: np.ndarray):
    """World box of a transformed local box, through its 8 corners."""
    corners = np.array([[x, y, z] for x in (p_min[0], p_max[0]) for y in (p_min[1], p_max[1])
                        for z in (p_min[2], p_max[2])])
    world = corners @ matrix[:3, :3].T + matrix[:3, 3]
    return world.min(axis=0), world.max(axis=0)


def build_instanced(
    meshes: Sequence,  # Mesh-likes (.vertices, .normals), unique geometry
    instances: Sequence[Tuple[int, np.ndarray, int]],  # (mesh index, 4x4 matrix, material id)
    dtype=torch.float32,
    device=None,
) -> InstancedMeshes:
    """Build the two-level structure on the host (numpy, in f64, then cast
    to `dtype` as the reference does; its node boxes are the SAH build's
    float32 values) and place it on `device`."""
    # --- BLAS per unique mesh, concatenated --------------------------------
    b_min_all, b_max_all, b_leaf_all, b_skip_all = [], [], [], []
    verts_all, norms_all = [], []
    blas_root, blas_end, blas_bounds = [], [], []
    node_off = tri_off = 0
    for mesh in meshes:
        v = np.asarray(mesh.vertices, np.float64)
        nrm = np.asarray(mesh.normals, np.float64)
        nmin, nmax, skip, leaves = _build_flat_bvh(v.min(axis=1), v.max(axis=1), LEAF_SIZE)
        M = nmin.shape[0]
        leaf_tris = np.full((M, LEAF_SIZE), -1, np.int64)
        for nid, lst in enumerate(leaves):
            if lst is not None:
                leaf_tris[nid, :lst.shape[0]] = lst + tri_off
        b_min_all.append(nmin)
        b_max_all.append(nmax)
        b_skip_all.append(skip + node_off)
        b_leaf_all.append(leaf_tris)
        verts_all.append(v)
        norms_all.append(nrm)
        blas_root.append(node_off)
        blas_bounds.append((nmin[0], nmax[0]))
        node_off += M
        blas_end.append(node_off)
        tri_off += v.shape[0]
    b_leaf_tris = np.concatenate(b_leaf_all)

    # --- Instances ----------------------------------------------------------
    K = len(instances)
    inst_inv = np.zeros((K, 3, 4))
    inst_nmat = np.zeros((K, 3, 3))
    inst_mat = np.zeros(K, np.int32)
    inst_root = np.zeros(K, np.int32)
    inst_end = np.zeros(K, np.int32)
    w_min = np.zeros((K, 3))
    w_max = np.zeros((K, 3))
    for k, (mesh_idx, matrix, mat_id) in enumerate(instances):
        matrix = np.asarray(matrix, np.float64)
        inst_inv[k] = np.linalg.inv(matrix)[:3, :4]
        inst_nmat[k] = np.linalg.inv(matrix[:3, :3]).T
        inst_mat[k] = mat_id
        inst_root[k] = blas_root[mesh_idx]
        inst_end[k] = blas_end[mesh_idx]
        w_min[k], w_max[k] = _transform_bbox(matrix, *blas_bounds[mesh_idx])

    # --- TLAS over instance world boxes (one instance per leaf) -------------
    t_min, t_max, t_skip, t_leaves = _build_flat_bvh(w_min, w_max, 1)
    t_leaf_inst = np.full(t_min.shape[0], -1, np.int32)
    for nid, lst in enumerate(t_leaves):
        if lst is not None:
            t_leaf_inst[nid] = lst[0]

    return instanced_from_arrays(dict(
        t_min=t_min, t_max=t_max, t_leaf_inst=t_leaf_inst, t_skip=t_skip,
        b_min=np.concatenate(b_min_all), b_max=np.concatenate(b_max_all),
        b_is_leaf=(b_leaf_tris[:, 0] >= 0).astype(np.int32), b_skip=np.concatenate(b_skip_all),
        b_leaf_tris=b_leaf_tris, verts=np.concatenate(verts_all), norms=np.concatenate(norms_all),
        inst_inv=inst_inv, inst_nmat=inst_nmat, inst_mat=inst_mat, inst_root=inst_root, inst_end=inst_end,
    ), device, dtype)


def packed_leaves(im: InstancedMeshes):
    """The kernels' triangle order (the reference's `pack_tlas_for_pallas`
    packing, shared by `ops/tlas8.py` and `ops/tlas2.py`): local-space
    triangles leaf-contiguous and 8-aligned, one block of LEAF_SIZE rows per
    BLAS leaf in node order, a short leaf padded with its first triangle.
    Returns (leaf_start (Mb,), leaf_count (Mb,), 0 at internal nodes;
    p_verts, p_norms (L*8, 3, 3))."""
    b_leaf_tris = im.b_leaf_tris.cpu().numpy().astype(np.int64)
    Mb = b_leaf_tris.shape[0]
    leaves = np.flatnonzero(b_leaf_tris[:, 0] >= 0)  # leaf lists are filled from the front
    rows = b_leaf_tris[leaves]
    leaf_count = np.zeros(Mb, np.int64)
    leaf_count[leaves] = (rows >= 0).sum(1)
    leaf_start = np.zeros(Mb, np.int64)
    leaf_start[leaves] = LEAF_SIZE * np.arange(leaves.shape[0])
    perm = np.where(rows >= 0, rows, rows[:, :1]).reshape(-1)
    return leaf_start, leaf_count, im.verts.cpu().numpy()[perm], im.norms.cpu().numpy()[perm]


def holding_boxes(im: "InstancedMeshes"):
    """float32 boxes of the TLAS nodes (Mt, 3) that hold, in world space,
    every triangle of every instance below them, for a float64 pack. The
    SAH build's world boxes come from a float32 local box through a float64
    transform and are rounded to nearest, so they can miss a sliver of an
    instance. Here each instance's box is its BLAS root's, widened one
    float32 ulp, taken to world space through the inverse of its
    world->local rows, padded by a bound on that transform's rounding
    (1e-12 of the terms' magnitude) and rounded outward; an internal node
    holds the union of its two children. Returns (lo, hi) float32."""
    b_min, b_max = im.b_min.cpu().numpy(), im.b_max.cpu().numpy()
    inv = im.inst_inv.cpu().numpy().astype(np.float64)
    roots = im.inst_root.cpu().numpy().astype(np.int64)
    K = inv.shape[0]
    lo_l, hi_l = (b.astype(np.float64) for b in widen(b_min[roots], b_max[roots]))
    full = np.zeros((K, 4, 4))
    full[:, :3, :] = inv
    full[:, 3, 3] = 1.0
    l2w = np.linalg.inv(full)
    corners = np.stack([np.stack([np.where(c >> a & 1, hi_l[:, a], lo_l[:, a]) for a in range(3)], -1)
                        for c in range(8)], 1)  # (K, 8, 3)
    world = np.einsum("kij,kcj->kci", l2w[:, :3, :3], corners) + l2w[:, None, :3, 3]
    pad = 1e-12 * (np.einsum("kij,kcj->kci", np.abs(l2w[:, :3, :3]), np.abs(corners))
                   + np.abs(l2w[:, None, :3, 3])).max(1)
    w_lo, w_hi = outward(world.min(1) - pad, world.max(1) + pad)

    leaf_inst = im.t_leaf_inst.cpu().numpy().astype(np.int64)
    skip = im.t_skip.cpu().numpy().astype(np.int64)
    Mt = leaf_inst.shape[0]
    lo = np.zeros((Mt, 3), np.float32)
    hi = np.zeros((Mt, 3), np.float32)
    for i in range(Mt - 1, -1, -1):  # children follow their parent in preorder
        if leaf_inst[i] >= 0:
            lo[i], hi[i] = w_lo[leaf_inst[i]], w_hi[leaf_inst[i]]
        else:
            a, b = i + 1, skip[i + 1]
            lo[i], hi[i] = np.minimum(lo[a], lo[b]), np.maximum(hi[a], hi[b])
    return lo, hi


def _affine(A, p, w: float):
    """A (N, 3, 4) applied to points (w = 1) or directions (w = 0), written
    out elementwise (an einsum runs as a batched gemv on the card)."""
    out = (A[:, :, :3] * p[:, None, :]).sum(-1)
    return out + A[:, :, 3] if w else out


def finish_instanced(im: InstancedMeshes, pack, o, d, t_min, t_raw, tri, inst, active) -> Hit:
    """The Hit of a two-level walk's (t_raw, packed triangle id, instance
    id) over `pack` (`ops/tlas8.py` or `ops/tlas2.py`: both keep the packed
    triangles of `packed_leaves`): barycentrics in the winner's instance
    frame, the interpolated normal lifted by the instance's normal matrix,
    and the instance's material (as the reference's XLA loop finalizes,
    `rpt_tpu/ops/tlas.py` `instanced_closest_hit`, in the pack's type: its
    Pallas wrapper reads float32 vertices and does not run under
    jax_enable_x64); t = inf on a miss and on an inactive lane. The 3x3
    products are written out elementwise: as an einsum they run as a
    batched gemv on the card."""
    tri = torch.clamp(tri.long(), 0, pack.p_verts.shape[0] - 1)
    inst = torch.clamp(inst.long(), 0, pack.inst.shape[0] - 1)
    A = pack.inst[inst].view(-1, 3, 4)
    tv, tn = pack.p_verts[tri], pack.p_norms[tri]
    _, (u, v, w) = _tri_hit_t(_affine(A, o, 1), _affine(A, d, 0), tv[:, 0], tv[:, 1], tv[:, 2], t_min)
    n_local = u[:, None] * tn[:, 0] + v[:, None] * tn[:, 1] + w[:, None] * tn[:, 2]
    n_world = normalize((im.inst_nmat[inst] * n_local[:, None, :]).sum(-1))
    t = torch.where(t_raw >= 1.0e38, torch.full_like(t_raw, INF), t_raw)
    if active is not None:
        t = torch.where(active, t, torch.full_like(t, INF))
    return Hit(t=t, normal=n_world, mat_id=im.inst_mat[inst])


def instanced_closest_hit(im: InstancedMeshes, o, d, t_min, active=None) -> Hit:
    """Closest hit of N rays against every mesh instance, as the reference's
    XLA loop (`rpt_tpu/ops/tlas.py` `instanced_closest_hit`) answers it: the
    nearest triangle, among equal t the first TLAS leaf and then the first
    BLAS leaf in preorder; t = inf on a miss and on an inactive lane. It runs
    the binary two-level walk's plain version (`ops/tlas2.py`) on the rays'
    device, over a pack made for the call; a scene compiles its pack once
    and calls the kernels' wrappers instead."""
    from .tlas2 import pack_tlas2, tlas2_closest_plain
    from .walk import check_dtype

    pack = pack_tlas2(im, device=o.device)
    check_dtype(pack, o, d)
    t_raw, tri, inst = tlas2_closest_plain(pack, o, d, t_min, active)
    return finish_instanced(im, pack, o, d, t_min, t_raw, tri, inst, active)
