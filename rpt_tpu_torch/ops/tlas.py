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
meshes and instances. `instanced_closest_hit` is the plain lockstep
two-level skip-link walk (the counterpart of the reference's XLA
while-loop); the wide kernels of `ops/tlas8.py` walk the same instances.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..native import build_bvh_sah
from ..utils.vmath import normalize
from .bvh import LEAF_SIZE, _safe_inv, _tri_hit_t
from .intersect import INF, Hit

__all__ = ["InstancedMeshes", "build_instanced", "instanced_closest_hit", "instanced_from_arrays"]

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


def instanced_from_arrays(arrays: dict, device=None) -> InstancedMeshes:
    """InstancedMeshes from host arrays keyed by field name (f32 and i32)."""
    return InstancedMeshes(**{
        f.name: torch.as_tensor(
            np.ascontiguousarray(arrays[f.name]),
            dtype=torch.float32 if f.name in _FLOAT_FIELDS else torch.int32,
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
    device=None,
) -> InstancedMeshes:
    """Build the two-level structure on the host (numpy, f64 then f32 as the
    reference does) and place it on `device`."""
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
    ), device)


def _slab(bmin, bmax, o, inv_d, t_min, t_best):
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    lo = torch.amax(torch.minimum(t1, t2), dim=-1)
    hi = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (lo <= hi) & (hi >= t_min) & (lo <= t_best)


def _affine(A, p, w: float):
    """A (N, 3, 4) applied to points (w = 1) or directions (w = 0)."""
    out = torch.einsum("nij,nj->ni", A[:, :, :3], p)
    return out + A[:, :, 3] if w else out


def instanced_closest_hit(im: InstancedMeshes, o: torch.Tensor, d: torch.Tensor, t_min, active=None) -> Hit:
    """Closest hit of N rays against every mesh instance.

    Each step, a ray takes either a TLAS step (world ray against an
    instance box) or a BLAS step (local ray against the current instance's
    node and leaf triangles), by its mode flag. Local directions are not
    normalized, so hit times stay in the world parameterization and the
    running-best prune holds at both levels. Lanes with `active=False` park
    at the TLAS sentinel and come back as misses.
    """
    N = o.shape[0]
    dev = o.device
    Mt = im.num_tlas_nodes
    Mb = im.b_min.shape[0]
    inv_d = _safe_inv(d)
    t_leaf_inst, t_skip = im.t_leaf_inst.long(), im.t_skip.long()
    b_is_leaf, b_skip, b_leaf_tris = im.b_is_leaf.bool(), im.b_skip.long(), im.b_leaf_tris.long()
    inst_root, inst_end = im.inst_root.long(), im.inst_end.long()

    zeros = torch.zeros(N, dtype=torch.int64, device=dev)
    in_blas = torch.zeros(N, dtype=torch.bool, device=dev)
    tptr = zeros.clone() if active is None else torch.where(active, zeros, torch.full_like(zeros, Mt))
    bptr, bend, inst = zeros.clone(), zeros.clone(), zeros.clone()
    o_l, d_l, inv_dl = torch.zeros_like(o), torch.ones_like(d), torch.ones_like(d)
    t_best = torch.full((N,), INF, dtype=o.dtype, device=dev)
    best_tri, best_inst = zeros.clone(), zeros.clone()

    while bool((in_blas | (tptr < Mt)).any()):
        # TLAS step (rays not inside a BLAS)
        t_active = ~in_blas & (tptr < Mt)
        p = torch.clamp(tptr, max=Mt - 1)
        hit_box = _slab(im.t_min[p], im.t_max[p], o, inv_d, t_min, t_best)
        leaf_inst = t_leaf_inst[p]
        is_leaf_t = leaf_inst >= 0
        enter = t_active & is_leaf_t & hit_box
        descend = t_active & ~is_leaf_t & hit_box
        tptr = torch.where(t_active, torch.where(descend, p + 1, t_skip[p]), tptr)

        # Entering rays: into instance-local space
        e_inst = torch.clamp(leaf_inst, min=0)
        A = im.inst_inv[e_inst]
        d_e = _affine(A, d, 0)
        inst = torch.where(enter, e_inst, inst)
        o_l = torch.where(enter[:, None], _affine(A, o, 1), o_l)
        d_l = torch.where(enter[:, None], d_e, d_l)
        inv_dl = torch.where(enter[:, None], _safe_inv(d_e), inv_dl)
        bptr = torch.where(enter, inst_root[e_inst], bptr)
        bend = torch.where(enter, inst_end[e_inst], bend)
        in_blas = in_blas | enter

        # BLAS step (rays inside a BLAS; entering rays start next step)
        b_active = in_blas & ~enter
        q = torch.clamp(bptr, max=Mb - 1)
        hit_b = _slab(im.b_min[q], im.b_max[q], o_l, inv_dl, t_min, t_best)
        leaf_b = b_is_leaf[q]
        process = b_active & leaf_b & hit_b
        tris = b_leaf_tris[q]
        tid = torch.clamp(tris, min=0)
        tv = im.verts[tid]  # (N, K, 3, 3)
        t_hits, _ = _tri_hit_t(o_l[:, None, :], d_l[:, None, :], tv[:, :, 0], tv[:, :, 1], tv[:, :, 2], t_min)
        t_hits = torch.where((tris >= 0) & process[:, None], t_hits, torch.full_like(t_hits, INF))
        t_leaf, k_best = torch.min(t_hits, dim=1)
        better = t_leaf < t_best
        t_best = torch.where(better, t_leaf, t_best)
        best_tri = torch.where(better, torch.gather(tid, 1, k_best[:, None])[:, 0], best_tri)
        best_inst = torch.where(better, inst, best_inst)

        go_deeper = b_active & ~leaf_b & hit_b
        bptr = torch.where(b_active, torch.where(go_deeper, q + 1, b_skip[q]), bptr)
        # BLAS finished: back to the TLAS (tptr already points past the leaf)
        in_blas = in_blas & ~(b_active & (bptr >= bend))

    # Barycentrics of the winner in its instance's frame, the interpolated
    # shading normal, lifted by the inverse-transpose.
    A = im.inst_inv[best_inst]
    tv = im.verts[best_tri]
    _, (u, v, w) = _tri_hit_t(_affine(A, o, 1), _affine(A, d, 0), tv[:, 0], tv[:, 1], tv[:, 2], t_min)
    tn = im.norms[best_tri]
    n_local = u[:, None] * tn[:, 0] + v[:, None] * tn[:, 1] + w[:, None] * tn[:, 2]
    n_world = normalize(torch.einsum("nij,nj->ni", im.inst_nmat[best_inst], n_local))
    return Hit(t=t_best, normal=n_world, mat_id=im.inst_mat[best_inst])
