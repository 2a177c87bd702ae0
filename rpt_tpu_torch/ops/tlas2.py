"""Two-level binary-BVH traversal by skip links over instanced meshes:
closest hit and any hit, as CUDA kernels.

Replaces the two TPU kernels of `rpt_tpu/ops/tlas_pallas.py`: `_kernel`
(closest hit, reached through `tlas_closest_hit_pallas`) and `_kernel_occl`
(any hit, reached through `tlas_occluded_pallas`). The kernels are in
`rpt_tpu_torch/csrc/tlas2.cu`; this module holds the host pack, the plain
torch versions with the same contract, and the wrappers that choose between
them by the device of the rays. The hit finalize is the wide two-level
one (`ops/tlas8._finalize`): both packs keep the same packed triangle order.

The scene compiler takes these kernels for an instanced scene under
`RPT_BVH_KERNEL=binary`, and where the wide two-level pack refuses the
scene (`scene.choose_instanced_pack`). The reference keeps its tables in
SMEM and falls back to an XLA loop past a 700,000-byte budget; these tables
sit in device memory, and no scene is refused.

Layout. The two binary trees of `InstancedMeshes` as they are built, in
preorder with skip links, in the row format of `ops/bvh2.py`:

- `t_bounds` (Mt, 8) f32 world-space boxes; `t_meta` (Mt, 4) i32
  `[skip, instance id (-1 at an internal node), 0, 0]`;
- `b_bounds` (Mb, 8) f32 local-space boxes of every BLAS, concatenated;
  `b_meta` (Mb, 4) i32 `[skip, first packed triangle row, count, 0]`, the
  skip links global indices into the concatenation, as built;
- `inst` (K, 12) f32 world->local rows and `inst_range` (K, 2) i32
  `[BLAS root, one past the BLAS's last node]`;
- `tris` (L*8, 20) f32: the 20-float rows of the local-space triangles in
  the kernels' packed order (`tlas.packed_leaves`); `p_verts`, `p_norms`
  the same triangles for the finalize.

Walk: the TLAS by its skip links with the world ray; at a leaf whose box
the ray hits, the ray re-expressed in the instance's frame (direction
unnormalized, so local t == world t), the BLAS range [root, end) by its
skip links, then the TLAS again from the leaf's skip link. No stack. The
plain version repeats the kernel's arithmetic op for op; the two agree bit
for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .bvh import _safe_inv
from .bvh2 import node_hit, node_rows, skip_step
from .bvh8 import _BIG, _check_rays, _on_cpu, _ptr, _to_local, _tri_rows, finish_occluded, ray_t_max
from .intersect import INF, Hit
from .tlas import InstancedMeshes, packed_leaves
from .tlas8 import _finalize

__all__ = [
    "Tlas2Pack",
    "pack_tlas2",
    "tlas2_closest_hit",
    "tlas2_occluded",
    "tlas2_closest_plain",
    "tlas2_occluded_plain",
    "tlas2_closest_kernel",
    "tlas2_occluded_kernel",
]


@dataclasses.dataclass(frozen=True)
class Tlas2Pack:
    t_bounds: torch.Tensor  # (Mt, 8) f32
    t_meta: torch.Tensor  # (Mt, 4) i32
    b_bounds: torch.Tensor  # (Mb, 8) f32
    b_meta: torch.Tensor  # (Mb, 4) i32
    inst: torch.Tensor  # (K, 12) f32 world->local rows
    inst_range: torch.Tensor  # (K, 2) i32
    tris: torch.Tensor  # (L*8, 20) f32
    p_verts: torch.Tensor  # (L*8, 3, 3) packed local-space triangles
    p_norms: torch.Tensor  # (L*8, 3, 3)

    @property
    def num_tlas_nodes(self) -> int:
        return self.t_bounds.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.t_bounds.shape[0] + self.b_bounds.shape[0]

    @property
    def nbytes(self) -> int:
        """Bytes of the tables the kernels read."""
        return sum(t.numel() * t.element_size() for t in (self.t_bounds, self.t_meta, self.b_bounds, self.b_meta,
                                                           self.inst, self.inst_range, self.tris))


def pack_tlas2(im: InstancedMeshes, device=None) -> Tlas2Pack:
    """An instanced scene's two trees in the kernels' layout (module
    docstring). Every scene fits: the walk needs no stack."""
    K = im.inst_inv.shape[0]
    t_leaf_inst = im.t_leaf_inst.cpu().numpy()
    t_bounds, t_meta = node_rows(im.t_min.cpu().numpy(), im.t_max.cpu().numpy(), im.t_skip.cpu().numpy(),
                                 t_leaf_inst, np.zeros_like(t_leaf_inst))
    b_start, b_count, p_verts, p_norms = packed_leaves(im)
    b_bounds, b_meta = node_rows(im.b_min.cpu().numpy(), im.b_max.cpu().numpy(), im.b_skip.cpu().numpy(),
                                 b_start, b_count)
    inst_range = np.stack([im.inst_root.cpu().numpy(), im.inst_end.cpu().numpy()], axis=1)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return Tlas2Pack(
        t_bounds=t(t_bounds), t_meta=t(t_meta, torch.int32), b_bounds=t(b_bounds), b_meta=t(b_meta, torch.int32),
        inst=t(im.inst_inv.cpu().numpy().reshape(K, 12)), inst_range=t(inst_range, torch.int32),
        tris=t(_tri_rows(p_verts)), p_verts=t(p_verts), p_norms=t(p_norms),
    )


# ---------------------------------------------------------------------------
# Plain torch versions (CPU tensors, tests, and the reference on the card)
# ---------------------------------------------------------------------------


def _walk_t2_plain(pack: Tlas2Pack, o, d, t_min, t_max, active, stats: Optional[dict]):
    """Lockstep version of csrc/tlas2.cu: each step advances every ray that
    is inside a BLAS by one BLAS node, and every other ray whose TLAS walk
    is not done by one TLAS node (entering an instance at a hit leaf).
    Returns (t_raw, packed triangle id, instance id) for the closest hit
    (t_max None; t_raw = BIG on a miss) or the any-hit bool. `stats`
    accumulates box tests at both levels, triangle tests and instance
    entries."""
    dev = o.device
    N, Mt = o.shape[0], pack.num_tlas_nodes
    t_min = float(np.float32(t_min))
    inv = _safe_inv(d)
    aff = pack.inst.view(-1, 3, 4)
    ranges = pack.inst_range.long()
    zeros = torch.zeros(N, dtype=torch.int64, device=dev)
    tptr = zeros.clone() if active is None else torch.where(active, zeros, torch.full_like(zeros, Mt))
    bptr, bend, cur_inst = zeros.clone(), zeros.clone(), zeros.clone()
    o_loc, d_loc, inv_loc = torch.zeros_like(o), torch.zeros_like(d), torch.zeros_like(d)
    t_best = torch.full((N,), _BIG, dtype=torch.float32, device=dev)
    best, best_inst = zeros.clone(), zeros.clone()
    occ = torch.zeros(N, dtype=torch.bool, device=dev)
    n_box = n_inst = 0

    while True:
        in_blas = bptr < bend
        t_live = torch.nonzero(~in_blas & (tptr < Mt))[:, 0]
        b_live = torch.nonzero(in_blas)[:, 0]
        if t_live.numel() == 0 and b_live.numel() == 0:
            break

        # TLAS step, world ray; a hit leaf enters its instance.
        if t_live.numel():
            p = tptr[t_live]
            upper = t_best[t_live] if t_max is None else t_max[t_live]
            hit = node_hit(pack.t_bounds[p], o[t_live], inv[t_live], t_min, upper)
            m = pack.t_meta[p].long()
            skip, k = m[:, 0], m[:, 1]
            tptr[t_live] = torch.where(hit & (k < 0), p + 1, skip)
            n_box += t_live.numel()
            enter = hit & (k >= 0)
            ray, k = t_live[enter], k[enter]
            if ray.numel():
                o_loc[ray], d_loc[ray], inv_loc[ray] = _to_local(aff[k], o[ray], d[ray])
                bptr[ray], bend[ray], cur_inst[ray] = ranges[k, 0], ranges[k, 1], k
                n_inst += ray.numel()

        # BLAS step, local ray, for the rays that were inside a BLAS.
        if b_live.numel():
            upper = t_best[b_live] if t_max is None else t_max[b_live]
            nxt, leaf, res = skip_step(pack.b_bounds, pack.b_meta, pack.tris, bptr[b_live], o_loc[b_live],
                                       d_loc[b_live], inv_loc[b_live], t_min, upper,
                                       None if t_max is None else t_max[b_live], stats)
            if res is not None:
                ray = b_live[leaf]
                if t_max is not None:
                    done = ray[res]
                    occ[done] = True
                    nxt[leaf[res]] = bend[done]  # early exit: out of the BLAS ...
                    tptr[done] = Mt  # ... and out of the TLAS
                else:
                    t_leaf, tri = res
                    better = t_leaf < t_best[ray]
                    t_best[ray] = torch.where(better, t_leaf, t_best[ray])
                    best[ray] = torch.where(better, tri, best[ray])
                    best_inst[ray] = torch.where(better, cur_inst[ray], best_inst[ray])
            bptr[b_live] = nxt

    if stats is not None:
        stats["box_tests"] = stats.get("box_tests", 0) + n_box
        stats["inst_entries"] = stats.get("inst_entries", 0) + n_inst
    if t_max is not None:
        return occ
    return t_best, best.to(torch.int32), best_inst.to(torch.int32)


def tlas2_closest_plain(pack: Tlas2Pack, o, d, t_min, active=None, stats=None):
    """Plain version of the closest-hit kernel: (t_raw (N,) f32 with BIG on
    a miss, packed triangle id (N,) i32, instance id (N,) i32)."""
    return _walk_t2_plain(pack, o, d, t_min, None, active, stats)


def tlas2_occluded_plain(pack: Tlas2Pack, o, d, t_min, t_max, active=None, stats=None):
    """Plain version of the any-hit kernel: True iff some instanced triangle
    lies in [t_min, t_max] along the ray."""
    return _walk_t2_plain(pack, o, d, t_min, t_max, active, stats)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _tables(pack: Tlas2Pack):
    return (_ptr(pack.t_bounds), _ptr(pack.t_meta), pack.num_tlas_nodes, _ptr(pack.b_bounds), _ptr(pack.b_meta),
            _ptr(pack.inst), _ptr(pack.inst_range), _ptr(pack.tris))


def tlas2_closest_kernel(pack: Tlas2Pack, o, d, t_min, active=None):
    """Launch the closest-hit kernel: (t_raw, triangle id, instance id) as
    the plain version."""
    from ..kernels import load_library

    lib = load_library("tlas2")
    o, d, active, _ = _check_rays(pack, o, d, active)
    n = o.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=o.device)
    id_out = torch.empty(n, dtype=torch.int32, device=o.device)
    inst_out = torch.empty(n, dtype=torch.int32, device=o.device)
    err = lib.rpt_tlas2_closest(
        *_tables(pack), _ptr(o), _ptr(d), _ptr(active), n, float(np.float32(t_min)),
        _ptr(t_out), _ptr(id_out), _ptr(inst_out), ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"tlas2 closest-hit kernel launch failed: CUDA error {err}")
    return t_out, id_out, inst_out


def tlas2_occluded_kernel(pack: Tlas2Pack, o, d, t_min, t_max, active=None):
    """Launch the any-hit kernel: bool (N,) as the plain version."""
    from ..kernels import load_library

    lib = load_library("tlas2")
    o, d, active, t_max = _check_rays(pack, o, d, active, t_max)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    err = lib.rpt_tlas2_occluded(
        *_tables(pack), _ptr(o), _ptr(d), _ptr(active), _ptr(t_max), n, float(np.float32(t_min)),
        _ptr(occ), ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"tlas2 any-hit kernel launch failed: CUDA error {err}")
    return occ


# ---------------------------------------------------------------------------
# Wrappers (what SceneData.intersect / occluded call)
# ---------------------------------------------------------------------------


def tlas2_closest_hit(im: InstancedMeshes, pack: Tlas2Pack, o, d, t_min, active=None) -> Hit:
    """Closest hit over every instance (t = inf on a miss, smooth normal,
    material id). CUDA rays launch the kernel; CPU rays take the plain walk."""
    if _on_cpu(o):
        t_raw, tri, inst = tlas2_closest_plain(pack, o, d, t_min, active)
    else:
        t_raw, tri, inst = tlas2_closest_kernel(pack, o, d, t_min, active)
        tlas2_closest_hit.launches += 1
    hit = _finalize(im, pack, o, d, t_min, t_raw, tri, inst)
    if active is not None:
        hit = Hit(t=torch.where(active, hit.t, torch.full_like(hit.t, INF)), normal=hit.normal, mat_id=hit.mat_id)
    return hit


tlas2_closest_hit.launches = 0


def tlas2_occluded(im: InstancedMeshes, pack: Tlas2Pack, o, d, t_min, t_max, active=None) -> torch.Tensor:
    """Shadow query over every instance, boolean-equal to
    `tlas2_closest_hit(...).t <= t_max` (see `bvh8.finish_occluded`)."""
    t_max = ray_t_max(t_max, o)
    if _on_cpu(o):
        occ = tlas2_occluded_plain(pack, o, d, t_min, t_max, active)
    else:
        occ = tlas2_occluded_kernel(pack, o, d, t_min, t_max, active)
        tlas2_occluded.launches += 1
    return finish_occluded(occ, t_max, active)


tlas2_occluded.launches = 0
