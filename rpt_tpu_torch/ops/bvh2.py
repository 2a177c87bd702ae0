"""Binary-BVH traversal by skip links: closest hit and any hit, as CUDA
kernels.

Replaces the two TPU kernels of `rpt_tpu/ops/bvh_pallas.py`: `_kernel`
(closest hit, reached through `bvh_closest_hit_pallas`) and `_kernel_occl`
(shadow any-hit, reached through `bvh_occluded_pallas`). The kernels are in
`rpt_tpu_torch/csrc/bvh2.cu`; this module holds the host pack, the plain
torch versions with the same contract, and the wrappers that choose between
them by the device of the rays.

The scene compiler takes these kernels for a baked mesh of fewer than
`WIDE_KERNEL_MIN_TRIS` rows, for every mesh under `RPT_BVH_KERNEL=binary`,
and where the wide pack refuses a tree (`scene.choose_bvh_pack`).

Layout. The binary SAH tree (`ops/bvh.py`) as it is built, in preorder with
skip links; the TPU's subtree chunks and (8, 128) tiles exist only for its
SMEM/VMEM budgets and are not carried over. Per node:

- `bounds` (M, 8) f32: lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, 0, 0, two
  16-byte loads;
- `meta` (M, 4) i32: skip, leaf_start, leaf_count, 0, one 16-byte load;
  leaf_count > 0 marks a leaf of that many triangles from row leaf_start;
- `tris` (T, 20) f32: the 20-float triangle rows of the wide kernels
  (`ops/bvh8._tri_rows`), leaf-contiguous and 8-aligned, so a hit's id
  `leaf_start + k` indexes `BvhData.verts` and `finalize_hit` agrees.

Walk. One ray per thread and no stack: at a node whose box the ray hits
within [t_min, upper] (upper = best hit so far, or t_max for the any-hit
query), an internal node goes on to ptr + 1 and a leaf tests its triangles
and goes on to skip; at a missed box, to skip. Ties break the reference's
way: strictly nearer across leaves, so the first hit in preorder wins, and
the lowest row within a leaf. The any-hit walk stops at its first triangle
in [t_min, t_max]. The plain version repeats the kernel's arithmetic op for
op (the slab and triangle tests of `csrc/walk.cuh`); the two agree bit for
bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .bvh import LEAF_SIZE, BvhData, _safe_inv
from .bvh8 import (
    _BIG,
    _check_rays,
    _leaf_t,
    _on_cpu,
    _ptr,
    _tri_rows,
    finish_closest,
    finish_occluded,
    ray_t_max,
)
from .intersect import Hit

__all__ = [
    "Bvh2Pack",
    "pack_bvh2",
    "bvh2_closest_hit",
    "bvh2_occluded",
    "bvh2_closest_plain",
    "bvh2_occluded_plain",
    "bvh2_closest_kernel",
    "bvh2_occluded_kernel",
]

@dataclasses.dataclass(frozen=True)
class Bvh2Pack:
    bounds: torch.Tensor  # (M, 8) f32
    meta: torch.Tensor  # (M, 4) i32
    tris: torch.Tensor  # (T, 20) f32

    @property
    def num_nodes(self) -> int:
        return self.bounds.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.bounds, self.meta, self.tris))


# ---------------------------------------------------------------------------
# Host pack
# ---------------------------------------------------------------------------


def node_rows(node_min, node_max, skip, leaf_start, leaf_count):
    """(bounds (M, 8) f32, meta (M, 4) i32) of a skip-link preorder tree."""
    M = node_min.shape[0]
    bounds = np.zeros((M, 8), np.float32)
    bounds[:, 0:3] = node_min
    bounds[:, 3:6] = node_max
    meta = np.zeros((M, 4), np.int32)
    meta[:, 0] = skip
    meta[:, 1] = leaf_start
    meta[:, 2] = leaf_count
    return bounds, meta


def pack_bvh2(bvh: BvhData, device=None) -> Bvh2Pack:
    """A built binary BVH in the kernels' layout (module docstring). Every
    tree fits: the walk needs no stack."""
    bounds, meta = node_rows(*(t.cpu().numpy() for t in (bvh.node_min, bvh.node_max, bvh.skip,
                                                          bvh.leaf_start, bvh.leaf_count)))
    return Bvh2Pack(
        bounds=torch.as_tensor(bounds, device=device),
        meta=torch.as_tensor(meta, device=device),
        tris=torch.as_tensor(_tri_rows(bvh.verts.cpu().numpy()), device=device),
    )


# ---------------------------------------------------------------------------
# Plain torch versions (CPU tensors, tests, and the reference on the card)
# ---------------------------------------------------------------------------


def node_hit(bounds, o, inv, t_min: float, upper):
    """csrc/walk.cuh `box_hit` on one node per ray: bounds (P, 8), o and
    inv (P, 3), upper (P,). Op for op the kernel's slab test."""
    t1x = (bounds[:, 0] - o[:, 0]) * inv[:, 0]
    t2x = (bounds[:, 3] - o[:, 0]) * inv[:, 0]
    t1y = (bounds[:, 1] - o[:, 1]) * inv[:, 1]
    t2y = (bounds[:, 4] - o[:, 1]) * inv[:, 1]
    t1z = (bounds[:, 2] - o[:, 2]) * inv[:, 2]
    t2z = (bounds[:, 5] - o[:, 2]) * inv[:, 2]
    lo = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z))
    hi = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z))
    return (lo <= hi) & (hi >= t_min) & (lo <= upper)


def skip_step(bounds, meta, tris, ptr, o, d, inv, t_min: float, upper, t_max, stats: Optional[dict]):
    """One step of the skip-link walk for P rays at nodes `ptr` (P,), with
    their rays o, d, inv (P, 3) in the tree's frame and their pruning bound
    `upper` (P,). `t_max` (P,) asks for the any-hit test, None for the
    closest. Returns (the next node (P,), leaf: the rays that tested a leaf,
    and for them (t_leaf, row) of the closest hit, or a bool any-hit)."""
    hit = node_hit(bounds[ptr], o, inv, t_min, upper)
    m = meta[ptr].long()
    skip, start, cnt = m[:, 0], m[:, 1], m[:, 2]
    nxt = torch.where(hit & (cnt == 0), ptr + 1, skip)
    leaf = torch.nonzero(hit & (cnt > 0))[:, 0]
    if stats is not None:
        stats["box_tests"] = stats.get("box_tests", 0) + int(ptr.numel())
        stats["tri_tests"] = stats.get("tri_tests", 0) + int(cnt[leaf].sum())
    if leaf.numel() == 0:
        return nxt, leaf, None
    kk = torch.arange(LEAF_SIZE, device=ptr.device)  # a shorter leaf masks the rest
    t, ok = _leaf_t(tris[start[leaf, None] + kk], o[leaf], d[leaf], t_min)
    ok = ok & (kk < cnt[leaf, None])
    if t_max is not None:
        return nxt, leaf, (ok & (t <= t_max[leaf, None])).any(1)
    th = torch.where(ok, t, torch.full_like(t, _BIG))
    t_leaf = th.min(1).values
    k_best = torch.where(th == t_leaf[:, None], kk, LEAF_SIZE).min(1).values
    return nxt, leaf, (t_leaf, start[leaf] + k_best)


def _walk2_plain(pack: Bvh2Pack, o, d, t_min, t_max, active, stats):
    """Lockstep version of csrc/bvh2.cu: each step advances every ray whose
    walk is not done by one node. Returns (t_raw, tri) for the closest hit
    (t_max None; t_raw = BIG on a miss) or the any-hit bool."""
    dev = o.device
    N, M = o.shape[0], pack.num_nodes
    t_min = float(np.float32(t_min))
    inv = _safe_inv(d)
    ptr = torch.zeros(N, dtype=torch.int64, device=dev)
    if active is not None:
        ptr = torch.where(active, ptr, torch.full_like(ptr, M))
    t_best = torch.full((N,), _BIG, dtype=torch.float32, device=dev)
    best = torch.zeros(N, dtype=torch.int64, device=dev)
    occ = torch.zeros(N, dtype=torch.bool, device=dev)
    while True:
        live = torch.nonzero(ptr < M)[:, 0]
        if live.numel() == 0:
            break
        upper = t_best[live] if t_max is None else t_max[live]
        nxt, leaf, res = skip_step(pack.bounds, pack.meta, pack.tris, ptr[live], o[live], d[live], inv[live],
                                   t_min, upper, None if t_max is None else t_max[live], stats)
        if res is not None:
            ray = live[leaf]
            if t_max is not None:
                occ[ray[res]] = True
                nxt[leaf[res]] = M  # early exit
            else:
                t_leaf, tri = res
                better = t_leaf < t_best[ray]
                t_best[ray] = torch.where(better, t_leaf, t_best[ray])
                best[ray] = torch.where(better, tri, best[ray])
        ptr[live] = nxt
    if t_max is not None:
        return occ
    return t_best, best.to(torch.int32)


def bvh2_closest_plain(pack: Bvh2Pack, o, d, t_min, active=None, stats=None):
    """Plain version of the closest-hit kernel: (t_raw (N,) f32 with BIG on
    a miss, triangle id (N,) i32). `stats`, if given, accumulates the box
    and triangle tests the walk made."""
    return _walk2_plain(pack, o, d, t_min, None, active, stats)


def bvh2_occluded_plain(pack: Bvh2Pack, o, d, t_min, t_max, active=None, stats=None):
    """Plain version of the any-hit kernel: True iff some triangle lies in
    [t_min, t_max] along the ray."""
    return _walk2_plain(pack, o, d, t_min, t_max, active, stats)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def bvh2_closest_kernel(pack: Bvh2Pack, o, d, t_min, active=None):
    """Launch the closest-hit kernel: (t_raw, triangle id) as the plain version."""
    from ..kernels import load_library

    lib = load_library("bvh2")
    o, d, active, _ = _check_rays(pack, o, d, active)
    n = o.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=o.device)
    id_out = torch.empty(n, dtype=torch.int32, device=o.device)
    err = lib.rpt_bvh2_closest(
        _ptr(pack.bounds), _ptr(pack.meta), pack.num_nodes, _ptr(pack.tris), _ptr(o), _ptr(d), _ptr(active),
        n, float(np.float32(t_min)), _ptr(t_out), _ptr(id_out),
        ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"bvh2 closest-hit kernel launch failed: CUDA error {err}")
    return t_out, id_out


def bvh2_occluded_kernel(pack: Bvh2Pack, o, d, t_min, t_max, active=None):
    """Launch the any-hit kernel: bool (N,) as the plain version."""
    from ..kernels import load_library

    lib = load_library("bvh2")
    o, d, active, t_max = _check_rays(pack, o, d, active, t_max)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    err = lib.rpt_bvh2_occluded(
        _ptr(pack.bounds), _ptr(pack.meta), pack.num_nodes, _ptr(pack.tris), _ptr(o), _ptr(d), _ptr(active),
        _ptr(t_max), n, float(np.float32(t_min)), _ptr(occ),
        ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"bvh2 any-hit kernel launch failed: CUDA error {err}")
    return occ


# ---------------------------------------------------------------------------
# Wrappers (what SceneData.intersect / occluded call)
# ---------------------------------------------------------------------------


def bvh2_closest_hit(bvh: BvhData, pack: Bvh2Pack, o, d, t_min, active=None) -> Hit:
    """Closest hit through the binary BVH (t = inf on a miss, smooth normal,
    material id). CUDA rays launch the kernel; CPU rays take the plain walk."""
    if _on_cpu(o):
        t_raw, tri = bvh2_closest_plain(pack, o, d, t_min, active)
    else:
        t_raw, tri = bvh2_closest_kernel(pack, o, d, t_min, active)
        bvh2_closest_hit.launches += 1
    return finish_closest(bvh, o, d, t_min, t_raw, tri, active)


bvh2_closest_hit.launches = 0


def bvh2_occluded(bvh: BvhData, pack: Bvh2Pack, o, d, t_min, t_max, active=None) -> torch.Tensor:
    """Shadow query through the binary BVH, boolean-equal to
    `bvh2_closest_hit(...).t <= t_max` (see `bvh8.finish_occluded`)."""
    t_max = ray_t_max(t_max, o)
    if _on_cpu(o):
        occ = bvh2_occluded_plain(pack, o, d, t_min, t_max, active)
    else:
        occ = bvh2_occluded_kernel(pack, o, d, t_min, t_max, active)
        bvh2_occluded.launches += 1
    return finish_occluded(occ, t_max, active)


bvh2_occluded.launches = 0
