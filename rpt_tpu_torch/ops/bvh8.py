"""8-ary wide-BVH traversal: closest hit and any hit, as CUDA kernels.

Replaces the two TPU kernels of `rpt_tpu/ops/bvh8_pallas.py`:
`_make_kernel8(occl=False)` (closest hit, reached through
`bvh8_closest_hit_pallas`) and `_make_kernel8(occl=True)` (shadow any-hit,
reached through `bvh8_occluded_pallas`). The kernels themselves are in
`rpt_tpu_torch/csrc/bvh8.cu`; this module holds the host pack, the plain
torch versions with the same contract, and the wrappers that choose between
them by the device of the rays. The node layout, the node-group walk and
its plain version are shared with the two-level kernels of `ops/tlas8.py`
(`csrc/group_walk.cuh`).

Layout. The binary SAH tree (`ops/bvh.py`) is collapsed into ONE wide tree
with the reference's smallest-subtree-first frontier expansion
(`_collapse_range`, copied). The TPU chunking, visit-plan prepass and
(8, 128) tiles exist only for the TPU's SMEM/VMEM budgets and are not
carried over: the whole tree sits in device memory. Per wide node:

- `bounds` (Mw, 48) f32: the 8 child boxes as rows lo.x, lo.y, lo.z, hi.x,
  hi.y, hi.z of 8 slots each, so a thread reads a node with 12 16-byte
  loads. Empty slots hold inverted boxes (+BIG min, -BIG max).
- `meta` (Mw, 16) i32: 8 child references, then 8 octant words. A
  reference is `payload << 2 | kind`: kind 0 an empty slot, 1 a wide node
  (payload its index), 3 a leaf (payload `start / 8 << 3 | count - 1`: a
  leaf's triangle rows are 8-aligned and at most 8); kind 2, an instance,
  occurs only in the two-level table. An octant word gives, for direction
  octant (dx<0) | (dy<0)<<1 | (dz<0)<<2, the slots in near-to-far order, 4
  bits per rank. A thread reads the references with two 16-byte loads.
- `tris` (T, 20) f32: the reference's 17 precomputed fields per triangle
  (`_swizzle_tris`: v0, e1, e2, unit plane normal, plane offset, d00, d01,
  d11, 1/denominator, computed in f64), padded to five 16-byte loads.

A float64 pack (of a float64 `BvhData`, for float64 renders) keeps `tris`
in float64 (ten 16-byte loads a row, no rounding) and the node boxes in
float32, each widened one ulp outward (`bvh.widen`) so that it holds the
float64 triangles; its rays, hit distances and `t_min` are float64. Its
boxes are tested in float against a float copy of each ray, widened so
that the test takes every box the double test takes (`_slab_f32`;
csrc/group_walk.cuh and bvh8.cu say why). The wrappers take the kernel of
the pack's type and raise on rays of the other.

Walk: a node-group stack (Ylitie, Karras and Laine, HPG 2017), one ray per
thread (or per lane of the plain version), near to far by its own
direction octant. Visiting a node slab-tests its 8 children against
[t_min, upper] (upper = running best hit, or t_max for the any-hit query,
widened by 8 ulps: `box_upper`),
tests its hit leaves at once, near first, each against the best hit so far,
and makes its hit wide-node children one group: (node, 8-bit mask of them
by rank). The walk enters the group's lowest rank and pushes the group back
as one entry while bits remain, so the stack holds at most one entry per
tree level. The any-hit walk stops at its first triangle in [t_min, t_max].
The visit order is exactly that of a stack with one entry per hit child,
pushed far first (a node's leaves, then its children near to far, each
subtree whole before the next sibling).

Ties. The reference walks the binary tree in preorder and keeps, among
equal t, the first leaf it reaches, and within a leaf the lowest row. The
wide tree's leaves keep the binary tree's rows, which rise in preorder, so
a leaf's best row replaces the best hit on t < best, or on t == best with a
smaller row, whatever order the walk takes (two-level, the key is (TLAS
leaf rank, row), `ops/tlas8.py`).

`group_depth` is the exact worst-case depth of the group stack, which sizes
it in the kernel's shared memory; `stack_need` the reference's bound for a
stack of single children, which decides, as in the reference, whether the
wide pack is taken: above STACK_CAP the pack raises WidePackRefused and the
scene compiler takes the binary kernels (`ops/bvh2.py`). Every group on the
stack stands for at least one child the other stack would hold, so
group_depth <= stack_need.

The plain versions repeat the kernels' arithmetic op for op (the kernels
are built with -fmad=false so nvcc contracts nothing into FMAs), so the two
agree bit for bit, not only within the 2e-5 bar the reference holds its
own kernels to. The slab and triangle tests are shared with every kernel
(`csrc/walk.cuh`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..kernels import counted, launch_counter
from ..utils.vmath import numpy_real, real_value
from .bvh import LEAF_SIZE, BvhData, _safe_inv, finalize_hit, refuse_ray_grad, widen
from .intersect import INF, Hit

__all__ = [
    "Bvh8Pack",
    "WidePackRefused",
    "pack_bvh8",
    "bvh8_closest_hit",
    "bvh8_occluded",
    "bvh8_closest_plain",
    "bvh8_occluded_plain",
    "bvh8_closest_kernel",
    "bvh8_occluded_kernel",
    "bvh8_occupancy",
    "BOX_TEST_OPS",
    "TRI_TEST_OPS",
]

BRANCH = 8
STACK_CAP = 128  # the reference's stack cap (bvh8_pallas.STACK_CAP)
TRI_STRIDE = 20  # floats per triangle row, as in csrc/walk.cuh
_BIG = 3.0e38  # in-kernel miss sentinel
EMPTY = -1  # (a, b) pair b of an empty child slot
_NO_ROW = 2**62  # above every row: the tie key's "none"
INST_CHILD = -2  # b of an instance child (two-level tables, ops/tlas8.py)
KIND_EMPTY, KIND_NODE, KIND_INST, KIND_LEAF = 0, 1, 2, 3  # child reference kinds
_MAX_NODES = 2**24  # a group stack entry is node << 8 | rank mask in 32 bits
_MAX_PAYLOAD = 2**30  # a reference is payload << 2 | kind in 32 bits
_EPS_PAR = float(np.float32(1e-8))

# Floating-point operations per test, counted from the kernel source (the
# bound in chip_smoke.py divides these by the card's f32 rate).
# Box test, per child: 6 sub + 6 mul + 6 min/max per axis pair + 4 to fold
# the three axes into lo and hi + 3 compares.
BOX_TEST_OPS = 25
# Triangle test: cos 5, t 6 + 1 div, hit point 6, minus v0 3, d20 and d21
# 10, v and w 8, u 2, |cos| and 5 compares 7.
TRI_TEST_OPS = 48


class WidePackRefused(ValueError):
    """A wide pack cannot carry this tree: its walk could need a deeper
    stack than the reference's kernels hold, or an id overflows the
    kernels' entries. The scene compiler then takes the binary pack
    (`ops/bvh2.py`, `ops/tlas2.py`), as the reference falls back to its
    binary kernels."""


class WideNodes:
    """The wide-node table of the group-walk packs (`Bvh8Pack`, and
    `ops/tlas8.Tlas8Pack`): `bounds` (Mw, 48) f32 and `meta` (Mw, 16) i32."""

    @property
    def num_nodes(self) -> int:
        return self.bounds.shape[0]

    @property
    def refs(self) -> torch.Tensor:
        """(Mw, 8) i32 child references, by slot."""
        return self.meta[:, 0:8]

    @property
    def words(self) -> torch.Tensor:
        """(Mw, 8) i32 octant words."""
        return self.meta[:, 8:16]

    @property
    def node_bytes(self) -> int:
        """Bytes of one wide node: its boxes and its references and words."""
        return self.bounds.shape[1] * self.bounds.element_size() + self.meta.shape[1] * self.meta.element_size()


@dataclasses.dataclass(frozen=True)
class Bvh8Pack(WideNodes):
    bounds: torch.Tensor  # (Mw, 48) f32
    meta: torch.Tensor  # (Mw, 16) i32: child references, octant words
    tris: torch.Tensor  # (T, TRI_STRIDE) f32, or f64 in a float64 pack
    group_depth: int  # worst-case depth of the walk's node-group stack
    stack_need: int  # the reference's worst-case stack of single children

    @property
    def nbytes(self) -> int:
        """Bytes of the tables the kernels read."""
        return sum(t.numel() * t.element_size() for t in (self.bounds, self.meta, self.tris))


# ---------------------------------------------------------------------------
# Host pack
# ---------------------------------------------------------------------------


def _collapse_range(skip, is_leaf, leaf_start, leaf_count, s, e):
    """Collapse the binary preorder subtree [s, e) into a wide tree in DFS
    order (copied from rpt_tpu/ops/bvh8_pallas.py). Returns (bounds_idx
    (Mw,8) binary ids or -1, child_a (Mw,8), child_b (Mw,8))."""

    def children2(i):
        l = i + 1
        return l, int(skip[l])

    def expand(b):
        # Frontier of <= BRANCH binary descendants, smallest subtree first,
        # so near-leaf structure dissolves into the parent's frontier.
        if is_leaf[b]:
            return [b]
        frontier = [b]
        while len(frontier) < BRANCH:
            cand = [j for j in frontier if not is_leaf[j]]
            if not cand:
                break
            j = min(cand, key=lambda n: int(skip[n]) - n)
            frontier.remove(j)
            l, r = children2(j)
            frontier.extend([l, r])
        return frontier

    frontiers = []
    windex = {}
    stack = [s]
    while stack:
        b = stack.pop()
        windex[b] = len(frontiers)
        fr = expand(b)
        frontiers.append(fr)
        for f in reversed(fr):
            if not is_leaf[f]:
                stack.append(f)

    Mw = len(frontiers)
    bidx = np.full((Mw, BRANCH), -1, np.int64)
    ca = np.zeros((Mw, BRANCH), np.int32)
    cb = np.full((Mw, BRANCH), -1, np.int32)
    for wid, fr in enumerate(frontiers):
        for c, f in enumerate(fr):
            bidx[wid, c] = f
            if is_leaf[f]:
                ca[wid, c] = leaf_start[f]
                cb[wid, c] = leaf_count[f]
            else:
                ca[wid, c] = windex[f]
                cb[wid, c] = 0
    return bidx, ca, cb


def _stack_need(ca: np.ndarray, cb: np.ndarray) -> int:
    """Exact worst-case stack depth of the wide walk over all child orders
    (copied from rpt_tpu/ops/bvh8_pallas.py): after popping w its n_int
    internal children sit on the stack, and a child explored while its
    siblings are still stacked needs need(child) on top of n_int - 1."""
    Mw = ca.shape[0]
    need = np.zeros(Mw + 1, np.int64)
    for w in range(Mw - 1, -1, -1):
        internal = cb[w] == 0
        n_int = int(internal.sum())
        if n_int == 0:
            continue
        child_peak = int(need[ca[w][internal]].max())
        need[w] = max(n_int, n_int - 1 + child_peak)
    return int(max(1, need[0]))


def _group_depth(meta: np.ndarray, inst_blas_root: Optional[np.ndarray] = None) -> int:
    """Exact worst-case depth of the node-group stack of the table `meta`
    (Mw, 16) over every octant and every subset of hit children. Entering
    child C of a node leaves the node's group on the stack iff a group
    child of a later rank could be hit, i.e. C is not the last group child
    in the octant's order; so need(node) = max over its group children C of
    [C not last] + need(C), 0 for a node without any (an instance child's
    need is its BLAS root's, `inst_blas_root` (K,) in a two-level table).
    Iterated to its fixed point, one level per pass."""
    ref, words = meta[:, 0:8].astype(np.int64), meta[:, 8:16].astype(np.int64)
    kind = ref & 3
    grp = (kind == KIND_NODE) | (kind == KIND_INST)
    payload = ref >> 2
    target = np.where(kind == KIND_NODE, payload, 0)
    if inst_blas_root is not None:
        target = np.where(kind == KIND_INST, inst_blas_root[np.where(kind == KIND_INST, payload, 0)], target)
    slots = (words[:, :, None] >> (4 * np.arange(BRANCH))) & 7  # (Mw, oct, rank) -> slot
    rank = np.argsort(slots, axis=-1)  # (Mw, oct, slot) -> rank
    last = np.where(grp[:, None, :], rank, -1).max(-1, keepdims=True)
    stays = grp[:, None, :] & (rank != last)  # (Mw, oct, slot)
    need = np.zeros((ref.shape[0], 8), np.int64)  # (Mw, oct)
    while True:
        child = need[target].transpose(0, 2, 1)  # (Mw, oct, slot)
        new = np.where(grp[:, None, :], stays + child, 0).max(-1)
        if np.array_equal(new, need):
            return int(need[0].max())
        need = new


def _encode_refs(ca: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """Child references `payload << 2 | kind` (module docstring) from the
    (a, b) pairs: b == 0 a wide node a, b == -2 an instance a, b > 0 a leaf
    of b rows at row a, b == -1 an empty slot."""
    leaf = cb > 0
    if (ca[leaf] % LEAF_SIZE).any() or (cb[leaf] > LEAF_SIZE).any():
        raise ValueError("leaves must start 8-aligned and hold at most 8 triangles")
    ca, cb = ca.astype(np.int64), cb.astype(np.int64)
    payload = np.where(leaf, (ca // LEAF_SIZE) << 3 | (cb - 1), ca)
    kind = np.select([cb == 0, cb == INST_CHILD, leaf], [KIND_NODE, KIND_INST, KIND_LEAF], KIND_EMPTY)
    return np.where(kind == KIND_EMPTY, 0, payload << 2 | kind)


def _decode_refs(ref) -> tuple:
    """The (a, b) pairs of `_encode_refs`' input back from references
    (numpy or torch): a = node, instance or first row, b = 0, -2, the
    leaf's row count, or -1 for an empty slot."""
    kind, payload = ref & 3, ref >> 2
    leaf = kind == KIND_LEAF
    a = (payload >> 3) * LEAF_SIZE * leaf + payload * (kind == KIND_NODE) + payload * (kind == KIND_INST)
    b = ((payload & 7) + 1) * leaf + INST_CHILD * (kind == KIND_INST) + EMPTY * (kind == KIND_EMPTY)
    return a, b


def _refuse_overflow(n_nodes: int, n_rows: int, n_inst: int = 0):
    """Raise WidePackRefused if a node id, an instance id or a leaf's row
    overflows the kernels' 32-bit references and group stack entries."""
    if n_nodes >= _MAX_NODES or n_inst >= _MAX_PAYLOAD or n_rows // LEAF_SIZE >= _MAX_PAYLOAD >> 3:
        raise WidePackRefused(f"{n_nodes} wide nodes, {n_inst} instances or {n_rows} rows overflow the kernels' "
                              "32-bit references and stack entries")


def _tri_rows(verts: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(T, 3, 3) leaf-contiguous triangles -> (T, TRI_STRIDE) rows of the
    reference's precomputed fields (rpt_tpu/ops/bvh_pallas.py `_swizzle_tris`),
    computed in f64 and stored in `dtype`."""
    v = np.asarray(verts, np.float64)
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    pn = np.cross(e1, e2)
    nrm = np.linalg.norm(pn, axis=-1, keepdims=True)
    pn = pn / np.where(nrm > 1e-30, nrm, 1.0)
    d00 = np.einsum("ij,ij->i", e1, e1)
    d01 = np.einsum("ij,ij->i", e1, e2)
    d11 = np.einsum("ij,ij->i", e2, e2)
    denom = d00 * d11 - d01 * d01
    inv_denom = 1.0 / np.where(np.abs(denom) > 1e-20, denom, 1e-20)
    pv = np.einsum("ij,ij->i", pn, v0)
    rows = np.zeros((v.shape[0], TRI_STRIDE), dtype)
    rows[:, 0:3] = v0
    rows[:, 3:6] = e1
    rows[:, 6:9] = e2
    rows[:, 9:12] = pn
    rows[:, 12] = pv
    rows[:, 13] = d00
    rows[:, 14] = d01
    rows[:, 15] = d11
    rows[:, 16] = inv_denom
    return rows


def _collapse(bvh: BvhData):
    """The wide tree of `bvh`: per-slot child boxes lo, hi (Mw, 8, 3) f32
    (widened outward for a float64 BVH), the filled-slot mask and the (a, b)
    pairs (Mw, 8) of `_collapse_range`."""
    skip = bvh.skip.cpu().numpy().astype(np.int64)
    is_leaf = bvh.is_leaf.cpu().numpy().astype(bool)
    leaf_start = bvh.leaf_start.cpu().numpy().astype(np.int64)
    leaf_count = bvh.leaf_count.cpu().numpy().astype(np.int64)
    # The tie key: a smaller row must mean an earlier leaf in preorder.
    assert (np.diff(leaf_start[is_leaf]) > 0).all(), "leaf rows must rise in preorder"
    bidx, ca, cb = _collapse_range(skip, is_leaf, leaf_start, leaf_count, 0, bvh.num_nodes)
    valid = bidx >= 0
    bi = np.where(valid, bidx, 0)
    lo, hi = bvh.node_min.cpu().numpy(), bvh.node_max.cpu().numpy()
    if bvh.verts.dtype == torch.float64:
        lo, hi = widen(lo, hi)
    return lo[bi], hi[bi], valid, ca, cb


def pack_bvh8(bvh: BvhData, device=None) -> Bvh8Pack:
    """Collapse a built binary BVH into the kernels' wide layout (see the
    module docstring). Raises WidePackRefused if the reference's walk could
    need a deeper stack than STACK_CAP, or an id overflows the kernels'
    32-bit references and stack entries."""
    lo, hi, valid, ca, cb = _collapse(bvh)
    need = _stack_need(ca, cb)
    if need > STACK_CAP:
        raise WidePackRefused(f"the wide BVH needs a stack of {need} > {STACK_CAP} entries")
    _refuse_overflow(ca.shape[0], bvh.num_tris)
    bounds, meta = _emit_group(lo, hi, valid, ca, cb)
    return Bvh8Pack(
        bounds=torch.as_tensor(bounds, device=device),
        meta=torch.as_tensor(meta, device=device),
        tris=torch.as_tensor(_tri_rows(bvh.verts.cpu().numpy(), numpy_real(bvh.verts.dtype)), device=device),
        group_depth=_group_depth(meta),
        stack_need=need,
    )


def _emit_group(lo: np.ndarray, hi: np.ndarray, valid: np.ndarray, ca: np.ndarray, cb: np.ndarray):
    """Wide nodes in the group walk's layout (module docstring) from
    per-slot child boxes lo, hi (Mw, 8, 3) f32, a mask of the filled slots
    and the (a, b) pairs (Mw, 8) each: (bounds (Mw, 48) f32, meta (Mw, 16)
    i32). Empty slots get inverted boxes and reference 0."""
    Mw = lo.shape[0]
    lo_b = np.where(valid[..., None], lo, _BIG).astype(np.float32)
    hi_b = np.where(valid[..., None], hi, -_BIG).astype(np.float32)
    bounds = np.concatenate([lo_b.transpose(0, 2, 1), hi_b.transpose(0, 2, 1)], axis=1)  # (Mw, 6, 8)

    # Near-to-far child order per direction octant: ascending centroid
    # projection onto the octant's sign vector, empty slots last.
    signs = np.array([[-1.0 if (o >> a) & 1 else 1.0 for a in range(3)] for o in range(8)])
    cent = 0.5 * (lo + hi)
    keys = np.einsum("mcx,ox->moc", cent, signs)
    keys = np.where(valid[:, None, :], keys, np.inf)
    order = np.argsort(keys, axis=-1, kind="stable")
    words = (order << (4 * np.arange(BRANCH))[None, None, :]).sum(-1)

    meta = np.concatenate([_encode_refs(ca, np.where(valid, cb, EMPTY)), words], axis=1).astype(np.int32)
    return np.ascontiguousarray(bounds.reshape(Mw, 48)), np.ascontiguousarray(meta)


# ---------------------------------------------------------------------------
# Plain torch versions (CPU tensors, tests, and the reference on the card)
# ---------------------------------------------------------------------------


def _leaf_t(rows, o, d, t_min):
    """Triangle test of csrc/walk.cuh `tri_t`, op for op. rows (P, K, 20);
    o, d (P, 3). Returns (t, ok), each (P, K)."""
    eps = _EPS_PAR if rows.dtype == torch.float32 else 1e-8
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    f = [rows[..., i] for i in range(17)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, pnx, pny, pnz, pv, d00, d01, d11, inv_den = f
    cos = (pnx * dx + pny * dy) + pnz * dz
    cos_safe = torch.where(torch.abs(cos) > eps, cos, torch.full_like(cos, eps))
    t = (pv - ((pnx * ox + pny * oy) + pnz * oz)) / cos_safe
    ddx = (ox + t * dx) - v0x
    ddy = (oy + t * dy) - v0y
    ddz = (oz + t * dz) - v0z
    d20 = (ddx * e1x + ddy * e1y) + ddz * e1z
    d21 = (ddx * e2x + ddy * e2y) + ddz * e2z
    v = (d11 * d20 - d01 * d21) * inv_den
    w = (d00 * d21 - d01 * d20) * inv_den
    u = (1.0 - v) - w
    ok = (torch.abs(cos) >= eps) & (t >= t_min) & (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    return t, ok


def _to_local(A, o, d):
    """World rays o, d (P, 3) in the frames of the world->local rows A
    (P, 3, 4), as csrc/walk.cuh `to_local` computes them: the direction
    unnormalized. Returns (o_local, d_local, inverse of d_local)."""
    ol = ((A[:, :, 0] * o[:, 0:1] + A[:, :, 1] * o[:, 1:2]) + A[:, :, 2] * o[:, 2:3]) + A[:, :, 3]
    dl = (A[:, :, 0] * d[:, 0:1] + A[:, :, 1] * d[:, 1:2]) + A[:, :, 2] * d[:, 2:3]
    return ol, dl, _safe_inv(dl)


def _slab(b, ol, il):
    """The slabs of csrc/walk.cuh `box_entry` for the C children of each
    row's node: b (L, 6, C) boxes (rows lo.x, lo.y, lo.z, hi.x, hi.y, hi.z),
    ol, il (L, 3) ray origin and inverse direction. Returns (lo, hi), each
    (L, C): the ray's entry and exit distances."""
    t1x = (b[:, 0] - ol[:, 0:1]) * il[:, 0:1]
    t2x = (b[:, 3] - ol[:, 0:1]) * il[:, 0:1]
    t1y = (b[:, 1] - ol[:, 1:2]) * il[:, 1:2]
    t2y = (b[:, 4] - ol[:, 1:2]) * il[:, 1:2]
    t1z = (b[:, 2] - ol[:, 2:3]) * il[:, 2:3]
    t2z = (b[:, 5] - ol[:, 2:3]) * il[:, 2:3]
    lo = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z))
    hi = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z))
    return lo, hi


# csrc/walk.cuh `Num::up`: the widening of a box test's upper end, 8 ulps.
_UP = {torch.float32: 2.0**-21, torch.float64: 2.0**-50}


def box_upper(upper):
    """csrc/walk.cuh `box_upper`: a box test's upper end (the running best
    or t_max), widened by 8 ulps of itself, so that a box whose entry rounds
    an ulp or two past a triangle's t at `upper` is still taken."""
    return upper + upper.abs() * _UP[upper.dtype]


def _slab_hit(b, ol, il, t_min, upper):
    """Slab test of csrc/walk.cuh `box_hit` for the children of each row's
    node (`_slab`'s arguments) against [t_min, upper], upper (L, 1) already
    widened (`box_upper`). Returns (L, C) bool by slot."""
    lo, hi = _slab(b, ol, il)
    return (lo <= hi) & (hi >= t_min) & (lo <= upper)


# csrc/walk.cuh box_entry_f: the smallest normal float, added to each
# axis's slack, and the relative widening of a slab end (8u, u = 2^-24).
_FLT_MIN = float(torch.finfo(torch.float32).tiny)
_WIDEN = 2.0**-21


def _float_ray(o, d):
    """csrc/walk.cuh `float_ray` of double rays o, d (L, 3): (L, 9) float32,
    the origin rounded to nearest, the float inverse of the direction
    rounded to float (the zero guard signed by d), then each axis's slack
    2 |of - o| |fi| + FLT_MIN."""
    of, x = o.float(), d.float()
    tiny = torch.full_like(x, 1e-20)
    fi = 1.0 / torch.where(x.abs() > tiny, x, torch.where(d < 0, -tiny, tiny))
    slack = ((of.double() - o).abs() * fi.double().abs() * 2.0).float() + _FLT_MIN
    return torch.cat([of, fi, slack], 1)


def _slab_f32(b, fr):
    """The widened float slabs of csrc/walk.cuh `box_entry_f` for the C
    children of each row's node: b (L, 6, C) float boxes, fr (L, 9) the rays'
    `_float_ray`. Returns (lo, hi) (L, C) float32."""
    lo = hi = None
    for a in range(3):
        o_a, i_a, s_a = fr[:, a:a + 1], fr[:, 3 + a:4 + a], fr[:, 6 + a:7 + a]
        t1 = (b[:, a] - o_a) * i_a
        t2 = (b[:, 3 + a] - o_a) * i_a
        mn, mx = torch.minimum(t1, t2), torch.maximum(t1, t2)
        mn = mn - (mn.abs() * _WIDEN + s_a)
        mx = mx + (mx.abs() * _WIDEN + s_a)
        lo = mn if lo is None else torch.maximum(lo, mn)
        hi = mx if hi is None else torch.minimum(hi, mx)
    return lo, hi


def _to_f32(x, up: bool):
    """Doubles rounded to float toward +inf (`up`) or -inf, as CUDA's
    __double2float_ru / _rd."""
    f = x.float()
    off = f.double() < x if up else f.double() > x
    return torch.where(off, torch.nextafter(f, torch.full_like(f, math.inf if up else -math.inf)), f)


def _best_of_leaves(t, ok, start, li, lk, L):
    """The closest hit of one visit's leaves, each tested against the best
    so far: t, ok (P, 8) of the P hit leaves (row li, rank lk) with first
    rows `start`. Returns (m, id) (L,): the node's minimum m (BIG if none)
    and, of the rows that hold it, the smallest (the tie key: rows rise in
    the binary tree's preorder, so the reference's first leaf; within a
    leaf the lowest row, as `leaf_closest`)."""
    dev = t.device
    rows = start[:, None] + torch.arange(t.shape[1], device=dev)
    th = torch.where(ok, t, torch.full_like(t, _BIG))
    t_leaf = th.min(1).values
    row = torch.where(th == t_leaf[:, None], rows, _NO_ROW).min(1).values
    tl = torch.full((L, BRANCH), _BIG, dtype=t.dtype, device=dev)
    tl[li, lk] = t_leaf
    ids = torch.full((L, BRANCH), _NO_ROW, dtype=torch.int64, device=dev)
    ids[li, lk] = row
    m = tl.min(1).values
    return m, torch.where(tl == m[:, None], ids, _NO_ROW).min(1).values


# Index of the lowest set bit of each byte (0 has none: 8).
_LOWEST_BIT = torch.tensor([8] + [(v & -v).bit_length() - 1 for v in range(1, 256)])


def _group_walk(pack: WideNodes, o, d, t_min, t_max, active, occl: bool, stats: Optional[dict]):
    """Lockstep version of csrc/group_walk.cuh over the table of `pack`
    (its bounds, refs, words, tris and group_depth): each step visits one
    node for every ray still walking, then moves it to its next node
    (module docstring). One wide tree, or, where the pack carries instance
    records `inst_rows` (K, 16) by TLAS leaf rank, a two-level table whose
    nodes below `n_tlas` are the TLAS (ops/tlas8.py). Box tests take
    [t_min, upper] with upper widened (`box_upper`); a float64 walk tests
    its boxes in float (`_slab_f32`), as its kernels do. A
    leaf's best row replaces the best hit on a smaller t, or on an equal t
    with a smaller key: (TLAS leaf rank, row) two-level, the row one-level.
    Returns (t_raw, tri, instance id) for the closest hit (t_raw = BIG on a
    miss) or the any-hit bool. `stats` accumulates box tests (filled slots
    of each visited node), triangle tests, instance entries (two-level) and
    the deepest group stack reached (`max_group_depth`)."""
    dev = o.device
    N = o.shape[0]
    t_min = real_value(t_min, o.dtype)
    inv = _safe_inv(d)
    octant = (d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long() + 4 * (d[:, 2] < 0).long()
    boxes = pack.bounds.view(-1, 6, BRANCH)
    refs = pack.refs.long()
    words = pack.words.long()
    kinds = refs & 3
    two_level = getattr(pack, "inst_rows", None) is not None
    float_box = o.dtype == torch.float64
    if float_box:
        t_min_f = _to_f32(torch.tensor(t_min, dtype=torch.float64), up=False).item()
        fr = _float_ray(o, d)
    if two_level:
        aff = pack.inst_rows[:, :12].reshape(-1, 3, 4)
        r = pack.inst_rows.element_size() // 4  # int32 words per real: the ints sit at real 12
        rank_root, rank_inst = pack.inst_rows.view(torch.int32)[:, 12 * r:12 * r + 2].long().unbind(1)
        n_tlas = pack.n_tlas
        o_loc, d_loc, inv_loc = torch.zeros_like(o), torch.zeros_like(d), torch.zeros_like(d)
        if float_box:
            fr_loc = torch.zeros((N, 9), dtype=torch.float32, device=dev)
    lowest = _LOWEST_BIT.to(dev)
    shifts = 4 * torch.arange(BRANCH, device=dev)
    kk = torch.arange(BRANCH, device=dev)

    t_best = torch.full((N,), _BIG, dtype=o.dtype, device=dev)
    best = torch.zeros(N, dtype=torch.int64, device=dev)
    best_rank = torch.full((N,), -1, dtype=torch.int64, device=dev)
    rank = torch.zeros(N, dtype=torch.int64, device=dev)  # the current instance's TLAS leaf rank
    occ = torch.zeros(N, dtype=torch.bool, device=dev)
    node = torch.zeros(N, dtype=torch.int64, device=dev)  # the next node to visit; the root first
    stack = torch.zeros((N, max(pack.group_depth, 1)), dtype=torch.int64, device=dev)
    sp = torch.zeros(N, dtype=torch.int64, device=dev)
    walking = torch.ones(N, dtype=torch.bool, device=dev) if active is None else active.clone()
    n_box = torch.zeros((), dtype=torch.int64, device=dev)
    n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    n_inst = torch.zeros((), dtype=torch.int64, device=dev)
    max_sp = torch.zeros((), dtype=torch.int64, device=dev)

    while True:
        live = torch.nonzero(walking)[:, 0]
        if live.numel() == 0:
            break
        L = live.numel()
        w = node[live]
        if two_level:
            local = (w >= n_tlas)[:, None]
            ol = torch.where(local, o_loc[live], o[live])
            dl = torch.where(local, d_loc[live], d[live])
            il = torch.where(local, inv_loc[live], inv[live])
        else:
            ol, dl, il = o[live], d[live], inv[live]

        # Visit: slab-test the 8 children against the best hit so far.
        upper = (t_max[live] if occl else t_best[live])[:, None]
        kind = kinds[w]
        if float_box:
            lo, hi = _slab_f32(boxes[w], torch.where(local, fr_loc[live], fr[live]) if two_level else fr[live])
            hit = (lo <= hi) & (hi >= t_min_f) & (lo <= _to_f32(upper, up=True))
        else:
            hit = _slab_hit(boxes[w], ol, il, t_min, box_upper(upper))
        hit = hit & (kind != KIND_EMPTY)  # (L, 8) by slot
        if stats is not None:
            n_box += (kind != KIND_EMPTY).sum()
        word = words[w, octant[live]]
        ck = (word[:, None] >> shifts) & 7  # (L, 8) slot by rank
        hit_r = torch.gather(hit, 1, ck)
        kind_r = torch.gather(kind, 1, ck)
        ref_r = torch.gather(refs[w], 1, ck)

        # Hit leaves, near first, each against the best hit so far.
        li, lk = torch.nonzero(hit_r & (kind_r == KIND_LEAF), as_tuple=True)
        if li.numel():
            payload = ref_r[li, lk] >> 2
            start = (payload >> 3) * LEAF_SIZE
            count = (payload & 7) + 1
            rows = pack.tris[start[:, None] + kk]  # (P, 8, 20)
            ray = live[li]
            t, ok = _leaf_t(rows, ol[li], dl[li], t_min)
            ok = ok & (kk < count[:, None])
            if stats is not None:
                n_tri += count.sum()
            if occl:
                stop = ray[(ok & (t <= t_max[ray][:, None])).any(1)]
                occ[stop] = True
                walking[stop] = False  # early exit
            else:
                m, row = _best_of_leaves(t, ok, start, li, lk, L)
                tb, br, bb, rk = t_best[live], best_rank[live], best[live], rank[live]
                better = (m < tb) | ((m == tb) & (tb < _BIG) & ((rk < br) | ((rk == br) & (row < bb))))
                t_best[live] = torch.where(better, m, tb)
                best[live] = torch.where(better, row, bb)
                best_rank[live] = torch.where(better, rk, br)

        # The node's group: its hit wide-node and instance children by rank.
        grp = hit_r & ((kind_r == KIND_NODE) | (kind_r == KIND_INST))
        g_node, g_mask, g_word = w, (grp.long() << kk).sum(1), word
        keep = walking[live]
        live, g_node, g_mask, g_word = live[keep], g_node[keep], g_mask[keep], g_word[keep]

        # Move on: an empty group pops the stack, an empty stack ends the walk.
        pop = (g_mask == 0) & (sp[live] > 0)
        if bool(pop.any()):
            r = live[pop]
            sp[r] -= 1
            e = stack[r, sp[r]]
            g_node[pop], g_mask[pop] = e >> 8, e & 255
            g_word[pop] = words[e >> 8, octant[r]]
        done = g_mask == 0
        walking[live[done]] = False
        go = ~done
        live, g_node, g_mask, g_word = live[go], g_node[go], g_mask[go], g_word[go]
        if live.numel() == 0:
            continue
        k = lowest[g_mask]
        rest = g_mask & (g_mask - 1)
        back = rest != 0
        if bool(back.any()):
            r = live[back]
            stack[r, sp[r]] = (g_node[back] << 8) | rest[back]
            sp[r] += 1
            max_sp = torch.maximum(max_sp, sp[r].max())
        ref = refs[g_node, (g_word >> (4 * k)) & 7]
        payload = ref >> 2
        node[live] = payload
        if two_level:
            enter = (ref & 3) == KIND_INST
            if bool(enter.any()):
                # Instance children (payload the TLAS leaf rank): the world
                # ray in the instance's frame, direction unnormalized; then
                # its BLAS root.
                r, k_rank = live[enter], payload[enter]
                o_loc[r], d_loc[r], inv_loc[r] = _to_local(aff[k_rank], o[r], d[r])
                if float_box:
                    fr_loc[r] = _float_ray(o_loc[r], d_loc[r])
                rank[r] = k_rank
                node[r] = rank_root[k_rank]
                n_inst += r.numel()

    if stats is not None:
        stats["box_tests"] = stats.get("box_tests", 0) + int(n_box)
        stats["tri_tests"] = stats.get("tri_tests", 0) + int(n_tri)
        if two_level:
            stats["inst_entries"] = stats.get("inst_entries", 0) + int(n_inst)
        stats["max_group_depth"] = max(stats.get("max_group_depth", 0), int(max_sp))
    if occl:
        return occ
    if not two_level:
        return t_best, best.to(torch.int32), torch.zeros_like(best, dtype=torch.int32)
    best_inst = torch.where(best_rank >= 0, rank_inst[best_rank.clamp(min=0)], torch.zeros_like(best_rank))
    return t_best, best.to(torch.int32), best_inst.to(torch.int32)


def bvh8_closest_plain(pack: Bvh8Pack, o, d, t_min, active=None, stats=None):
    """Plain version of the closest-hit kernel: (t_raw (N,) in the rays'
    type with BIG on a miss, triangle id (N,) i32). `stats`, if given, accumulates the
    counts of `_group_walk`."""
    t_raw, tri, _ = _group_walk(pack, o, d, t_min, None, active, False, stats)
    return t_raw, tri


def bvh8_occluded_plain(pack: Bvh8Pack, o, d, t_min, t_max, active=None, stats=None):
    """Plain version of the any-hit kernel: True iff some triangle lies in
    [t_min, t_max] along the ray."""
    return _group_walk(pack, o, d, t_min, t_max, active, True, stats)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def check_dtype(pack, o, d) -> None:
    """Raise unless the rays are of the pack's real type (the type of its
    triangle rows `tris`): float32 rays walk a float32 pack, float64 rays a
    float64 one, and neither is cast into the other."""
    if o.dtype != pack.tris.dtype or d.dtype != pack.tris.dtype:
        raise TypeError(f"{o.dtype} / {d.dtype} rays on a {pack.tris.dtype} pack: a BVH walk takes rays "
                        "of its pack's type")


def _check_rays(pack, o, d, active, t_max=None):
    """Refuse what the kernels do not take; returns (o, d, active, t_max)
    contiguous. Every pack of the BVH kernels has its triangle rows in
    `tris`, whose type (float32 or float64) is the walk's."""
    if not (o.is_cuda and d.is_cuda and pack.tris.is_cuda):
        raise ValueError("the BVH kernels need the rays and the pack on a CUDA device")
    check_dtype(pack, o, d)
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"the BVH kernels take (N, 3) rays, got {tuple(o.shape)}, {tuple(d.shape)}")
    if active is not None and (active.dtype != torch.bool or active.shape != o.shape[:1]):
        raise ValueError("active must be a bool (N,) mask")
    if t_max is not None:
        if t_max.shape != o.shape[:1] or t_max.device != o.device:
            raise ValueError("t_max must be an (N,) tensor on the rays' device")
        t_max = t_max.to(o.dtype).contiguous()
    if o.shape[0] >= 2**31:
        raise ValueError("too many rays for one launch")
    return o.contiguous(), d.contiguous(), None if active is None else active.contiguous(), t_max


def bvh8_closest_kernel(pack: Bvh8Pack, o, d, t_min, active=None, launches=None):
    """Launch the closest-hit kernel: (t_raw, triangle id) as the plain
    version. Raises if the group stack does not fit one block's shared
    memory.
    `launches`: a launch count's address (`kernels.launch_counter`), or
    None for a launch not counted."""
    from ..kernels import load_library

    lib = load_library("bvh8")
    o, d, active, _ = _check_rays(pack, o, d, active)
    n = o.shape[0]
    t_out = torch.empty(n, dtype=o.dtype, device=o.device)
    id_out = torch.empty(n, dtype=torch.int32, device=o.device)
    entry = lib.rpt_bvh8_closest if o.dtype == torch.float32 else lib.rpt_bvh8_closest_f64
    err = entry(
        _ptr(pack.bounds), _ptr(pack.meta), pack.group_depth, _ptr(pack.tris), _ptr(o), _ptr(d), _ptr(active),
        n, real_value(t_min, o.dtype), _ptr(t_out), _ptr(id_out),
        launches, ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"bvh8 closest-hit kernel launch failed: CUDA error {err}")
    return t_out, id_out


def bvh8_occluded_kernel(pack: Bvh8Pack, o, d, t_min, t_max, active=None, launches=None):
    """Launch the any-hit kernel: bool (N,) as the plain version.
    `launches`: a launch count's address (`kernels.launch_counter`), or
    None for a launch not counted."""
    from ..kernels import load_library

    lib = load_library("bvh8")
    o, d, active, t_max = _check_rays(pack, o, d, active, t_max)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    entry = lib.rpt_bvh8_occluded if o.dtype == torch.float32 else lib.rpt_bvh8_occluded_f64
    err = entry(
        _ptr(pack.bounds), _ptr(pack.meta), pack.group_depth, _ptr(pack.tris), _ptr(o), _ptr(d), _ptr(active),
        _ptr(t_max), n, real_value(t_min, o.dtype), _ptr(occ),
        launches, ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"bvh8 any-hit kernel launch failed: CUDA error {err}")
    return occ


def read_occupancy(query, *args) -> dict:
    """Call a kernel library's occupancy query (`rpt_<library>_occupancy`)
    with `args` and its int32 output on the current card: registers and
    local (spill) bytes a thread, blocks and warps resident per SM."""
    out = torch.zeros(4, dtype=torch.int32)
    err = query(*args, _ptr(out))
    if err != 0:
        raise RuntimeError(f"{query.__name__} failed: CUDA error {err}")
    regs, local, blocks, warps = out.tolist()
    return dict(registers=regs, local_bytes=local, blocks_per_sm=blocks, warps_per_sm=warps)


def group_walk_occupancy(query, group_depth: int, occluded: bool, dtype) -> dict:
    """How the kernel of a query (`occluded`) and real type (`dtype`) of a
    group-walk library, whose occupancy query is `query`, fills the current
    card at the launch the wrappers make for a pack of `group_depth`
    (128-ray blocks, the group stack in dynamic shared memory):
    `read_occupancy`'s counts and the shared stack the blocks hold per SM."""
    smem = 128 * group_depth * 4
    occ = read_occupancy(query, int(occluded) | (2 if dtype == torch.float64 else 0), group_depth)
    return dict(block=128, smem_bytes=smem, **occ, smem_per_sm=occ["blocks_per_sm"] * smem)


def bvh8_occupancy(group_depth: int, occluded: bool, dtype) -> dict:
    """`group_walk_occupancy` of the bvh8 kernels."""
    from ..kernels import load_library

    return group_walk_occupancy(load_library("bvh8").rpt_bvh8_occupancy, group_depth, occluded, dtype)


def _on_cpu(o: torch.Tensor) -> bool:
    if o.device.type == "cpu":
        return True
    if o.is_cuda:
        return False
    raise ValueError(f"BVH walk: unsupported device {o.device}")


# ---------------------------------------------------------------------------
# Wrappers (what SceneData.intersect / occluded call)
# ---------------------------------------------------------------------------


def finish_closest(bvh: BvhData, o, d, t_min, t_raw, tri, active) -> Hit:
    """The Hit of a one-level walk's (t_raw, triangle id): t = inf on a miss
    and on an inactive lane, the id clamped into the triangle table, then
    `finalize_hit` for the smooth normal and the material."""
    t_best = torch.where(t_raw >= 1.0e38, torch.full_like(t_raw, INF), t_raw)
    if active is not None:
        t_best = torch.where(active, t_best, torch.full_like(t_best, INF))
    tri = torch.clamp(tri, 0, bvh.num_tris - 1)
    return finalize_hit(bvh, o, d, t_min, t_best, tri)


def ray_t_max(t_max, o) -> torch.Tensor:
    """A scalar or (N,) t_max as an (N,) tensor of the rays' type on their device."""
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=o.dtype, device=o.device), (o.shape[0],))


def real_slot(o) -> int:
    """A traversal wrapper's launch-count slot: 0 for its float32 kernel,
    1 for its float64 one."""
    return 0 if o.dtype == torch.float32 else 1


def finish_occluded(occ, t_max, active) -> torch.Tensor:
    """The any-hit walks' result under the closest-hit rule
    `closest.t <= t_max`: a ray whose t_max is +inf counts as occluded even
    with no hit, since inf <= inf (a directional light's distance is +inf;
    the reference behaves the same); an inactive lane never is."""
    occ = occ | (t_max == math.inf)
    if active is not None:
        occ = occ & active
    return occ


@counted(slots=2)
def bvh8_closest_hit(bvh: BvhData, pack: Bvh8Pack, o, d, t_min, active=None) -> Hit:
    """Closest hit through the wide BVH (t = inf on a miss, smooth normal,
    material id). CUDA rays launch the kernel of the pack's type (counted in
    slot 0 for float32, 1 for float64); CPU rays take the plain walk."""
    refuse_ray_grad("bvh8_closest_hit", o, d)
    check_dtype(pack, o, d)
    if _on_cpu(o):
        t_raw, tri = bvh8_closest_plain(pack, o, d, t_min, active)
    else:
        t_raw, tri = bvh8_closest_kernel(pack, o, d, t_min, active,
                                         launches=launch_counter(bvh8_closest_hit, o.device, real_slot(o)))
    return finish_closest(bvh, o, d, t_min, t_raw, tri, active)



@counted(slots=2)
def bvh8_occluded(bvh: BvhData, pack: Bvh8Pack, o, d, t_min, t_max, active=None) -> torch.Tensor:
    """Shadow query through the wide BVH, boolean-equal to
    `bvh8_closest_hit(...).t <= t_max` (see `finish_occluded`)."""
    check_dtype(pack, o, d)
    t_max = ray_t_max(t_max, o)
    if _on_cpu(o):
        occ = bvh8_occluded_plain(pack, o, d, t_min, t_max, active)
    else:
        occ = bvh8_occluded_kernel(pack, o, d, t_min, t_max, active,
                                   launches=launch_counter(bvh8_occluded, o.device, real_slot(o)))
    return finish_occluded(occ, t_max, active)
