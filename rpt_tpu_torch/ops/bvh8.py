"""8-ary wide-BVH traversal: closest hit and any hit, as CUDA kernels.

Replaces the two TPU kernels of `rpt_tpu/ops/bvh8_pallas.py`:
`_make_kernel8(occl=False)` (closest hit, reached through
`bvh8_closest_hit_pallas`) and `_make_kernel8(occl=True)` (shadow any-hit,
reached through `bvh8_occluded_pallas`). The kernels themselves are in
`rpt_tpu_torch/csrc/bvh8.cu`; this module holds the host pack, the plain
torch versions with the same contract, and the two counted wrappers, whose
launch and choice between kernel and plain walk by the device of the rays
are `ops/walk.py`'s. The node layout, the node-group walk and its plain
version are shared with the two-level kernels of `ops/tlas8.py`
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

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import counted
from ..utils.vmath import numpy_real, real_value
from . import walk
from .bvh import LEAF_SIZE, BvhData, _safe_inv, finish_closest, widen
from .intersect import Hit
from .walk import _BIG, _float_ray, _leaf_t, _slab, _slab_f32, _to_f32, _to_local, _tri_rows, box_upper

__all__ = [
    "Bvh8Pack",
    "WidePackRefused",
    "pack_bvh8",
    "bvh8_closest_hit",
    "bvh8_occluded",
    "bvh8_closest_plain",
    "bvh8_occluded_plain",
    "BOX_TEST_OPS",
    "TRI_TEST_OPS",
]

BRANCH = 8
STACK_CAP = 128  # the reference's stack cap (bvh8_pallas.STACK_CAP)
EMPTY = -1  # (a, b) pair b of an empty child slot
_NO_ROW = 2**62  # above every row: the tie key's "none"
INST_CHILD = -2  # b of an instance child (two-level tables, ops/tlas8.py)
KIND_EMPTY, KIND_NODE, KIND_INST, KIND_LEAF = 0, 1, 2, 3  # child reference kinds
_MAX_NODES = 2**24  # a group stack entry is node << 8 | rank mask in 32 bits
_MAX_PAYLOAD = 2**30  # a reference is payload << 2 | kind in 32 bits

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
    `ops/tlas8.Tlas8Pack`): `bounds` (Mw, 48) f32 and `meta` (Mw, 16) i32,
    walked by node groups (`wide`, `ops/walk.py`)."""

    wide = True

    def plain(self, o, d, t_min, t_max=None, active=None, stats=None):
        """The plain walk of the pack's kernels (`_group_walk`): the closest
        hit without `t_max`, the any hit with it, as `walk.launch` returns
        them."""
        return _group_walk(self, o, d, t_min, t_max, active, t_max is not None, stats)

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
    tris: torch.Tensor  # (T, 20) f32 (`walk._tri_rows`), or f64 in a float64 pack
    group_depth: int  # worst-case depth of the walk's node-group stack
    stack_need: int  # the reference's worst-case stack of single children

    library, two_level = "bvh8", False

    @property
    def nbytes(self) -> int:
        """Bytes of the tables the kernels read."""
        return sum(t.numel() * t.element_size() for t in (self.bounds, self.meta, self.tris))

    def launch_args(self, n: int, device):
        return (self.bounds, self.meta, self.group_depth, self.tris), ()

    def finish(self, bvh, o, d, t_min, out, active) -> Hit:
        return finish_closest(bvh, o, d, t_min, *out, active)

    def closest_hit(self, bvh, o, d, t_min, active=None) -> Hit:
        return bvh8_closest_hit(bvh, self, o, d, t_min, active)

    def occluded(self, bvh, o, d, t_min, t_max, active=None) -> torch.Tensor:
        return bvh8_occluded(bvh, self, o, d, t_min, t_max, active)


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


def group_stack_depth(meta: np.ndarray, inst_blas_root: Optional[np.ndarray] = None) -> int:
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


def refuse_overflow(n_nodes: int, n_rows: int, n_inst: int = 0):
    """Raise WidePackRefused if a node id, an instance id or a leaf's row
    overflows the kernels' 32-bit references and group stack entries."""
    if n_nodes >= _MAX_NODES or n_inst >= _MAX_PAYLOAD or n_rows // LEAF_SIZE >= _MAX_PAYLOAD >> 3:
        raise WidePackRefused(f"{n_nodes} wide nodes, {n_inst} instances or {n_rows} rows overflow the kernels' "
                              "32-bit references and stack entries")


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
    refuse_overflow(ca.shape[0], bvh.num_tris)
    bounds, meta = emit_group(lo, hi, valid, ca, cb)
    return Bvh8Pack(
        bounds=torch.as_tensor(bounds, device=device),
        meta=torch.as_tensor(meta, device=device),
        tris=torch.as_tensor(_tri_rows(bvh.verts.cpu().numpy(), numpy_real(bvh.verts.dtype)), device=device),
        group_depth=group_stack_depth(meta),
        stack_need=need,
    )


def emit_group(lo: np.ndarray, hi: np.ndarray, valid: np.ndarray, ca: np.ndarray, cb: np.ndarray):
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


def _slab_hit(b, ol, il, t_min, upper):
    """Slab test of csrc/walk.cuh `box_hit` for the children of each row's
    node (`_slab`'s arguments) against [t_min, upper], upper (L, 1) already
    widened (`box_upper`). Returns (L, C) bool by slot."""
    lo, hi = _slab(b, ol, il)
    return (lo <= hi) & (hi >= t_min) & (lo <= upper)


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
    Returns (t_raw, tri[, instance id two-level]) for the closest hit (t_raw
    = BIG on a miss) or the any-hit bool. `stats` accumulates box tests (filled slots
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
        return t_best, best.to(torch.int32)
    best_inst = torch.where(best_rank >= 0, rank_inst[best_rank.clamp(min=0)], torch.zeros_like(best_rank))
    return t_best, best.to(torch.int32), best_inst.to(torch.int32)


def bvh8_closest_plain(pack: Bvh8Pack, o, d, t_min, active=None, stats=None):
    """Plain version of the closest-hit kernel: (t_raw (N,) in the rays'
    type with BIG on a miss, triangle id (N,) i32). `stats`, if given, accumulates the
    counts of `_group_walk`."""
    return _group_walk(pack, o, d, t_min, None, active, False, stats)


def bvh8_occluded_plain(pack: Bvh8Pack, o, d, t_min, t_max, active=None, stats=None):
    """Plain version of the any-hit kernel: True iff some triangle lies in
    [t_min, t_max] along the ray."""
    return _group_walk(pack, o, d, t_min, t_max, active, True, stats)


# ---------------------------------------------------------------------------
# Wrappers (what SceneData.intersect / occluded call, through the pack)
# ---------------------------------------------------------------------------


@counted(slots=2)
def bvh8_closest_hit(bvh: BvhData, pack: Bvh8Pack, o, d, t_min, active=None) -> Hit:
    """Closest hit through the wide BVH (t = inf on a miss, smooth normal,
    material id): `walk.closest_hit`, counted here."""
    return walk.closest_hit(bvh8_closest_hit, bvh, pack, o, d, t_min, active)


@counted(slots=2)
def bvh8_occluded(bvh: BvhData, pack: Bvh8Pack, o, d, t_min, t_max, active=None) -> torch.Tensor:
    """Shadow query through the wide BVH, boolean-equal to
    `bvh8_closest_hit(...).t <= t_max` (`walk.occluded`, counted here)."""
    return walk.occluded(bvh8_occluded, pack, o, d, t_min, t_max, active)
