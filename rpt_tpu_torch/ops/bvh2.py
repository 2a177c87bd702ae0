"""Binary-BVH traversal over child-pair nodes: closest hit (near first) and
any hit, as CUDA kernels; and the child-pair pieces the binary two-level
kernels share (`ops/tlas2.py`).

Replaces the two TPU kernels of `rpt_tpu/ops/bvh_pallas.py`: `_kernel`
(closest hit, reached through `bvh_closest_hit_pallas`) and `_kernel_occl`
(shadow any-hit, reached through `bvh_occluded_pallas`). The kernels are in
`rpt_tpu_torch/csrc/bvh2.cu`, the walk in `csrc/pair_walk.cuh` (one-level
here, two-level in `csrc/tlas2.cu`); this module holds the host pack, the
plain torch version of the walk for both levels (`_pair_walk`) and the two
counted wrappers, whose launch and choice between kernel and plain walk by
the device of the rays are `ops/walk.py`'s.

The scene compiler takes these kernels for a baked mesh of fewer than
`WIDE_KERNEL_MIN_TRIS` rows, for every mesh under `RPT_BVH_KERNEL=binary`,
and where the wide pack refuses a tree (`scene.choose_bvh_pack`), so they
take every tree.

Layout. The binary SAH tree (`ops/bvh.py`) as it is built (the same nodes,
leaves and triangle rows), re-encoded as child-pair nodes: one record per
internal node, holding both children's boxes and references.

- `nodes` (P, 16) f32, 64 bytes, four 16-byte loads per node:
  `[loA.xyz, hiA.x] [hiA.yz, loB.xy] [loB.z, hiB.xyz] [refA, refB, 0, 0]`,
  the references as int32 bits. A reference is `payload << 2 | kind`, with
  the kinds of `ops/bvh8.py`: 1 a pair node (payload its index), 3 a
  triangle leaf (payload `start / 8 << 3 | count - 1`; leaves are 8-aligned
  and hold at most 8 rows), 0 an empty slot (inverted box); 2, an
  instance, occurs only in the two-level table. The pair nodes are the
  internal nodes in preorder. The root's box is never tested (its
  children's lie inside it); a tree that is one leaf is wrapped in a pair
  node with that one child and an empty slot.
- `tris` (T, 20) f32: the 20-float triangle rows of the wide kernels
  (`walk._tri_rows`), leaf-contiguous and 8-aligned, so a hit's id
  `leaf_start + k` indexes `BvhData.verts` and `finalize_hit` agrees.

A float64 pack (of a float64 `BvhData`) keeps `tris` in float64 and the
node boxes in float32, widened one ulp outward (`bvh.widen`) to hold the
float64 triangles; its walks are float64 (csrc/walk.cuh). Every float64
walk, one-level and two-level (`ops/tlas2.py`), tests the boxes in float
against a float copy of the ray, widened to take every box the double test
takes (`_slab_f32`, csrc/walk.cuh `box_entry_f`).

Walk. One ray per thread (per lane of the plain version). Visiting a pair
node slab-tests both children against [t_min, upper] (upper = the running
best hit, or t_max for the any hit; inclusive, as in the reference; widened
by 8 ulps, `walk.box_upper`), tests
a hit triangle leaf at once (A, then B), and goes on: of two hit node
children, into the nearer for the closest hit (by entry distance, A on a
tie) and into A for the any hit (left first: its t_max does not shrink),
pushing the other; into the one hit child; or to the top of the stack. The
any-hit walk stops at its first occluder.

Ties. The reference walks the tree in preorder by skip links and takes,
among equal t, the first leaf it reaches, and within a leaf the lowest row.
The leaves' rows rise in preorder (`pack_bvh2` asserts it), so a smaller
row is an earlier leaf: a leaf's best row replaces the best hit on t <
best, or on t == best with a smaller row, whatever order the walk takes.

`stack_depth` is the exact worst-case depth of the stack: the longest chain
of pushed far children on any path from the root. `walk.launch_plan`
places a stack of that depth: in the shared memory of a 128-ray block, of a
smaller block, or past what one block holds, in a global scratch buffer. No
tree is refused.

The plain version repeats the kernels' arithmetic op for op (the slab and
triangle tests of `csrc/walk.cuh`; the kernels are built with -fmad=false),
so the two agree bit for bit.
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
from .bvh8 import KIND_EMPTY, KIND_INST, KIND_LEAF, KIND_NODE
from .intersect import Hit
from .walk import _BIG, _float_ray, _leaf_t, _slab, _slab_f32, _to_f32, _to_local, _tri_rows, box_upper

__all__ = [
    "Bvh2Pack",
    "pack_bvh2",
    "bvh2_closest_hit",
    "bvh2_occluded",
    "bvh2_closest_plain",
    "bvh2_occluded_plain",
]


class PairNodes:
    """The child-pair table of the pair-walk packs (`Bvh2Pack`, and
    `ops/tlas2.Tlas2Pack`): `nodes` (P, 16) f32 and `stack_depth`, walked
    by child pairs (not `wide`, `ops/walk.py`)."""

    wide = False

    def plain(self, o, d, t_min, t_max=None, active=None, stats=None):
        """The plain walk of the pack's kernels (`_pair_walk`): the closest
        hit without `t_max`, the any hit with it, as `walk.launch` returns
        them."""
        return _pair_walk(self, o, d, t_min, t_max, active, stats)

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def refs(self) -> torch.Tensor:
        """(P, 2) i32 child references, A and B."""
        return self.nodes[:, 12:14].view(torch.int32)

    @property
    def node_bytes(self) -> int:
        return self.nodes.shape[1] * self.nodes.element_size()


@dataclasses.dataclass(frozen=True)
class Bvh2Pack(PairNodes):
    nodes: torch.Tensor  # (P, 16) f32 child-pair nodes
    tris: torch.Tensor  # (T, 20) f32 (f64 in a float64 pack)
    stack_depth: int  # worst-case depth of the walk's stack

    library, two_level = "bvh2", False

    @property
    def nbytes(self) -> int:
        """Bytes of the tables the kernels read."""
        return sum(t.numel() * t.element_size() for t in (self.nodes, self.tris))

    def launch_args(self, n: int, device):
        return (self.nodes, self.tris), walk.pair_stack(self.stack_depth, n, device)

    def finish(self, bvh, o, d, t_min, out, active) -> Hit:
        return finish_closest(bvh, o, d, t_min, *out, active)

    def closest_hit(self, bvh, o, d, t_min, active=None) -> Hit:
        return bvh2_closest_hit(bvh, self, o, d, t_min, active)

    def occluded(self, bvh, o, d, t_min, t_max, active=None) -> torch.Tensor:
        return bvh2_occluded(bvh, self, o, d, t_min, t_max, active)


# ---------------------------------------------------------------------------
# Host pack
# ---------------------------------------------------------------------------


def pair_nodes(node_min, node_max, skip, leaf_ref, roots, base: int):
    """Child-pair records (module docstring) of the skip-link preorder trees
    rooted at `roots` in one node array: `leaf_ref` (M,) is the reference
    of each leaf, 0 at internal nodes; pair nodes are numbered from `base`.
    Returns (records (P, 16) f32 with the references' int32 bits, the pair
    node of each binary node (M,): its own where internal, its wrapper at a
    leaf root, else -1)."""
    internal = leaf_ref == 0
    slot = internal.copy()
    slot[roots] = True
    pid = np.where(slot, base + np.cumsum(slot) - 1, -1)
    rec = np.zeros((int(slot.sum()), 16), np.float32)
    ref = rec.view(np.int32)

    def child_ref(c):
        return np.where(internal[c], pid[c] << 2 | KIND_NODE, leaf_ref[c])

    par = np.flatnonzero(internal)
    a = par + 1
    b = skip[a]
    rows = pid[par] - base
    rec[rows, 0:3], rec[rows, 3:6] = node_min[a], node_max[a]
    rec[rows, 6:9], rec[rows, 9:12] = node_min[b], node_max[b]
    ref[rows, 12], ref[rows, 13] = child_ref(a), child_ref(b)
    wrapped = np.asarray([r for r in roots if not internal[r]], np.int64)
    rows = pid[wrapped] - base
    rec[rows, 0:3], rec[rows, 3:6] = node_min[wrapped], node_max[wrapped]
    rec[rows, 6:9], rec[rows, 9:12] = _BIG, -_BIG
    ref[rows, 12], ref[rows, 13] = leaf_ref[wrapped], 0
    return rec, pid


def pair_stack_depth(refs: np.ndarray, rank_root: Optional[np.ndarray] = None) -> int:
    """Exact worst-case stack depth of the walk from pair node 0 over the
    references `refs` (P, 2): a node whose two children are both node or
    instance children pushes one of them, and either may be the far one,
    so need(node) = 1 + max(need(A), need(B)) there; with one such child
    its need, with none 0. An instance child needs what its BLAS root
    needs (`rank_root` (K,), by rank; two-level only). Iterated to its
    fixed point, one level per pass."""
    kind, payload = refs & 3, refs >> 2
    trav = (kind == KIND_NODE) | (kind == KIND_INST)
    target = np.where(kind == KIND_NODE, payload, 0)
    if rank_root is not None:
        inst = kind == KIND_INST
        target = np.where(inst, rank_root[np.where(inst, payload, 0)], target)
    need = np.zeros(refs.shape[0], np.int64)
    while True:
        new = np.where(trav, need[target], 0).max(1) + trav.all(1)
        if np.array_equal(new, need):
            return int(need[0])
        need = new


def leaf_refs(start: np.ndarray, count: np.ndarray) -> np.ndarray:
    """The triangle-leaf references (module docstring) of leaves of `count`
    rows from `start`, 0 where `count` is 0 (an internal node)."""
    start, count = start.astype(np.int64), count.astype(np.int64)
    return np.where(count > 0, ((start // LEAF_SIZE) << 3 | (count - 1)) << 2 | KIND_LEAF, 0)


def pack_bvh2(bvh: BvhData, device=None) -> Bvh2Pack:
    """A built binary BVH in the kernels' layout (module docstring). Every
    tree fits: `walk.launch_plan` places any stack depth."""
    node_min, node_max, skip, start, count = (t.cpu().numpy() for t in (
        bvh.node_min, bvh.node_max, bvh.skip, bvh.leaf_start, bvh.leaf_count))
    if bvh.verts.dtype == torch.float64:
        node_min, node_max = widen(node_min, node_max)
    leaf = count > 0
    assert (start[leaf] % LEAF_SIZE == 0).all() and (count[leaf] <= LEAF_SIZE).all(), \
        "leaves must be 8-aligned and hold at most 8 rows"
    # The tie key: a smaller row must mean an earlier leaf in preorder.
    assert (np.diff(start[leaf]) > 0).all(), "leaf rows must rise in preorder"
    nodes, _ = pair_nodes(node_min, node_max, skip.astype(np.int64), leaf_refs(start, count), np.array([0]), 0)
    return Bvh2Pack(
        nodes=torch.as_tensor(nodes, device=device),
        tris=torch.as_tensor(_tri_rows(bvh.verts.cpu().numpy(), numpy_real(bvh.verts.dtype)), device=device),
        stack_depth=pair_stack_depth(nodes.view(np.int32)[:, 12:14]),
    )


# ---------------------------------------------------------------------------
# Plain torch version (CPU tensors, tests, and the reference on the card)
# ---------------------------------------------------------------------------


def _pair_walk(pack: PairNodes, o, d, t_min, t_max, active, stats: Optional[dict]):
    """Lockstep version of csrc/pair_walk.cuh over the table of `pack` (its
    nodes, tris and stack_depth): each step visits one pair node for every
    ray still walking, then moves it on (module docstring). `t_max` None
    asks for the closest hit, else the any hit. One tree, or, where the
    pack carries instance records `inst_rows` (K, 16), the two-level table
    of `ops/tlas2.py`: pair nodes from `n_tlas` on are in an instance's
    frame, an instance child enters its BLAS root, and the tie key is (TLAS
    leaf rank, row); one-level every rank is 0, so the key is the row. The
    float64 walks test their boxes in float (`_slab_f32`) and take the
    nearer child by the float entry, as their kernels do.

    Returns the any-hit bool, or for the closest hit (t_raw (N,) in the
    rays' type, BIG on a miss; triangle row (N,) i32), two-level also the instance id (N,)
    i32. `stats` accumulates box tests (filled child slots of each visited
    node), triangle tests (rows of each tested leaf), instance entries
    (two-level) and the deepest stack reached (`max_stack_depth`)."""
    dev = o.device
    N = o.shape[0]
    occl = t_max is not None
    two_level = getattr(pack, "inst_rows", None) is not None
    float_box = o.dtype == torch.float64
    t_min = real_value(t_min, o.dtype)
    inv = _safe_inv(d)
    if float_box:
        t_min_f = _to_f32(torch.tensor(t_min, dtype=torch.float64), up=False).item()
        fr = _float_ray(o, d)
    boxes = pack.nodes[:, :12].reshape(-1, 2, 6).transpose(1, 2)  # (P, 6, 2): lo.xyz, hi.xyz by slot
    refs = pack.refs.long()
    kinds = refs & 3
    kk = torch.arange(LEAF_SIZE, device=dev)

    t_best = torch.full((N,), _BIG, dtype=o.dtype, device=dev)
    best = torch.zeros(N, dtype=torch.int64, device=dev)
    best_rank = torch.full((N,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(N, dtype=torch.bool, device=dev)
    node = torch.zeros(N, dtype=torch.int64, device=dev)  # the next node to visit; the root first
    rank = torch.zeros(N, dtype=torch.int64, device=dev)  # the current instance's TLAS leaf rank
    if two_level:
        n_tlas = pack.n_tlas
        aff = pack.inst_rows[:, :12].reshape(-1, 3, 4)
        r = pack.inst_rows.element_size() // 4  # int32 words per real: the ints sit at real 12
        rank_root, rank_inst = pack.inst_rows.view(torch.int32)[:, 12 * r:12 * r + 2].long().unbind(1)
        o_loc, d_loc, inv_loc = torch.zeros_like(o), torch.zeros_like(d), torch.zeros_like(d)
        if float_box:
            fr_loc = torch.zeros((N, 9), dtype=torch.float32, device=dev)
    stack = torch.zeros((N, max(pack.stack_depth, 1)), dtype=torch.int64, device=dev)
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
        w = node[live]
        if two_level:
            local = (w >= n_tlas)[:, None]
            ol = torch.where(local, o_loc[live], o[live])
            dl = torch.where(local, d_loc[live], d[live])
            il = torch.where(local, inv_loc[live], inv[live])
            if float_box:
                frl = torch.where(local, fr_loc[live], fr[live])
        else:
            ol, dl, il = o[live], d[live], inv[live]
            if float_box:
                frl = fr[live]

        # Visit: slab-test both children against the best hit so far.
        upper = (t_max[live] if occl else t_best[live])[:, None]
        ref, kind = refs[w], kinds[w]  # (L, 2)
        if float_box:
            lo, hi = _slab_f32(boxes[w], frl)
            hit = (lo <= hi) & (hi >= t_min_f) & (lo <= _to_f32(upper, up=True))
        else:
            lo, hi = _slab(boxes[w], ol, il)
            hit = (lo <= hi) & (hi >= t_min) & (lo <= box_upper(upper))
        hit = hit & (kind != KIND_EMPTY)
        if stats is not None:
            n_box += (kind != KIND_EMPTY).sum()

        # Hit triangle leaves, A then B, each against the best hit so far.
        for s in range(2):
            j = torch.nonzero(hit[:, s] & (kind[:, s] == KIND_LEAF) & walking[live])[:, 0]
            if j.numel() == 0:
                continue
            payload = ref[j, s] >> 2
            start = (payload >> 3) * LEAF_SIZE
            count = (payload & 7) + 1
            t, ok = _leaf_t(pack.tris[start[:, None] + kk], ol[j], dl[j], t_min)
            ok = ok & (kk < count[:, None])
            if stats is not None:
                n_tri += count.sum()
            ray = live[j]
            if occl:
                stop = ray[(ok & (t <= t_max[ray][:, None])).any(1)]
                occ[stop] = True
                walking[stop] = False  # early exit
                continue
            th = torch.where(ok, t, torch.full_like(t, _BIG))
            t_leaf = th.min(1).values
            row = start + torch.where(th == t_leaf[:, None], kk, LEAF_SIZE).min(1).values
            tb, br, bb, rk = t_best[ray], best_rank[ray], best[ray], rank[ray]
            better = (t_leaf < tb) | ((t_leaf == tb) & (tb < _BIG) & ((rk < br) | ((rk == br) & (row < bb))))
            t_best[ray] = torch.where(better, t_leaf, tb)
            best[ray] = torch.where(better, row, bb)
            best_rank[ray] = torch.where(better, rk, br)

        # Move on: of two hit node or instance children the nearer (closest
        # hit) or A (any hit), the other pushed; the one hit child; else the
        # top of the stack.
        keep = walking[live]
        live, ref, lo = live[keep], ref[keep], lo[keep]
        go = hit[keep] & (kind[keep] != KIND_LEAF)
        both = go[:, 0] & go[:, 1]
        b_first = both & (lo[:, 1] < lo[:, 0]) & (not occl)
        nxt = torch.where(b_first | (go[:, 1] & ~go[:, 0]), ref[:, 1], ref[:, 0])
        if bool(both.any()):
            r = live[both]
            stack[r, sp[r]] = torch.where(b_first[both], ref[both, 0], ref[both, 1])
            sp[r] += 1
            max_sp = torch.maximum(max_sp, sp[r].max())
        pop = ~go.any(1)
        if bool(pop.any()):
            done = pop & (sp[live] == 0)
            walking[live[done]] = False
            pop = pop & ~done
            r = live[pop]
            sp[r] -= 1
            nxt[pop] = stack[r, sp[r]]
            live, nxt = live[~done], nxt[~done]
        payload = nxt >> 2
        node[live] = payload
        enter = (nxt & 3) == KIND_INST
        if two_level and bool(enter.any()):
            # Instances: the world ray in the instance's frame, direction
            # unnormalized; then its BLAS root.
            r, k = live[enter], payload[enter]
            o_loc[r], d_loc[r], inv_loc[r] = _to_local(aff[k], o[r], d[r])
            if float_box:
                fr_loc[r] = _float_ray(o_loc[r], d_loc[r])
            rank[r] = k
            node[r] = rank_root[k]
            n_inst += r.numel()

    if stats is not None:
        stats["box_tests"] = stats.get("box_tests", 0) + int(n_box)
        stats["tri_tests"] = stats.get("tri_tests", 0) + int(n_tri)
        if two_level:
            stats["inst_entries"] = stats.get("inst_entries", 0) + int(n_inst)
        stats["max_stack_depth"] = max(stats.get("max_stack_depth", 0), int(max_sp))
    if occl:
        return occ
    if not two_level:
        return t_best, best.to(torch.int32)
    best_inst = torch.where(best_rank >= 0, rank_inst[best_rank.clamp(min=0)], torch.zeros_like(best_rank))
    return t_best, best.to(torch.int32), best_inst.to(torch.int32)


def bvh2_closest_plain(pack: Bvh2Pack, o, d, t_min, active=None, stats=None):
    """Plain version of the closest-hit kernel: (t_raw (N,) in the rays'
    type with BIG on a miss, triangle id (N,) i32). `stats`, if given,
    accumulates the counts of `_pair_walk`."""
    return _pair_walk(pack, o, d, t_min, None, active, stats)


def bvh2_occluded_plain(pack: Bvh2Pack, o, d, t_min, t_max, active=None, stats=None):
    """Plain version of the any-hit kernel: True iff some triangle lies in
    [t_min, t_max] along the ray."""
    return _pair_walk(pack, o, d, t_min, t_max, active, stats)


# ---------------------------------------------------------------------------
# Wrappers (what SceneData.intersect / occluded call, through the pack)
# ---------------------------------------------------------------------------


@counted(slots=2)
def bvh2_closest_hit(bvh: BvhData, pack: Bvh2Pack, o, d, t_min, active=None) -> Hit:
    """Closest hit through the binary BVH (t = inf on a miss, smooth normal,
    material id): `walk.closest_hit`, counted here."""
    return walk.closest_hit(bvh2_closest_hit, bvh, pack, o, d, t_min, active)


@counted(slots=2)
def bvh2_occluded(bvh: BvhData, pack: Bvh2Pack, o, d, t_min, t_max, active=None) -> torch.Tensor:
    """Shadow query through the binary BVH, boolean-equal to
    `bvh2_closest_hit(...).t <= t_max` (`walk.occluded`, counted here)."""
    return walk.occluded(bvh2_occluded, pack, o, d, t_min, t_max, active)
