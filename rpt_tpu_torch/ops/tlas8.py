"""Two-level wide-BVH traversal over instanced meshes: closest hit and any
hit, as CUDA kernels.

Replaces the two TPU kernels of `rpt_tpu/ops/tlas8_pallas.py`:
`_make_kernel_t8(occl=False, resident)` (closest hit, reached through
`tlas8_closest_hit_pallas`) and `_make_kernel_t8(occl=True, resident)` (any
hit, reached through `tlas8_occluded_pallas`). The kernels are in
`rpt_tpu_torch/csrc/tlas8.cu`; this module holds the host pack, the plain
torch versions with the same contract and the two counted wrappers, whose
launch and choice between kernel and plain walk by the device of the rays
are `ops/walk.py`'s. The hit finalize is the instanced meshes' own
(`tlas.finish_instanced`), shared with `ops/tlas2.py`.

Layout. ONE wide-node table holds both levels: the binary TLAS over
instances collapsed into wide nodes from node 0 on (`n_tlas` of them, world
space), then one wide BLAS per unique mesh segment (local space), shared by
every instance of the mesh. Both are collapsed with the reference's
smallest-subtree-first frontier expansion (`_collapse_wide`, copied).

- `bounds` (Mw, 48) f32 and `meta` (Mw, 16) i32: the one-level pack's
  node layout (`ops/bvh8.py`): 8 child boxes, 8 child references
  `payload << 2 | kind` and 8 octant words; here a reference may also be
  kind 2, an instance (payload its TLAS leaf rank, the leaf's position
  among the binary TLAS's leaves in preorder).
- `inst_rows` (K, 16) f32 by TLAS leaf rank: the instance's 3x4
  world->local rows, then `[wide BLAS root, instance id, 0, 0]` as int32
  bits (the layout of `ops/tlas2.py`'s records); `inst` (K, 12) f32 the
  world->local rows by instance id, for the finalize.
- `tris` (L*8, 20) f32: the 20-float rows (`walk._tri_rows`) of the
  local-space triangles, leaf-contiguous and 8-aligned, a short leaf padded
  with its first triangle (the reference's packing); `p_verts`, `p_norms`
  the same triangles for the finalize.

A float64 pack (of float64 `InstancedMeshes`) keeps `inst_rows` (the two
int32 in the bytes of float64 12), `inst`, `tris`, `p_verts` and `p_norms`
in float64 and the node boxes in float32: the BLAS
boxes widened one ulp outward (`bvh.widen`), the TLAS boxes recomputed to
hold every instance below them (`tlas.holding_boxes`).

Walk: the one-level node-group walk (`ops/bvh8.py` `_group_walk`,
`csrc/group_walk.cuh`, shared with the one-level kernels) over both
levels. An instance child re-expresses the world ray in its frame
(direction unnormalized, so local t == world t) and enters its BLAS root; a
node's frame is its index (`>= n_tlas` is local), and LIFO order means one
local ray serves. The visit order is exactly that of a stack with one entry
per hit child, pushed far first. The float64 walk tests its boxes in float
against a float copy of the ray, widened to take every box a double test
takes (`walk._slab_f32`, as the float64 tlas2 walk does).

Ties. The reference takes, among equal t, the leaf it visits first in
preorder: the first TLAS leaf, then the first BLAS leaf. The walk keeps
that choice, as the binary walks do: a leaf's best row replaces the best
hit on t < best, or on t == best with a smaller key (TLAS leaf rank,
packed row); packed rows follow BLAS node order. The kernel carries the
rank and maps the winner's rank to its instance id at the end.

`group_depth` is the exact worst-case depth of that stack; `stack_need`
the reference's bound for a stack of single children, which decides, as in
the reference, whether the wide pack is taken: above STACK_CAP the pack
raises WidePackRefused and the scene compiler takes the binary two-level
kernels (`ops/tlas2.py`). Every group on the stack stands for at least one
child the other stack would hold, so group_depth <= stack_need <= 128
levels: at most 64 KB of shared memory for a block of 128 rays. The
TPU-only budgets are not carried over: no resident/dma modes, no
node-count gate, no (8, 128) tiles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import counted
from ..utils.vmath import numpy_real
from . import walk
from .bvh import widen
from .bvh8 import (
    BRANCH,
    EMPTY,
    INST_CHILD,
    STACK_CAP,
    WideNodes,
    WidePackRefused,
    emit_group,
    group_stack_depth,
    refuse_overflow,
)
from .intersect import Hit
from .tlas import InstancedMeshes, finish_instanced, holding_boxes, packed_leaves
from .walk import _tri_rows

__all__ = [
    "Tlas8Pack",
    "pack_tlas8",
    "tlas8_closest_hit",
    "tlas8_occluded",
    "tlas8_closest_plain",
    "tlas8_occluded_plain",
    "INST_ENTRY_OPS",
]

# Floating-point operations of one instance entry, counted from
# csrc/tlas8.cu: origin 9 mul + 9 add, direction 9 mul + 6 add, and per axis
# of the inverse direction a compare and a divide.
INST_ENTRY_OPS = 39


@dataclasses.dataclass(frozen=True)
class Tlas8Pack(WideNodes):
    bounds: torch.Tensor  # (Mw, 48) f32
    meta: torch.Tensor  # (Mw, 16) i32: child references, octant words
    inst_rows: torch.Tensor  # (K, 16) by TLAS leaf rank: rows, [BLAS root, id] as int32; f32 (f64)
    inst: torch.Tensor  # (K, 12) world->local rows by instance id, f32 (f64 in a float64 pack)
    tris: torch.Tensor  # (L*8, 20) f32 (f64 in a float64 pack)
    p_verts: torch.Tensor  # (L*8, 3, 3) packed local-space triangles
    p_norms: torch.Tensor  # (L*8, 3, 3)
    n_tlas: int  # wide nodes 0..n_tlas-1 are the TLAS (world space)
    group_depth: int  # worst-case depth of the walk's node-group stack
    stack_need: int  # the reference's worst-case stack of single children

    library, two_level = "tlas8", True

    @property
    def nbytes(self) -> int:
        """Bytes of the tables the kernels read."""
        return sum(t.numel() * t.element_size() for t in (self.bounds, self.meta, self.inst_rows, self.tris))

    def launch_args(self, n: int, device):
        return (self.bounds, self.meta, self.n_tlas, self.group_depth, self.inst_rows, self.tris), ()

    def finish(self, im, o, d, t_min, out, active) -> Hit:
        return finish_instanced(im, self, o, d, t_min, *out, active)

    def closest_hit(self, im, o, d, t_min, active=None) -> Hit:
        return tlas8_closest_hit(im, self, o, d, t_min, active)

    def occluded(self, im, o, d, t_min, t_max, active=None) -> torch.Tensor:
        return tlas8_occluded(im, self, o, d, t_min, t_max, active)

    def _rank_ints(self) -> torch.Tensor:
        r = self.inst_rows.element_size() // 4  # int32 words per real: the ints sit at real 12
        return self.inst_rows.view(torch.int32)[:, 12 * r:12 * r + 2]

    @property
    def rank_inst(self) -> torch.Tensor:
        """(K,) i32 the instance id of each TLAS leaf rank."""
        return self._rank_ints()[:, 1]

    @property
    def inst_root(self) -> torch.Tensor:
        """(K,) i32 the wide BLAS root of each instance, by instance id."""
        root = torch.empty_like(self.rank_inst)
        root[self.rank_inst.long()] = self._rank_ints()[:, 0]
        return root


# ---------------------------------------------------------------------------
# Host pack
# ---------------------------------------------------------------------------


def _collapse_wide(skip, is_leaf, payload_a, payload_b, root, out_nodes, node_min, node_max) -> int:
    """Collapse the binary preorder subtree rooted at `root` into wide nodes
    appended to out_nodes (copied from rpt_tpu/ops/tlas8_pallas.py). Leaf
    children become (box, payload_a[f], payload_b[f]); internal children
    (box, global wide index, 0). Returns the wide root index."""

    def expand(b):
        # Frontier of <= BRANCH binary descendants, smallest subtree first.
        if is_leaf[b]:
            return [b]
        frontier = [b]
        while len(frontier) < BRANCH:
            cand = [j for j in frontier if not is_leaf[j]]
            if not cand:
                break
            j = min(cand, key=lambda n: int(skip[n]) - n)
            frontier.remove(j)
            frontier.extend([j + 1, int(skip[j + 1])])
        return frontier

    base = len(out_nodes)
    windex = {}
    frontiers = []
    stack = [root]
    while stack:
        b = stack.pop()
        windex[b] = base + len(frontiers)
        fr = expand(b)
        frontiers.append(fr)
        for f in reversed(fr):
            if not is_leaf[f]:
                stack.append(f)
    for fr in frontiers:
        out_nodes.append([
            (node_min[f], node_max[f], int(payload_a[f]), int(payload_b[f])) if is_leaf[f]
            else (node_min[f], node_max[f], windex[f], 0)
            for f in fr
        ])
    return base


def _tlas_stack_need(out_nodes, rank_root) -> int:
    """Exact worst-case stack need of a walk that pushes every hit child
    (the reference's bound, `tlas8_pallas._tlas_stack_need`). Popping a node
    pushes its hit internal and instance children; an instance entry
    replaces itself with its BLAS root, so an instance child needs what its
    BLAS root needs. Children sit at larger indices than their parents and
    every BLAS after the TLAS, so one reverse pass sees each child before
    its parent."""
    need = np.zeros(len(out_nodes), np.int64)
    for w in range(len(out_nodes) - 1, -1, -1):
        targets = [a if b == 0 else rank_root[a] for (_, _, a, b) in out_nodes[w] if b in (0, INST_CHILD)]
        if targets:
            n = len(targets)
            need[w] = max(n, n - 1 + int(need[targets].max()))
    return max(1, 1 + int(need[0]))


def _collapse_instanced(im: InstancedMeshes):
    """The TLAS and every unique BLAS collapsed into one list of wide nodes
    (TLAS first), an instance child's payload its TLAS leaf rank. Returns
    (out_nodes, n_tlas, rank_root (K,) the wide BLAS root of each rank,
    inst_of_rank (K,), p_verts, p_norms). A float64 scene's boxes hold its
    float64 triangles (`holding_boxes`, `widen`)."""
    t_min, t_max = im.t_min.cpu().numpy(), im.t_max.cpu().numpy()
    t_skip, t_leaf_inst = im.t_skip.cpu().numpy().astype(np.int64), im.t_leaf_inst.cpu().numpy().astype(np.int64)
    b_min, b_max = im.b_min.cpu().numpy(), im.b_max.cpu().numpy()
    if im.verts.dtype == torch.float64:
        t_min, t_max = holding_boxes(im)
        b_min, b_max = widen(b_min, b_max)
    b_skip = im.b_skip.cpu().numpy().astype(np.int64)
    inst_root, inst_end = im.inst_root.cpu().numpy(), im.inst_end.cpu().numpy()
    b_leaf_start, b_leaf_count, p_verts, p_norms = packed_leaves(im)
    # The tie key: within an instance, a smaller packed row must mean an
    # earlier BLAS leaf in preorder.
    assert (np.diff(b_leaf_start[b_leaf_count > 0]) > 0).all(), "packed rows must rise in BLAS preorder"

    out_nodes: list = []
    # The TLAS first (root = wide node 0): its leaves are instances, each
    # referenced by its rank among the leaves in preorder (the tie key).
    t_leaf = t_leaf_inst >= 0
    rank = np.cumsum(t_leaf) - 1
    _collapse_wide(t_skip, t_leaf, rank, np.full_like(t_leaf_inst, INST_CHILD), 0, out_nodes, t_min, t_max)
    n_tlas = len(out_nodes)
    # One wide BLAS per unique mesh segment; instances share by (root, end).
    wide_root_of = {
        seg: _collapse_wide(b_skip, b_leaf_count > 0, b_leaf_start, b_leaf_count, seg[0], out_nodes, b_min, b_max)
        for seg in sorted(set(zip(inst_root.tolist(), inst_end.tolist())))
    }
    inst_blas_root = np.array([wide_root_of[(int(r), int(e))] for r, e in zip(inst_root, inst_end)], np.int64)
    inst_of_rank = t_leaf_inst[t_leaf]
    return out_nodes, n_tlas, inst_blas_root[inst_of_rank], inst_of_rank, p_verts, p_norms


def _slot_arrays(out_nodes):
    """Per-slot child boxes lo, hi (Mw, 8, 3) f32, the filled-slot mask and
    the (a, b) pairs (Mw, 8) of `_collapse_wide`'s children."""
    Mw = len(out_nodes)
    lo = np.zeros((Mw, BRANCH, 3), np.float32)
    hi = np.zeros((Mw, BRANCH, 3), np.float32)
    ca = np.zeros((Mw, BRANCH), np.int64)
    cb = np.full((Mw, BRANCH), EMPTY, np.int64)
    for w, children in enumerate(out_nodes):
        for c, (bmn, bmx, a, b) in enumerate(children):
            lo[w, c], hi[w, c], ca[w, c], cb[w, c] = bmn, bmx, a, b
    return lo, hi, cb != EMPTY, ca, cb


def pack_tlas8(im: InstancedMeshes, device=None) -> Tlas8Pack:
    """The kernels' table for an instanced scene (module docstring). Raises
    WidePackRefused if the reference's walk could need a deeper stack than
    STACK_CAP, or an id overflows the kernels' 32-bit references and stack
    entries."""
    out_nodes, n_tlas, rank_root, inst_of_rank, p_verts, p_norms = _collapse_instanced(im)
    need = _tlas_stack_need(out_nodes, rank_root)
    if need > STACK_CAP:
        raise WidePackRefused(f"the two-level wide BVH needs a stack of {need} > {STACK_CAP} entries")
    K = rank_root.shape[0]
    refuse_overflow(len(out_nodes), p_verts.shape[0], K)
    bounds, meta = emit_group(*_slot_arrays(out_nodes))
    real = im.verts.dtype
    np_real = numpy_real(real)
    inst_inv = im.inst_inv.cpu().numpy().reshape(K, 12).astype(np_real)
    inst_rows = np.zeros((K, 16), np_real)
    inst_rows[:, :12] = inst_inv[inst_of_rank]
    r = inst_rows.itemsize // 4  # int32 words per real: the ints sit at real 12
    inst_rows.view(np.int32)[:, 12 * r] = rank_root
    inst_rows.view(np.int32)[:, 12 * r + 1] = inst_of_rank

    def t(a, dtype=real):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return Tlas8Pack(
        bounds=t(bounds, torch.float32), meta=t(meta, torch.int32), inst_rows=t(inst_rows), inst=t(inst_inv),
        tris=t(_tri_rows(p_verts, np_real)), p_verts=t(p_verts), p_norms=t(p_norms),
        n_tlas=n_tlas, group_depth=group_stack_depth(meta, rank_root), stack_need=need,
    )


# ---------------------------------------------------------------------------
# Plain torch versions (CPU tensors, tests, and the reference on the card)
# ---------------------------------------------------------------------------


def tlas8_closest_plain(pack: Tlas8Pack, o, d, t_min, active=None, stats=None):
    """Plain version of the closest-hit kernel: (t_raw (N,) in the rays'
    type with BIG on a miss, packed triangle id (N,) i32, instance id (N,) i32). `stats`, if
    given, accumulates the counts of `bvh8._group_walk`."""
    return pack.plain(o, d, t_min, active=active, stats=stats)


def tlas8_occluded_plain(pack: Tlas8Pack, o, d, t_min, t_max, active=None, stats=None):
    """Plain version of the any-hit kernel: True iff some instanced triangle
    lies in [t_min, t_max] along the ray."""
    return pack.plain(o, d, t_min, t_max, active, stats)


# ---------------------------------------------------------------------------
# Wrappers (what SceneData.intersect / occluded call, through the pack)
# ---------------------------------------------------------------------------


@counted(slots=2)
def tlas8_closest_hit(im: InstancedMeshes, pack: Tlas8Pack, o, d, t_min, active=None) -> Hit:
    """Closest hit over every instance (t = inf on a miss, smooth normal,
    material id): `walk.closest_hit`, counted here."""
    return walk.closest_hit(tlas8_closest_hit, im, pack, o, d, t_min, active)


@counted(slots=2)
def tlas8_occluded(im: InstancedMeshes, pack: Tlas8Pack, o, d, t_min, t_max, active=None) -> torch.Tensor:
    """Shadow query over every instance, boolean-equal to
    `tlas8_closest_hit(...).t <= t_max`, also for t_max = +inf (a miss then
    counts as occluded, as in the reference; `walk.occluded`, counted here)."""
    return walk.occluded(tlas8_occluded, pack, o, d, t_min, t_max, active)
