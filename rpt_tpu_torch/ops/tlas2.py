"""Two-level binary-BVH traversal over instanced meshes on child-pair
nodes: closest hit (near first) and any hit, as CUDA kernels.

Replaces the two TPU kernels of `rpt_tpu/ops/tlas_pallas.py`: `_kernel`
(closest hit, reached through `tlas_closest_hit_pallas`) and `_kernel_occl`
(any hit, reached through `tlas_occluded_pallas`). The kernels are in
`rpt_tpu_torch/csrc/tlas2.cu`, the walk in `csrc/pair_walk.cuh`, shared with
the one-level kernels of `ops/bvh2.py`, which also holds its plain torch
version (`_pair_walk`); this module holds the host pack and the two counted
wrappers, whose launch and choice between kernel and plain walk by the
device of the rays are `ops/walk.py`'s. The hit finalize is the instanced
meshes' own (`tlas.finish_instanced`), shared with `ops/tlas8.py`: both
packs keep the same packed triangle order.

The scene compiler takes these kernels for an instanced scene under
`RPT_BVH_KERNEL=binary`, and where the wide two-level pack refuses the
scene (`scene.choose_instanced_pack`), so they take every scene. The
reference keeps its tables in SMEM and falls back to an XLA loop past a
700,000-byte budget; these tables sit in device memory, and the stack goes
where it fits (`walk.launch_plan`).

Layout. The two binary trees of `InstancedMeshes` as they are built (the
same nodes, leaves, instance rows and packed triangles), re-encoded as
child-pair nodes: one record per internal node, holding both children's
boxes and references.

- `nodes` (M, 16) f32, 64 bytes, four 16-byte loads per node:
  `[loA.xyz, hiA.x] [hiA.yz, loB.xy] [loB.z, hiB.xyz] [refA, refB, 0, 0]`,
  the references as int32 bits. A reference is `payload << 2 | kind`, with
  the kinds of `ops/bvh8.py`: 1 a pair node (payload its index), 2 an
  instance (payload its TLAS leaf rank, the leaf's position among the TLAS
  leaves in preorder), 3 a triangle leaf (payload `start / 8 << 3 |
  count - 1`; leaves are 8-aligned and hold at most 8 rows), 0 an empty
  slot (inverted box). Nodes `0..n_tlas-1` are the TLAS's internal nodes in
  preorder (world space), then every BLAS's in the order they were built
  (local space). An internal root is its own pair node and its box is never
  tested (its children's lie inside it); a root that is a leaf is wrapped
  in a pair node with that one child and an empty slot.
- `inst_rows` (K, 16) f32, by TLAS leaf rank: the instance's 3x4
  world->local rows, then `[BLAS root pair node, instance id, 0, 0]` as
  int32 bits.
- `inst` (K, 12) f32, the world->local rows by instance id, and `tris`
  (L*8, 20) f32 with `p_verts`, `p_norms`: the local-space triangles in the
  packed order of `tlas.packed_leaves`, as `ops/tlas8.py` has them.

A float64 pack (of float64 `InstancedMeshes`) keeps `inst_rows` (the 12
rows in float64, the two int32 in the bytes of float64 12), `inst`, `tris`,
`p_verts` and `p_norms` in float64, and the node boxes in float32: the BLAS
boxes widened one ulp outward (`bvh.widen`), the TLAS boxes recomputed to
hold every instance below them (`tlas.holding_boxes`).

Walk. One ray per thread (per lane of the plain version). Visiting a pair
node slab-tests both children against [t_min, upper] (upper = the running
best hit, or t_max for the any hit; inclusive, as in the reference), tests
a hit triangle leaf at once (A, then B), and goes on: of two hit node or
instance children, into the nearer for the closest hit (by entry
distance, A on a tie) and into A for the any hit (left first: its t_max
does not shrink, and it measured faster), pushing the other; into the one
hit child; or to the top of the stack. The float64 walk tests the boxes in
float against a float copy of the ray, widened so that it takes every box
a double test takes (`walk._slab_f32`), and takes the nearer child by that
float entry. An instance re-expresses the world ray in its frame (direction
unnormalized, so local t == world t) and enters its BLAS root; a node's
frame is its index (`>= n_tlas` is local), and LIFO order means one local
ray serves. The any-hit walk stops at its first occluder.

Ties. The reference takes, among equal t, the leaf it visits first in
preorder. The walk keeps that choice: a leaf's best row replaces the best
hit on t < best, or on t == best with a smaller key (TLAS leaf rank, packed
row). Packed rows follow BLAS node order, so the key is the preorder visit
order.

`stack_depth` is the exact worst-case depth of the stack: the longest chain
of pushed far children on any path from the root, through the TLAS and into
an instance's BLAS. `walk.launch_plan` places a stack of that depth: in
the shared memory of a 128-ray block, of a smaller block, or past what one
block holds, in a global scratch buffer. No scene is refused.

The plain version repeats the kernels' arithmetic op for op (the kernels
are built with -fmad=false), so the two agree bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import counted
from ..utils.vmath import numpy_real
from . import walk
from .bvh import widen
from .bvh2 import PairNodes, leaf_refs, pair_nodes, pair_stack_depth
from .bvh8 import KIND_INST
from .intersect import Hit
from .tlas import InstancedMeshes, finish_instanced, holding_boxes, packed_leaves
from .walk import _tri_rows

__all__ = [
    "Tlas2Pack",
    "pack_tlas2",
    "tlas2_closest_hit",
    "tlas2_occluded",
    "tlas2_closest_plain",
    "tlas2_occluded_plain",
]

@dataclasses.dataclass(frozen=True)
class Tlas2Pack(PairNodes):
    nodes: torch.Tensor  # (M, 16) f32 child-pair nodes
    inst_rows: torch.Tensor  # (K, 16) by TLAS leaf rank, f32 (f64 in a float64 pack)
    inst: torch.Tensor  # (K, 12) world->local rows by instance id, f32 (f64)
    tris: torch.Tensor  # (L*8, 20) f32 (f64)
    p_verts: torch.Tensor  # (L*8, 3, 3) packed local-space triangles
    p_norms: torch.Tensor  # (L*8, 3, 3)
    n_tlas: int  # pair nodes 0..n_tlas-1 are the TLAS (world space)
    stack_depth: int  # worst-case depth of the walk's stack

    library, two_level = "tlas2", True

    @property
    def nbytes(self) -> int:
        """Bytes of the tables the kernels read."""
        return sum(t.numel() * t.element_size() for t in (self.nodes, self.inst_rows, self.tris))

    def launch_args(self, n: int, device):
        return (self.nodes, self.n_tlas, self.inst_rows, self.tris), walk.pair_stack(self.stack_depth, n, device)

    def finish(self, im, o, d, t_min, out, active) -> Hit:
        return finish_instanced(im, self, o, d, t_min, *out, active)

    def closest_hit(self, im, o, d, t_min, active=None) -> Hit:
        return tlas2_closest_hit(im, self, o, d, t_min, active)

    def occluded(self, im, o, d, t_min, t_max, active=None) -> torch.Tensor:
        return tlas2_occluded(im, self, o, d, t_min, t_max, active)


# ---------------------------------------------------------------------------
# Host pack
# ---------------------------------------------------------------------------


def pack_tlas2(im: InstancedMeshes, device=None) -> Tlas2Pack:
    """An instanced scene's two trees in the kernels' layout (module
    docstring). Every scene fits: `walk.launch_plan` places any stack depth."""
    K = im.inst_inv.shape[0]
    real = im.verts.dtype
    t_lo, t_hi = im.t_min.cpu().numpy(), im.t_max.cpu().numpy()
    b_lo, b_hi = im.b_min.cpu().numpy(), im.b_max.cpu().numpy()
    if real == torch.float64:
        t_lo, t_hi = holding_boxes(im)
        b_lo, b_hi = widen(b_lo, b_hi)
    t_leaf_inst = im.t_leaf_inst.cpu().numpy().astype(np.int64)
    t_leaf = t_leaf_inst >= 0
    rank = np.cumsum(t_leaf) - 1  # TLAS leaf rank, at the leaves
    t_rec, _ = pair_nodes(t_lo, t_hi, im.t_skip.cpu().numpy().astype(np.int64),
                           np.where(t_leaf, rank << 2 | KIND_INST, 0), np.array([0]), 0)
    n_tlas = t_rec.shape[0]

    b_start, b_count, p_verts, p_norms = packed_leaves(im)
    b_skip = im.b_skip.cpu().numpy().astype(np.int64)
    roots = [0]  # one BLAS after another: each root's skip is the next root
    while b_skip[roots[-1]] < b_skip.shape[0]:
        roots.append(int(b_skip[roots[-1]]))
    b_rec, b_pid = pair_nodes(b_lo, b_hi, b_skip, leaf_refs(b_start, b_count), np.array(roots), n_tlas)
    nodes = np.concatenate([t_rec, b_rec])

    # Instance records by TLAS leaf rank: the world->local rows, then the
    # BLAS root's pair node and the instance id.
    inst_of_rank = t_leaf_inst[t_leaf]
    rank_root = b_pid[im.inst_root.cpu().numpy()[inst_of_rank]]
    np_real = numpy_real(real)
    inst_inv = im.inst_inv.cpu().numpy().reshape(K, 12).astype(np_real)
    inst_rows = np.zeros((K, 16), np_real)
    inst_rows[:, :12] = inst_inv[inst_of_rank]
    r = inst_rows.itemsize // 4  # int32 words per real: the ints sit at real 12
    inst_rows.view(np.int32)[:, 12 * r] = rank_root
    inst_rows.view(np.int32)[:, 12 * r + 1] = inst_of_rank

    def t(a, dtype=real):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return Tlas2Pack(
        nodes=t(nodes, torch.float32), inst_rows=t(inst_rows), inst=t(inst_inv), tris=t(_tri_rows(p_verts, np_real)),
        p_verts=t(p_verts),
        p_norms=t(p_norms), n_tlas=n_tlas, stack_depth=pair_stack_depth(nodes.view(np.int32)[:, 12:14], rank_root),
    )


# ---------------------------------------------------------------------------
# Plain torch version (CPU tensors, tests, and the reference on the card)
# ---------------------------------------------------------------------------


def tlas2_closest_plain(pack: Tlas2Pack, o, d, t_min, active=None, stats=None):
    """Plain version of the closest-hit kernel: (t_raw (N,) in the rays'
    type with BIG on a miss, packed triangle id (N,) i32, instance id (N,) i32). `stats`, if
    given, accumulates the counts of `bvh2._pair_walk`."""
    return pack.plain(o, d, t_min, active=active, stats=stats)


def tlas2_occluded_plain(pack: Tlas2Pack, o, d, t_min, t_max, active=None, stats=None):
    """Plain version of the any-hit kernel: True iff some instanced triangle
    lies in [t_min, t_max] along the ray."""
    return pack.plain(o, d, t_min, t_max, active, stats)


# ---------------------------------------------------------------------------
# Wrappers (what SceneData.intersect / occluded call, through the pack)
# ---------------------------------------------------------------------------


@counted(slots=2)
def tlas2_closest_hit(im: InstancedMeshes, pack: Tlas2Pack, o, d, t_min, active=None) -> Hit:
    """Closest hit over every instance (t = inf on a miss, smooth normal,
    material id): `walk.closest_hit`, counted here."""
    return walk.closest_hit(tlas2_closest_hit, im, pack, o, d, t_min, active)


@counted(slots=2)
def tlas2_occluded(im: InstancedMeshes, pack: Tlas2Pack, o, d, t_min, t_max, active=None) -> torch.Tensor:
    """Shadow query over every instance, boolean-equal to
    `tlas2_closest_hit(...).t <= t_max` (`walk.occluded`, counted here)."""
    return walk.occluded(tlas2_occluded, pack, o, d, t_min, t_max, active)
