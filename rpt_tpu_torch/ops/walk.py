"""What the four traversal families share: the checks of a walk's rays, one
launcher for their eight CUDA entry points, one occupancy query, the
counted dispatch between a kernel and its plain walk by the device of the
rays, and the plain torch form of `csrc/walk.cuh`, which every kernel
includes: the triangle rows, the triangle test, the slab tests and the
instance frame that each plain walk repeats op for op.

A family is its pack type (`ops/bvh8.Bvh8Pack`, `ops/bvh2.Bvh2Pack`,
`ops/tlas8.Tlas8Pack`, `ops/tlas2.Tlas2Pack`), and the type states its own
layout; nothing here names one. A pack gives

- `library`: its kernels' library, `csrc/<library>.cu`, whose entry points
  are `rpt_<library>_closest`, `rpt_<library>_occluded`, each with an
  `_f64` twin, and `rpt_<library>_occupancy` (`kernels._SIGNATURES`);
- `wide`: whether it is walked by node groups (`csrc/group_walk.cuh`, its
  stack in one 128-ray block's shared memory) or by child pairs
  (`csrc/pair_walk.cuh`, its stack placed by `launch_plan`), and
  `two_level`: whether it holds instances (its closest hit also returns
  an instance id);
- `launch_args(n, device)`: the entry point's arguments before the rays
  (its tables and ints) and after the outputs (a pair walk's block, stack
  depth and global stack; nothing for a group walk);
- `plain(o, d, t_min, t_max=None, active=None, stats=None)`: the plain
  torch walk the kernels are held to bit for bit, closest hit without
  `t_max`, any hit with it;
- `finish(geometry, o, d, t_min, out, active)`: the Hit of the closest-hit
  walk's outputs, one level (`bvh.finish_closest`) or two
  (`tlas.finish_instanced`);
- `closest_hit` / `occluded`: its family's two counted wrappers, each one
  call of `closest_hit` / `occluded` below.

Every entry point takes, in this order: the pack's leading arguments; o,
d and the active mask; t_max (any hit only); n and t_min; the outputs (t in
the rays' type, an int32 triangle id and, two-level, an int32 instance id;
or one bool for the any hit); the pack's trailing arguments; the launch
count's address and the stream.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..kernels import launch_counter, load_library
from ..utils.vmath import real_value
from .bvh import _safe_inv, refuse_ray_grad
from .intersect import Hit

__all__ = ["launch", "occupancy", "launch_plan", "closest_hit", "occluded", "check_dtype", "finish_occluded"]

# Dynamic shared memory one block may hold on Hopper (227 KB), and the
# block sizes a pair walk's launch plan tries, largest first.
SMEM_PER_BLOCK = 232448
BLOCKS = (128, 64, 32)
# The rays of a group walk's block: its stack of group_depth levels a ray
# sits in the block's dynamic shared memory.
GROUP_BLOCK = 128
TRI_STRIDE = 20  # floats per triangle row, as in csrc/walk.cuh
_BIG = 3.0e38  # in-kernel miss sentinel
_EPS_PAR = float(np.float32(1e-8))


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _arg(a):
    """A launch argument: an int as it is, a tensor (or None) as its address."""
    return a if isinstance(a, int) else _ptr(a)


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


def launch_plan(stack_depth: int):
    """Where the pair kernels keep a stack of `stack_depth` levels per ray:
    (threads per block, bytes of dynamic shared memory per block, on a
    global scratch buffer?). The first block size of BLOCKS whose stacks
    fit one block's shared memory; past that, a 128-ray block with the
    stack in global memory."""
    for block in BLOCKS:
        smem = block * stack_depth * 4
        if smem <= SMEM_PER_BLOCK:
            return block, smem, False
    return BLOCKS[0], 0, True


def pair_stack(stack_depth: int, n: int, device) -> tuple:
    """A pair kernel's trailing launch arguments over n rays: (block,
    `stack_depth`, global stack or None). The global stack, where the plan
    takes one, is allocated here, `stack_depth` levels per ray of the grid."""
    block, _, on_global = launch_plan(stack_depth)
    if not on_global:
        return block, stack_depth, None
    grid = -(-n // block)
    return block, stack_depth, torch.empty(grid * block * stack_depth, dtype=torch.int32, device=device)


def launch(pack, o, d, t_min, t_max=None, active=None, launches=None):
    """Launch the kernel of `pack`'s library and the rays' type: the closest
    hit without `t_max`, returning (t_raw (N,) in the rays' type, BIG on a
    miss; triangle id (N,) i32[; instance id (N,) i32 two-level]) as the
    plain walk; with it the any hit, a bool (N,). Raises where the kernel
    refuses the launch (a group stack past one block's shared memory).
    `launches`: a launch count's address (`kernels.launch_counter`), or None
    for a launch not counted."""
    lib = load_library(pack.library)
    o, d, active, t_max = _check_rays(pack, o, d, active, t_max)
    n = o.shape[0]
    if t_max is None:
        name = f"rpt_{pack.library}_closest"
        ids = [torch.empty(n, dtype=torch.int32, device=o.device) for _ in range(2 if pack.two_level else 1)]
        outs = [torch.empty(n, dtype=o.dtype, device=o.device), *ids]
        rays = (o, d, active)
    else:
        name = f"rpt_{pack.library}_occluded"
        outs = [torch.empty(n, dtype=torch.bool, device=o.device)]
        rays = (o, d, active, t_max)
    if o.dtype == torch.float64:
        name += "_f64"
    lead, trail = pack.launch_args(n, o.device)
    err = getattr(lib, name)(
        *map(_arg, lead), *map(_ptr, rays), n, real_value(t_min, o.dtype), *map(_ptr, outs), *map(_arg, trail),
        launches, ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    return outs[0] if t_max is not None else tuple(outs)


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


def occupancy(layout, depth: int, occluded: bool, dtype) -> dict:
    """How the kernel of a query (`occluded`) and real type (`dtype`) of the
    pack type `layout` fills the current card at the launch `launch` makes
    for a pack of stack depth `depth` (a group walk's `group_depth`, a pair
    walk's `stack_depth`): the block and its shared stack, on a global
    scratch buffer or not (`launch_plan`), `read_occupancy`'s counts, and
    the shared stack the blocks hold per SM."""
    if layout.wide:
        block, smem, on_global = GROUP_BLOCK, GROUP_BLOCK * depth * 4, False
    else:
        block, smem, on_global = launch_plan(depth)
    kind = int(occluded) | (2 if dtype == torch.float64 else 0) | (4 if on_global else 0)
    query = getattr(load_library(layout.library), f"rpt_{layout.library}_occupancy")
    occ = read_occupancy(query, kind, depth) if layout.wide else read_occupancy(query, kind, block, smem)
    return dict(block=block, smem_bytes=smem, global_stack=on_global, **occ, smem_per_sm=occ["blocks_per_sm"] * smem)


def _on_cpu(o: torch.Tensor) -> bool:
    if o.device.type == "cpu":
        return True
    if o.is_cuda:
        return False
    raise ValueError(f"BVH walk: unsupported device {o.device}")


def real_slot(o) -> int:
    """A traversal wrapper's launch-count slot: 0 for its float32 kernel,
    1 for its float64 one."""
    return 0 if o.dtype == torch.float32 else 1


def ray_t_max(t_max, o) -> torch.Tensor:
    """A scalar or (N,) t_max as an (N,) tensor of the rays' type on their device."""
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=o.dtype, device=o.device), (o.shape[0],))


def finish_occluded(occ, t_max, active) -> torch.Tensor:
    """The any-hit walks' result under the closest-hit rule
    `closest.t <= t_max`: a ray whose t_max is +inf counts as occluded even
    with no hit, since inf <= inf (a directional light's distance is +inf;
    the reference behaves the same); an inactive lane never is."""
    occ = occ | (t_max == math.inf)
    if active is not None:
        occ = occ & active
    return occ


def closest_hit(wrapper, geometry, pack, o, d, t_min, active=None) -> Hit:
    """Closest hit through `pack` (t = inf on a miss and on an inactive
    lane, smooth normal, material id): CUDA rays launch the kernel of the
    pack's type, counted as `wrapper` in slot 0 for float32, 1 for float64;
    CPU rays take the plain walk. Then the pack's finish over `geometry`."""
    refuse_ray_grad(wrapper.__name__, o, d)
    check_dtype(pack, o, d)
    if _on_cpu(o):
        out = pack.plain(o, d, t_min, active=active)
    else:
        out = launch(pack, o, d, t_min, active=active, launches=launch_counter(wrapper, o.device, real_slot(o)))
    return pack.finish(geometry, o, d, t_min, out, active)


def occluded(wrapper, pack, o, d, t_min, t_max, active=None) -> torch.Tensor:
    """Shadow query through `pack`, boolean-equal to
    `closest_hit(...).t <= t_max` (see `finish_occluded`); counted and
    dispatched as `closest_hit`."""
    check_dtype(pack, o, d)
    t_max = ray_t_max(t_max, o)
    if _on_cpu(o):
        occ = pack.plain(o, d, t_min, t_max, active)
    else:
        occ = launch(pack, o, d, t_min, t_max, active, launches=launch_counter(wrapper, o.device, real_slot(o)))
    return finish_occluded(occ, t_max, active)


# ---------------------------------------------------------------------------
# The plain arithmetic of csrc/walk.cuh (every plain walk's)
# ---------------------------------------------------------------------------


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
