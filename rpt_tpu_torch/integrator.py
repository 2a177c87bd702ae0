"""Wavefront path-tracing integrator (`rpt_tpu/integrator.py`).

All N rays advance through the bounce depths together. A forward sweep
records each depth's local radiance (emitted + next-event estimation, or
the environment on a miss) and segment weight w_d = f |wi.n| / pdf; a
reverse fold then applies the per-level firefly clamp,

    L_d = local_d + min(w_d * L_{d+1}, FIREFLY_CLAMP)   (per channel),

as the reference's recursion does. Terminated lanes carry zero weight and
stay in the wavefront, masked (`active`).

Each depth's sampled direction, BSDF value and segment weight come from
`ops.scatter.scatter`: one fused kernel on the card, its plain torch version
on the CPU. Under autograd the estimator is the reference's detached one:
each sampled direction and its pdf are constants
(`ops.scatter.stop_gradient`), so a gradient flows through the BSDF's value,
the lights and the camera, never through the sampler (on the card the
kernel samples and torch rebuilds the weight on its samples). The clamp and |wi.n|
differentiate as the reference's `jnp.minimum` and `jnp.abs`
(`utils.vmath`). The traversal kernels give a hit time and a triangle id
with no gradient: a ray that requires grad cannot enter them (see
`ops.bvh.refuse_ray_grad`).

The reference's wavefront sorts are here too (`compact`). From depth 1 on,
the rays handed to `SceneData.intersect` and `occluded` may be permuted:
live lanes first (`True`), grouped by direction octant (`"octant"`), or by
octant and a Morton cell of the origin (`"morton"`), dead lanes last. The
results are permuted back, and RNG draws and shading stay in the original
lane order. A permutation cannot change any lane's hit, so every mode renders
the masked render bit for bit; the choice is about speed only. `_auto_compact`
picks the reference's default: morton wherever a wide kernel walks (a pack
whose type is `wide`), masking elsewhere, `RPT_COMPACT=0|1|octant|morton`
for A/B.

Every step of a sort keeps its sizes fixed and reads nothing back to the
host (the live count stays a tensor), so a sorted pass is captured in a CUDA
graph like the masked one. The permutation's inverse is one scatter of
`arange`, where the reference takes a second argsort (a TPU scatter was
slow); the values are the same.
"""

from __future__ import annotations

import os

import torch

from . import random as rnd
from .kernels import add_count, counted
from .lights import AmbientLightData
from .materials import bsdf
from .ops.intersect import Hit
from .ops.scatter import scatter
from .utils.vmath import dot, minimum

__all__ = ["trace_paths", "sample_lights", "FIREFLY_CLAMP", "COMPACT_MODES"]

FIREFLY_CLAMP = 100.0
# The wavefront orders `compact` takes: masked, live first, octant, morton.
COMPACT_MODES = (False, True, "octant", "morton")


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """perm^-1 by one scatter of arange: inv[perm[i]] = i."""
    return torch.empty_like(perm).scatter_(0, perm, torch.arange(perm.shape[0], device=perm.device))


def _compaction_perm(active: torch.Tensor):
    """Stable live-first partition without a sort: two prefix sums give each
    lane its slot (`pos`), one scatter gives the forward permutation.
    Returns (perm, pos), int64, with sorted[i] = orig[perm[i]] and
    pos = perm^-1."""
    live = active.to(torch.int64)
    n_alive = live.sum()
    pos_alive = torch.cumsum(live, 0) - 1
    pos_dead = n_alive + torch.cumsum(1 - live, 0) - 1
    pos = torch.where(active, pos_alive, pos_dead)
    return _inverse(pos), pos


def _octant(d: torch.Tensor) -> torch.Tensor:
    """Direction octant 0-7 of each ray: the sign bits of dx, dy, dz."""
    neg = (d < 0).to(torch.int32)
    return neg[:, 0] + 2 * neg[:, 1] + 4 * neg[:, 2]


def _octant_perm(d: torch.Tensor, active: torch.Tensor):
    """Stable 9-bucket counting sort of the wavefront: live lanes grouped by
    direction octant, dead lanes last (bucket 8). Returns (perm, pos)."""
    key = _octant(d).to(torch.int64)
    key = torch.where(active, key, torch.full_like(key, 8))
    # One running count over the bucket-major (9, N) one-hot: at (b, i) it
    # is the lanes of the buckets before b plus those of bucket b up to i,
    # so lane i's slot is its value at (key[i], i) less one. (The
    # reference's per-bucket scan down an (N, 9) one-hot took 185 ms at
    # 518,400 rays on an H100, a scan along a short dimension.)
    onehot = key[None, :] == torch.arange(9, device=d.device)[:, None]
    running = torch.cumsum(onehot.reshape(-1).to(torch.int64), 0).reshape(onehot.shape)
    pos = running.gather(0, key[None, :])[0] - 1
    return _inverse(pos), pos


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of an int32 x so consecutive bits land 3 apart
    (the Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_perm(o: torch.Tensor, d: torch.Tensor, active: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Wavefront sort by (direction octant, 7-bit Morton cell of the origin
    in the box lo-hi): the key is octant << 21 | morton21, dead lanes get
    1 << 26, and a stable argsort orders it. Returns (perm, pos)."""
    span = torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp((o - lo) / span * 127.0, 0.0, 127.0).to(torch.int32)
    morton = (_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1) | _part1by2(q[:, 2])
    key = (_octant(d) << 21) | morton
    key = torch.where(active, key, torch.full_like(key, 1 << 26))
    perm = torch.argsort(key, stable=True)
    return perm, _inverse(perm)


def _gather_packed(perm: torch.Tensor, arrays):
    """Rows `perm` of several (N,) / (N, k) tensors by one gather of their
    columns packed side by side as float32 values: bools come back through
    `> 0.5`, ints are exact below 2^24, and every column is rounded through
    float32, as the reference rounds it."""
    cols, specs = [], []
    for a in arrays:
        x = a if a.dtype == torch.float32 else a.to(torch.float32)
        cols.append(x[:, None] if x.dim() == 1 else x)
        specs.append((a.dtype, a.dim()))
    if sum(c.shape[1] for c in cols) % 4 == 0:
        # torch gathers rows of a multiple of 16 bytes with another kernel,
        # which took 0.31 ms for 518,400 rows of 8 floats on an H100 against
        # 0.03 ms for 9 (`chip_smoke.py` `[gather]`): one column of padding.
        cols.append(cols[0].new_zeros((cols[0].shape[0], 1)))
    packed = torch.cat(cols, 1)[perm]
    out, off = [], 0
    for (dt, nd), c in zip(specs, cols):
        sl = packed[:, off:off + c.shape[1]]
        off += c.shape[1]
        sl = sl > 0.5 if dt == torch.bool else sl.to(dt)
        out.append(sl[:, 0] if nd == 1 else sl)
    return out


def _scene_box(scene):
    """Root box of the scene's mesh BVH, else of its TLAS, else the unit box:
    the cells of the morton key."""
    if scene.bvh is not None:
        return scene.bvh.node_min[0], scene.bvh.node_max[0]
    if scene.instanced is not None:
        return scene.instanced.t_min[0], scene.instanced.t_max[0]
    z = torch.zeros(3, dtype=torch.float32, device=scene.device)
    return z, z + 1.0


def _intersect(scene, o, d, t_min, active, compact) -> Hit:
    """scene.intersect with the wavefront ordered as `compact` says: masked
    (False), live first (True), octant-sorted, or morton-sorted with rays
    and hits moved by packed gathers; the hits come back in lane order."""
    if not compact:
        return scene.intersect(o, d, t_min, active=active)
    if compact == "morton":
        lo, hi = _scene_box(scene)
        perm, pos = _morton_perm(o, d, active, lo, hi)
        o_p, d_p, act_p = _gather_packed(perm, (o, d, active))
        hit = scene.intersect(o_p, d_p, t_min, active=act_p)
        t, normal, mat_id = _gather_packed(pos, (hit.t, hit.normal, hit.mat_id))
        return Hit(t=t, normal=normal, mat_id=mat_id)
    perm, pos = _octant_perm(d, active) if compact == "octant" else _compaction_perm(active)
    hit = scene.intersect(o[perm], d[perm], t_min, active=active[perm])
    return Hit(t=hit.t[pos], normal=hit.normal[pos], mat_id=hit.mat_id[pos])


def _auto_compact(scene):
    """The wavefront order of a compiled scene, as the reference chooses it:
    `RPT_COMPACT` when set and not empty (`0`, `1`, `octant`, `morton`),
    else "morton" where a wide kernel walks (a pack whose type is `wide`)
    and masking (False) elsewhere. The reference reads its `bvh8_packed` and
    `instanced8_packed`, so under RPT_BVH_KERNEL=binary it still sorts an
    instanced scene (it keeps the wide two-level pack); the port compiles
    no wide pack then and masks."""
    mode = os.environ.get("RPT_COMPACT")
    if mode is not None and mode != "":
        return mode if mode in ("octant", "morton") else bool(int(mode))
    if any(pack.wide for pack in scene.packs):
        return "morton"
    return False


@counted
def shadow_lanes(found: torch.Tensor) -> None:
    """Count, on the device, the lanes of a shadow wavefront: every lane is
    handed to the any-hit query, live or not."""
    add_count(shadow_lanes, found.device, found.shape[0])


@counted
def shadow_live_lanes(found: torch.Tensor) -> None:
    """Count, on the device, the live lanes of a shadow wavefront: those
    whose path found a surface, the only ones whose answer is read."""
    add_count(shadow_live_lanes, found.device, found.sum())


def _shadow_visible(scene, pos, wi, dist, t_min, found, compact) -> torch.Tensor:
    """Lanes whose shadow ray reaches the light, with the wavefront ordered
    as `compact` says for the any-hit query (as `_intersect` orders it).
    Its lanes and live lanes are counted on the device (`kernels.add_count`)."""
    shadow_lanes(found)
    shadow_live_lanes(found)
    if not compact:
        return ~scene.occluded(pos, wi, t_min, dist, active=found)
    if compact == "morton":
        lo, hi = _scene_box(scene)
        perm, pos_inv = _morton_perm(pos, wi, found, lo, hi)
        o_p, wi_p, dist_p, act_p = _gather_packed(perm, (pos, wi, dist, found))
        occ = scene.occluded(o_p, wi_p, t_min, dist_p, active=act_p)
        return _gather_packed(pos_inv, (~occ,))[0]
    perm, pos_inv = _octant_perm(wi, found) if compact == "octant" else _compaction_perm(found)
    occ = scene.occluded(pos[perm], wi[perm], t_min, dist[perm], active=found[perm])
    return ~occ[pos_inv]


def sample_lights(scene, mat, pos, n, wo, key, t_min, found, compact=False) -> torch.Tensor:
    """Next-event estimation against every light: one shadow ray per (ray,
    light) per bounce; `found` masks the rays that hit a surface; `compact`
    orders the shadow wavefront (see trace_paths)."""
    total = torch.zeros_like(pos)
    for i, light in enumerate(scene.lights):
        if isinstance(light, AmbientLightData):
            # Ambient: color * albedo, no shadow ray.
            total = total + light.color * mat.color
            continue
        intensity, wi, dist = light.illuminate(rnd.fold_in(key, i), pos)
        visible = _shadow_visible(scene, pos, wi, dist, t_min, found, compact)
        contrib = bsdf(mat, n, wo, wi) * intensity * dot(wi, n)[..., None]
        total = total + torch.where(visible[..., None], contrib, torch.zeros_like(contrib))
    return torch.where(found[..., None], total, torch.zeros_like(total))


def trace_paths(scene, o: torch.Tensor, d: torch.Tensor, key, max_bounces: int, t_min: float,
                firefly_clamp: float = FIREFLY_CLAMP, compact=None, want_stats: bool = False):
    """Monte Carlo radiance estimate (N, 3) for N camera rays: environment on
    a miss, emitted + NEE at each vertex, BSDF-sampled continuation, no
    Russian roulette, per-channel firefly clamp on each indirect term.

    `compact`: the order of the wavefronts the traversals see, one of
    COMPACT_MODES, or None for `_auto_compact`'s choice. The depth-0 closest
    hit is never sorted; the depth-0 shadow rays are not sorted under
    "morton" (they keep the camera tiles' coherence) but are under True and
    "octant", as in the reference. Every mode gives the masked result bit
    for bit.
    `want_stats`: also return {"found_frac", "cont_frac"}, per depth the
    share of lanes that hit a surface and the share still alive entering the
    next depth, as tensors on the rays' device (nothing waits for them)."""
    if compact is None:
        compact = _auto_compact(scene)
    locals_per_depth = []
    weights_per_depth = []
    active = None
    found_frac, cont_frac = [], []
    for depth in range(max_bounces + 1):
        k_lights, k_bsdf = rnd.split(rnd.fold_in(key, depth))
        hit = _intersect(scene, o, d, t_min, active, compact if depth > 0 else False)
        found = hit.valid
        env = scene.environment_color(d)

        t_safe = torch.where(found, hit.t, torch.zeros_like(hit.t))
        pos = o + t_safe[:, None] * d
        wo = -d
        mat = scene.materials.gather(hit.mat_id)
        if want_stats:
            found_frac.append(found.float().mean())

        emitted = mat.emittance[:, None] * mat.color
        shadow_compact = False if (depth == 0 and compact == "morton") else compact
        direct = sample_lights(scene, mat, pos, hit.normal, wo, k_lights, t_min, found, compact=shadow_compact)
        locals_per_depth.append(torch.where(found[:, None], emitted + direct, env))

        if depth < max_bounces:
            wi, w, ok = scatter(k_bsdf, mat, hit.normal, wo, found)
            weights_per_depth.append(w)
            o, d, active = pos, wi, ok
            if want_stats:
                cont_frac.append(ok.float().mean())

    radiance = locals_per_depth[-1]
    for depth in range(max_bounces - 1, -1, -1):
        indirect = minimum(weights_per_depth[depth] * radiance, firefly_clamp)
        radiance = locals_per_depth[depth] + indirect
    if want_stats:
        stats = {
            "found_frac": torch.stack(found_frac),
            "cont_frac": torch.stack(cont_frac) if cont_frac else torch.zeros(0, device=o.device),
        }
        return radiance, stats
    return radiance
