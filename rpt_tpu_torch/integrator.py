"""Wavefront path-tracing integrator (`rpt_tpu/integrator.py`, masked path).

All N rays advance through the bounce depths together. A forward sweep
records each depth's local radiance (emitted + next-event estimation, or
the environment on a miss) and segment weight w_d = f |wi.n| / pdf; a
reverse fold then applies the per-level firefly clamp,

    L_d = local_d + min(w_d * L_{d+1}, FIREFLY_CLAMP)   (per channel),

as the reference's recursion does. Terminated lanes carry zero weight and
stay in the wavefront, masked (`active`); the reference's morton, octant and
compaction sorts only reorder the wavefront (bit-identical results) and are
not ported yet.
"""

from __future__ import annotations

import torch

from . import random as rnd
from .lights import AmbientLightData
from .materials import bsdf, sample_f
from .utils.vmath import dot

__all__ = ["trace_paths", "sample_lights", "FIREFLY_CLAMP"]

FIREFLY_CLAMP = 100.0
# Samples with a pdf this small are dropped (measure zero).
_PDF_EPS = 1e-10


def sample_lights(scene, mat, pos, n, wo, key, t_min, found) -> torch.Tensor:
    """Next-event estimation against every light: one shadow ray per (ray,
    light) per bounce; `found` masks the rays that hit a surface."""
    total = torch.zeros_like(pos)
    for i, light in enumerate(scene.lights):
        if isinstance(light, AmbientLightData):
            # Ambient: color * albedo, no shadow ray.
            total = total + light.color * mat.color
            continue
        intensity, wi, dist = light.illuminate(rnd.fold_in(key, i), pos)
        visible = ~scene.occluded(pos, wi, t_min, dist, active=found)
        contrib = bsdf(mat, n, wo, wi) * intensity * dot(wi, n)[..., None]
        total = total + torch.where(visible[..., None], contrib, torch.zeros_like(contrib))
    return torch.where(found[..., None], total, torch.zeros_like(total))


def trace_paths(scene, o: torch.Tensor, d: torch.Tensor, key, max_bounces: int, t_min: float,
                firefly_clamp: float = FIREFLY_CLAMP, want_stats: bool = False):
    """Monte Carlo radiance estimate (N, 3) for N camera rays: environment on
    a miss, emitted + NEE at each vertex, BSDF-sampled continuation, no
    Russian roulette, per-channel firefly clamp on each indirect term.

    `want_stats`: also return {"found_frac", "cont_frac"}, per depth the
    share of lanes that hit a surface and the share still alive entering the
    next depth, as tensors on the rays' device (nothing waits for them)."""
    locals_per_depth = []
    weights_per_depth = []
    active = None
    found_frac, cont_frac = [], []
    for depth in range(max_bounces + 1):
        k_lights, k_bsdf = rnd.split(rnd.fold_in(key, depth))
        hit = scene.intersect(o, d, t_min, active=active)
        found = hit.valid
        env = torch.broadcast_to(scene.env_color, d.shape)

        t_safe = torch.where(found, hit.t, torch.zeros_like(hit.t))
        pos = o + t_safe[:, None] * d
        wo = -d
        mat = scene.materials.gather(hit.mat_id)
        if want_stats:
            found_frac.append(found.float().mean())

        emitted = mat.emittance[:, None] * mat.color
        direct = sample_lights(scene, mat, pos, hit.normal, wo, k_lights, t_min, found)
        locals_per_depth.append(torch.where(found[:, None], emitted + direct, env))

        if depth < max_bounces:
            wi, pdf, valid = sample_f(k_bsdf, mat, hit.normal, wo)
            f = bsdf(mat, hit.normal, wo, wi)
            ok = found & valid & (pdf > _PDF_EPS)
            pdf_safe = torch.where(ok, pdf, torch.ones_like(pdf))
            w = f * (torch.abs(dot(wi, hit.normal)) / pdf_safe)[:, None]
            weights_per_depth.append(torch.where(ok[:, None], w, torch.zeros_like(w)))
            o, d, active = pos, wi, ok
            if want_stats:
                cont_frac.append(ok.float().mean())

    radiance = locals_per_depth[-1]
    for depth in range(max_bounces - 1, -1, -1):
        indirect = torch.clamp(weights_per_depth[depth] * radiance, max=firefly_clamp)
        radiance = locals_per_depth[depth] + indirect
    if want_stats:
        stats = {
            "found_frac": torch.stack(found_frac),
            "cont_frac": torch.stack(cont_frac) if cont_frac else torch.zeros(0, device=o.device),
        }
        return radiance, stats
    return radiance
