"""The reference's camera, environment, materials and lights: the renderer's
published estimator (Cook-Torrance / Beckmann reflection with a Lambert
term, a Walter-style rough-dielectric transmission lobe, next-event
estimation of point and emissive-sphere lights, a bilinear equirectangular
environment) in plain torch, one lane per (pixel, sample), every random
number drawn at the lane's own counter (`rng.uniform`).

The formulas and their float32 hardening (sin^2 by a cross product, log-space
D and pdf, clamped exponents) are the port's and the JAX package's; this is
a copy frozen here, written with torch's clamps."""

from __future__ import annotations

import math

import torch

from portbench.reference import rng
from portbench.reference.geometry import cross, dot, normalize

_PI = math.pi
_TINY = 1e-9


def safe_sqrt(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))


def from_local(n, local):
    """A vector in the (t1, t2, n) frame of unit normal n, in world space."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zero = torch.zeros_like(nx)
    t1 = normalize(torch.where((torch.abs(nx) > 1e-12)[..., None], torch.stack([ny, -nx, zero], -1),
                               torch.stack([zero, -nz, ny], -1)))
    t2 = cross(n, t1)
    return local[..., 0:1] * t1 + local[..., 1:2] * t2 + local[..., 2:3] * n


def disk(lane_key_pair, counter, dtype):
    """A uniform point of the unit disk: sqrt(u1) (cos u2, sin u2)."""
    k1, k2 = lane_key_pair
    r = torch.sqrt(rng.uniform(k1, counter, 0.0, 1.0, dtype))
    theta = rng.uniform(k2, counter, 0.0, 2.0 * _PI, dtype)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


def camera_rays(cam, x, y):
    """Origins and unit directions of a pinhole camera (`look_at`) through
    screen coordinates x, y."""
    dt, dev = x.dtype, x.device
    # The frame is made in float32 on the host, as a script's camera is.
    eye, center, up = (torch.tensor(v, dtype=torch.float32) for v in (cam.eye, cam.center, cam.up))
    direction = normalize(center - eye)
    up = normalize(up - dot(up, direction) * direction)
    eye, direction, up = eye.to(dev), direction.to(dev), up.to(dev)
    fov = torch.tensor(cam.fov, dtype=torch.float32, device=dev)
    d = (1.0 / torch.tan(fov / 2.0)).to(dt)
    direction, up = direction.to(dt), up.to(dt)
    right = normalize(cross(direction, up))
    base = d * direction + x[:, None] * right + y[:, None] * up
    return eye.to(dt).expand_as(base), normalize(base)


def environment(hdri, color, d):
    """Radiance from directions d: `color`, or the bilinear lookup of the
    equirectangular map `hdri` (H, W, 3), wrapping in azimuth and clamping
    at the poles."""
    if hdri is None:
        return color.expand_as(d)
    h, w = hdri.shape[0], hdri.shape[1]
    d = normalize(d)
    azimuth = torch.atan2(d[:, 2], d[:, 0]) + _PI
    polar = torch.acos(torch.clamp(d[:, 1], -1.0, 1.0))
    x = azimuth / (2.0 * _PI) * (w - 1)
    y = polar / _PI * (h - 1)
    x0 = torch.clamp(x.to(torch.int32), 0, w - 1).long()
    y0 = torch.clamp(y.to(torch.int32), 0, h - 1).long()
    ax, ay = (x - x0)[:, None], (y - y0)[:, None]
    x1 = (x0 + 1) % w
    y1 = torch.clamp(y0 + 1, max=h - 1)
    top = hdri[y0, x0] * (1 - ax) + hdri[y0, x1] * ax
    bot = hdri[y1, x0] * (1 - ax) + hdri[y1, x1] * ax
    return top * (1 - ay) + bot * ay


def _safe(x, eps=_TINY):
    return torch.where(torch.abs(x) < eps, torch.where(x < 0, -eps, eps).to(x.dtype), x)


def _beckmann_exponent(n, h, m2):
    c = cross(n, h)
    sin2 = torch.clamp(dot(c, c), 0.0, 1.0)
    cos2 = torch.clamp(1.0 - sin2, min=1e-12)
    return torch.clamp(-sin2 / (cos2 * m2), min=-80.0), cos2


def _beckmann_d(n, h, m2):
    expo, cos2 = _beckmann_exponent(n, h, m2)
    return torch.exp(torch.clamp(expo - (torch.log(m2 * _PI) + 2.0 * torch.log(cos2)), max=80.0))


def _beckmann_pdf(n, h, m2):
    expo, cos2 = _beckmann_exponent(n, h, m2)
    return torch.exp(torch.clamp(expo - (torch.log(_PI * m2) + 1.5 * torch.log(cos2)), max=80.0))


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def bsdf(mat: dict, n, wo, wi):
    """The BSDF's value (N, 3) for unit normal n, outgoing wo, incident wi."""
    n_wi, n_wo = dot(n, wi), dot(n, wo)
    wi_out, wo_out = n_wi >= 0.0, n_wo >= 0.0
    transparent = mat["transparent"] > 0.5
    m2 = torch.clamp(mat["roughness"] * mat["roughness"], min=1e-12)
    f0s = ((mat["index"] - 1.0) / (mat["index"] + 1.0)) ** 2
    f0 = f0s[:, None] * (1.0 - mat["metallic"][:, None]) + mat["color"] * mat["metallic"][:, None]

    h = normalize(wi + wo)
    wo_h, n_h = dot(wo, h), dot(n, h)
    d = _beckmann_d(n, h, m2)
    sin_t = safe_sqrt(1.0 - wo_h * wo_h)
    tir = (~wi_out) & (sin_t * mat["index"] > 1.0)
    fres = f0 + (1.0 - f0) * _pow5(1.0 - wo_h)[:, None]
    fres = torch.where(tir[:, None], torch.ones_like(fres), fres)
    g = torch.clamp(2.0 * torch.minimum(n_wi * n_h, n_wo * n_h) / _safe(wo_h), max=1.0)
    spec = (d * g / _safe(4.0 * n_wo * n_wi))[:, None] * fres
    refl = torch.where(transparent[:, None], spec, spec + (1.0 - fres) * mat["color"] / _PI)

    eta_t = torch.where(wo_out, mat["index"], 1.0 / mat["index"])
    h2 = normalize(wi * eta_t[:, None] + wo)
    wi_h2, wo_h2, n_h2 = dot(wi, h2), dot(wo, h2), dot(n, h2)
    d2 = _beckmann_d(n, h2, m2)
    fres2 = f0 + (1.0 - f0) * _pow5(1.0 - torch.abs(wi_h2))[:, None]
    g2 = torch.minimum(torch.abs(n_wi * n_h2), torch.abs(n_wo * n_h2))
    g2 = torch.clamp(2.0 * g2 / _safe(torch.abs(wo_h2)), max=1.0)
    scale = torch.abs(wi_h2 * wo_h2 / _safe(n_wi * n_wo))
    denom = _safe((eta_t * wi_h2 + wo_h2) ** 2)
    refr = (scale * d2 * g2 / denom)[:, None] * (1.0 - fres2) * mat["color"]

    out = torch.where((wi_out == wo_out)[:, None], refl, refr)
    blocked = (~transparent) & ((~wi_out) | (~wo_out))
    return torch.where(blocked[:, None], torch.zeros_like(out), out)


def sample_f(keys: dict, counter, mat: dict, n, wo):
    """(wi, pdf, valid): a lobe picked by a Fresnel estimate, a Beckmann
    half vector for reflection and transmission, a cosine-weighted direction
    for the diffuse lobe. `keys` holds the lane keys `lobe`, `theta`, `phi`
    and the pair `disk`."""
    dt = n.dtype
    m2 = torch.clamp(mat["roughness"] * mat["roughness"], min=1e-12)
    f0s = ((mat["index"] - 1.0) / (mat["index"] + 1.0)) ** 2
    f_est = (1.0 - mat["metallic"]) * f0s + mat["metallic"] * torch.mean(mat["color"], dim=-1)
    f_est = f_est * 0.8 + 0.2
    n_wo = dot(wo, n)
    eta_t = torch.where(n_wo > 0.0, mat["index"], 1.0 / mat["index"])

    u = rng.uniform(keys["theta"], counter, 1e-7, 1.0, dt)
    theta = torch.atan(torch.sqrt(-m2 * torch.log(u)))
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    phi = rng.uniform(keys["phi"], counter, 0.0, 2.0 * _PI, dt)
    h = from_local(n, torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], -1))
    h_wo = dot(h, wo)
    wi_spec = 2.0 * h_wo[:, None] * h - wo

    xy = disk(keys["disk"], counter, dt)
    z = safe_sqrt(1.0 - torch.sum(xy * xy, dim=-1))
    wi_diff = from_local(n, torch.cat([xy, z[:, None]], -1))

    wi_perp = -(wo - h * h_wo[:, None]) / eta_t[:, None]
    sin2_ti = dot(wi_perp, wi_perp)
    wi_trans = -torch.sign(h_wo)[:, None] * safe_sqrt(1.0 - sin2_ti)[:, None] * h + wi_perp

    transparent = mat["transparent"] > 0.5
    pick_spec = rng.uniform(keys["lobe"], counter, 0.0, 1.0, dt) < f_est
    wi = torch.where(pick_spec[:, None], wi_spec, torch.where(transparent[:, None], wi_trans, wi_diff))
    valid = ~((~pick_spec) & transparent & (sin2_ti > 1.0))

    n_wi = dot(wi, n)
    hs = normalize(wi + wo)
    p_spec = f_est * _beckmann_pdf(n, hs, m2) / _safe(4.0 * torch.abs(dot(hs, wo)))
    p_diff = (1.0 - f_est) * torch.clamp(n_wi, min=0.0) / _PI
    ht = normalize(wi * eta_t[:, None] + wo)
    ht_wo, ht_wi = dot(ht, wo), dot(ht, wi)
    jac = torch.abs(ht_wo) / _safe((eta_t * ht_wi + ht_wo) ** 2)
    p_trans = (1.0 - f_est) * _beckmann_pdf(n, ht, m2) * jac
    p_trans = torch.where((n_wo >= 0.0) != (n_wi >= 0.0), p_trans, torch.zeros_like(p_trans))
    return wi, p_spec + torch.where(transparent, p_trans, p_diff), valid


def illuminate(light: dict, key_pair, counter, pos):
    """(intensity (N, 3), unit direction to the light (N, 3), distance (N,))
    of a point light, or of a point drawn on an emissive sphere facing the
    shading point (cosine-weighted on the near hemisphere in the sphere's
    frame, its pdf carried to area measure by the transform)."""
    if light["kind"] == "point":
        disp = light["position"] - pos
        ln = torch.linalg.vector_norm(disp, dim=-1)
        ln_safe = torch.clamp(ln, min=1e-12)
        return light["color"] / (ln_safe * ln_safe)[:, None], disp / ln_safe[:, None], ln
    inv_tf, lin, trans, nmat, det = light["inv_tf"], light["lin"], light["trans"], light["nmat"], light["det"]
    tgt = (inv_tf[None, :, :3] * pos[:, None, :]).sum(-1) + inv_tf[:, 3]
    n = normalize(tgt)
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    zero = torch.zeros_like(nx)
    n1 = normalize(torch.where((torch.abs(nx) > 1e-12)[:, None], torch.stack([ny, -nx, zero], -1),
                               torch.stack([zero, -nz, ny], -1)))
    n2 = cross(n1, n)
    xy = disk(key_pair, counter, pos.dtype)
    z = safe_sqrt(1.0 - torch.sum(xy * xy, -1))
    p_local = xy[:, 0:1] * n1 + xy[:, 1:2] * n2 + z[:, None] * n
    mv = lambda m, v: (m[None] * v[:, None, :]).sum(-1)  # noqa: E731
    v = mv(lin, p_local) + trans
    nrm = normalize(mv(nmat, p_local))
    ph = dot(mv(lin, p_local), nrm)
    pdf = (z / _PI) / (det / torch.where(torch.abs(ph) > 1e-20, ph, torch.full_like(ph, 1e-20)))
    disp = v - pos
    ln = torch.linalg.vector_norm(disp, dim=-1)
    ln_safe = torch.clamp(ln, min=1e-12)
    cosine = torch.clamp(-dot(disp, nrm), min=0.0) / ln_safe
    area = torch.clamp(cosine, min=0.0) / (ln_safe * ln_safe)
    intensity = light["emitted"] * (area / torch.clamp(pdf, min=1e-20))[:, None]
    return intensity, disp / ln_safe[:, None], ln
