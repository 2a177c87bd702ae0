"""The plain reference render of chosen pixels of a frame.

A frame is `spec.spp` samples per pixel of a scene, sample s keyed by
fold_in(PRNGKey(seed), s). One sample of one pixel is one lane: a jittered
camera ray, then up to `max_bounces` bounces of the wavefront estimator
(the environment on a miss; emission plus next-event estimation at every
surface; a sampled continuation weighted f |cos| / pdf), folded back to
front with the per-channel firefly clamp, times the exposure scale. The
port draws every number of a sample over the whole frame's wavefront, in
32x32-tile order, so a lane's numbers are found at its pixel's position in
that order (`tile_position`). A pixel's sums add its samples in order."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import geometry, rng, shading
from portbench.spec import SceneSpec

FIREFLY_CLAMP = 100.0
_PDF_EPS = 1e-10
TILE = 32


def tile_position(width: int, height: int) -> np.ndarray:
    """Each pixel's (row-major index's) position in 32x32-tile order."""
    idx = np.arange(width * height).reshape(height, width)
    order = np.concatenate([idx[y:y + TILE, x:x + TILE].ravel()
                            for y in range(0, height, TILE) for x in range(0, width, TILE)])
    pos = np.empty_like(order)
    pos[order] = np.arange(order.size)
    return pos


def pixel_grid(width: int, height: int):
    """Pixel-center coordinates on the larger side, row 0 at the top, as
    float32 (x, y) per row-major pixel, and the larger side."""
    dim = float(max(width, height))
    x = np.arange(width, dtype=np.float32)
    y = np.arange(height, dtype=np.float32)
    xn = (2.0 * x + 1.0 - width) / dim
    yn = (2.0 * (height - y) - 1.0 - height) / dim
    return np.broadcast_to(xn[None, :], (height, width)).reshape(-1), \
        np.broadcast_to(yn[:, None], (height, width)).reshape(-1), dim


class Reference:
    """A scene's geometry, lights and environment, worked out once from the
    spec, on `device` in `dtype` (float32, or a lower type for the
    control)."""

    def __init__(self, spec: SceneSpec, device, dtype=torch.float32):
        self.spec, self.device, self.dtype = spec, device, dtype
        self.geo = geometry.prepare(spec, device, dtype)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)  # noqa: E731
        self.lights = []
        for light in spec.lights:
            if light.kind == "point":
                self.lights.append(dict(kind="point", color=f(light.color), position=f(light.position)))
            else:
                m = light.matrix
                lin = m[:3, :3]
                self.lights.append(dict(
                    kind="sphere", inv_tf=f(np.linalg.inv(m)[:3, :4]), lin=f(lin), trans=f(m[:3, 3]),
                    nmat=f(np.linalg.inv(lin).T), det=f(np.float32(np.linalg.det(lin))),
                    emitted=f((np.asarray(light.color) * light.emittance).astype(np.float32))))
        self.hdri = None if spec.hdri is None else f(spec.hdri)
        self.env_color = f(spec.env_color)
        self.tile_pos = tile_position(spec.width, spec.height)
        self.xg, self.yg, self.dim = pixel_grid(spec.width, spec.height)

    def _keys(self, seed: int):
        """Per sample: {name: key} of every draw of the sample, as host words."""
        out = []
        for s in range(self.spec.spp):
            k_jit, k_cam, k_trace = rng.split(rng.fold_in(rng.key(seed), s), 3)
            ks = {"jit": k_jit}
            for depth in range(self.spec.max_bounces + 1):
                k_lights, k_bsdf = rng.split(rng.fold_in(k_trace, depth), 2)
                for i in range(len(self.lights)):
                    ks[f"light{i}.{depth}"] = rng.split(rng.fold_in(k_lights, i), 2)
                k_lobe, k_theta, k_phi, k_disk = rng.split(k_bsdf, 4)
                ks.update({f"lobe.{depth}": k_lobe, f"theta.{depth}": k_theta, f"phi.{depth}": k_phi,
                           f"disk.{depth}": rng.split(k_disk, 2)})
            out.append(ks)
        return out

    def render(self, seed: int, pixels: np.ndarray):
        """(sum (P, 3), sum of squared magnitudes (P,)) of a frame's samples
        at the row-major pixels `pixels`, in the reference's type."""
        spec, dev, dt = self.spec, self.device, self.dtype
        spp, n_pix = spec.spp, spec.width * spec.height
        pixels = np.asarray(pixels, np.int64)
        lane = torch.as_tensor(np.tile(self.tile_pos[pixels], spp), device=dev)
        sample = torch.as_tensor(np.repeat(np.arange(spp), pixels.size), device=dev)
        keys = self._keys(seed)

        def lk(name):
            return rng.lane_keys([k[name] for k in keys], sample)

        def lk2(name):
            return tuple(rng.lane_keys([k[name][j] for k in keys], sample) for j in (0, 1))

        jk = lk("jit")
        dim = self.dim
        xg = torch.as_tensor(np.tile(self.xg[pixels], spp), device=dev)
        yg = torch.as_tensor(np.tile(self.yg[pixels], spp), device=dev)
        x = (xg + rng.uniform(jk, lane, -1.0 / dim, 1.0 / dim, torch.float32)).to(dt)
        y = (yg + rng.uniform(jk, lane + n_pix, -1.0 / dim, 1.0 / dim, torch.float32)).to(dt)
        o, d = shading.camera_rays(spec.camera, x, y)
        t_min = float(np.float32(spec.epsilon))
        active = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
        locals_, weights = [], []
        for depth in range(spec.max_bounces + 1):
            t, n, row = geometry.closest(self.geo, o, d, t_min, active)
            found = torch.isfinite(t)
            env = shading.environment(self.hdri, self.env_color, d)
            pos = o + torch.where(found, t, torch.zeros_like(t))[:, None] * d
            wo = -d
            mat = {k: v[row] for k, v in self.geo.materials.items()}
            direct = torch.zeros_like(pos)
            for i, light in enumerate(self.lights):
                intensity, wi, dist = shading.illuminate(light, lk2(f"light{i}.{depth}"), lane, pos)
                visible = ~geometry.occluded(self.geo, pos, wi, t_min, dist, found)
                contrib = shading.bsdf(mat, n, wo, wi) * intensity * geometry.dot(wi, n)[:, None]
                direct = direct + torch.where(visible[:, None], contrib, torch.zeros_like(contrib))
            direct = torch.where(found[:, None], direct, torch.zeros_like(direct))
            emitted = mat["emittance"][:, None] * mat["color"]
            locals_.append(torch.where(found[:, None], emitted + direct, env))
            if depth < spec.max_bounces:
                keys_d = {"lobe": lk(f"lobe.{depth}"), "theta": lk(f"theta.{depth}"), "phi": lk(f"phi.{depth}"),
                          "disk": lk2(f"disk.{depth}")}
                wi, pdf, valid = shading.sample_f(keys_d, lane, mat, n, wo)
                f = shading.bsdf(mat, n, wo, wi)
                ok = found & valid & (pdf > _PDF_EPS)
                w = f * (torch.abs(geometry.dot(wi, n)) / torch.where(ok, pdf, torch.ones_like(pdf)))[:, None]
                weights.append(torch.where(ok[:, None], w, torch.zeros_like(w)))
                o, d, active = pos, wi, ok
        radiance = locals_[-1]
        for depth in range(spec.max_bounces - 1, -1, -1):
            radiance = locals_[depth] + torch.clamp(weights[depth] * radiance, max=FIREFLY_CLAMP)
        value = (radiance * torch.tensor(np.float32(2.0 ** spec.exposure_value), device=dev).to(dt))
        value = value.reshape(spp, pixels.size, 3)
        s = torch.zeros((pixels.size, 3), dtype=dt, device=dev)
        ss = torch.zeros((pixels.size,), dtype=dt, device=dev)
        for k in range(spp):
            s = s + value[k]
            ss = ss + torch.sum(value[k] * value[k], dim=-1)
        return s, ss


def image_bytes(mean) -> np.ndarray:
    """A linear mean color (..., 3) as sRGB bytes: clamped, gamma 1/2.2, rounded."""
    c = np.clip(np.asarray(mean, np.float64), 0.0, 1.0) ** (1.0 / 2.2)
    return np.rint(c * 255.0).astype(np.uint8)
