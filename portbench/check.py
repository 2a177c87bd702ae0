"""The comparison that decides `correct`.

Once the window has closed, a sample drawn from the run's seed of the frames
it completed (`frames` of them) is rendered again by the plain reference at
the pixels the harness kept of every frame (`pixels` of them, drawn from the
seed before the window), and each number below is held to its limit
(`checks/<cell>.json`):

- `image_off`: the share of checked pixels whose sRGB bytes differ from the
  reference's by more than 1 in some channel (one level is rounding);
- `image_gap`: |mean of the checked bytes - the reference's| over the
  reference's mean;
- `sums_off` (an entry that returns its buffer): the share of checked pixels
  whose sum or sum of squared magnitudes differs from the reference's by
  more than 1e-4 per sample plus 1e-3 of the reference's value.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.trace import Reference, image_bytes

RTOL, ATOL = 1e-3, 1e-4


def _rng(seed: int, stream: int):
    s = int(seed) % 2 ** 64
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, stream])


def sample_pixels(seed: int, width: int, height: int, n: int) -> np.ndarray:
    rng = _rng(seed, 1)
    return np.sort(rng.choice(width * height, size=min(n, width * height), replace=False))


def sample_frames(seed: int, count: int, n: int) -> list:
    rng = _rng(seed, 2)
    return sorted(rng.choice(count, size=min(n, count), replace=False).tolist())


def numbers(frames: list, refs: list, count: int) -> dict:
    """The compared numbers of program frames against reference renders of
    the same pixels: refs[i] = (sum (P, 3), sum_sq (P,)) as float64 numpy,
    over `count` samples."""
    prog_b = np.concatenate([f.image for f in frames]).astype(np.int64)
    ref_b = np.concatenate([image_bytes(s / max(count, 1)) for s, _ in refs]).astype(np.int64)
    out = {
        "image_off": float((np.abs(prog_b - ref_b).max(-1) > 1).mean()),
        "image_gap": float(abs(prog_b.mean() - ref_b.mean()) / max(ref_b.mean(), 1e-12)),
    }
    if frames[0].sums is not None:
        off = []
        for f, (s, ss) in zip(frames, refs):
            bad_s = np.abs(f.sums - s) > ATOL * count + RTOL * np.abs(s)
            bad_ss = np.abs(f.sum_sq - ss) > ATOL * count + RTOL * np.abs(ss)
            off.append(bad_s.any(-1) | bad_ss)
        out["sums_off"] = float(np.concatenate(off).mean())
    return out


def reference_renders(spec, seeds: list, pixels: np.ndarray, device, dtype=None) -> list:
    """The reference's (sum, sum_sq) at `pixels` of the frame of each seed, as float64."""
    import torch

    ref = Reference(spec, device, dtype or torch.float32)
    out = []
    for seed in seeds:
        s, ss = ref.render(seed, pixels)
        out.append((s.double().cpu().numpy(), ss.double().cpu().numpy()))
    return out


def verdict(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}} of every compared number."""
    return {k: {"value": v, "limit": limits[k], "ok": v <= limits[k]} for k, v in values.items()}
