"""threefry2x32 in plain torch and Python, as `jax.random` draws it with
`jax_threefry_partitionable=True` (Salmon et al., SC 2011; JAX's
`_threefry2x32_lowering`). A key is a pair of uint32 words: host keys are
Python ints, lane keys are int64 tensors holding uint32 values.

The draws the port makes are over whole wavefronts: element c of a draw of
shape (n,) or (2, n) hashes the counter pair (0, c) under the draw's key, so
one lane's numbers follow from its key and its counter alone. The
reference draws them lane by lane (`uniform`)."""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def hash2x32(k1, k2, x1, x2):
    """The two hashed words of the counter pair (x1, x2) under key (k1, k2);
    Python ints or int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r)
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def key(seed: int) -> tuple:
    """`PRNGKey(seed)` of an int32 seed."""
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return 0, seed & MASK


def fold_in(k: tuple, data: int) -> tuple:
    return hash2x32(k[0], k[1], 0, data & MASK)


def split(k: tuple, num: int = 2) -> list:
    return [hash2x32(k[0], k[1], 0, i) for i in range(num)]


def lane_keys(keys: list, which: torch.Tensor) -> tuple:
    """Per-lane key words: lane i takes keys[which[i]]."""
    table = torch.tensor(np.asarray(keys, np.int64).reshape(-1, 2), device=which.device)
    return table[which, 0], table[which, 1]


def uniform(lane_key: tuple, counter: torch.Tensor, minval: float, maxval: float, dtype) -> torch.Tensor:
    """`jax.random.uniform` of float32 at each lane's counter: 23 random
    mantissa bits under exponent 0, minus one, times the span plus the low
    end in one rounding (XLA's fused multiply-add: exact in float64, then
    rounded once), then cast to `dtype`, the reference's real type."""
    b1, b2 = hash2x32(lane_key[0], lane_key[1], torch.zeros_like(counter), counter & MASK)
    bits = b1 ^ b2
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    scaled = (floats.double() * float(span) + float(lo)).float()
    return torch.clamp(scaled, min=float(lo)).to(dtype)
