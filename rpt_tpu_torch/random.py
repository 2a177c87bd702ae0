"""Counter-based threefry2x32 PRNG, bit for bit equal to `jax.random`.

The JAX package draws every random number from `jax.random` threefry keys
(with `jax_threefry_partitionable=True`, the jax 0.9 default). Reproducing
the same bits here lets a render of the port and of the JAX package with the
same seed be compared pixel by pixel, not only in distribution.

A key takes one of two forms:

- a host key, a numpy uint32 array of shape (2,) as JAX's raw keys are.
  `PRNGKey`, `split` and `fold_in` of a host key run in plain Python
  integers and never touch a device;
- a tensor key, a (2,) int64 tensor holding the two uint32 words on some
  device (`to_device`). `split` and `fold_in` of a tensor key return tensor
  keys on its device, and `fold_in` also takes a counter that lives on the
  device (an int64 tensor). Nothing about a tensor key is read on the host,
  so a CUDA graph that derives its keys this way draws new numbers on every
  replay.

Every hash of a tensor (a tensor key's `split` / `fold_in`, every bulk draw
of `uniform`, `randint` and `bernoulli`) goes through `_threefry`, which on
a CUDA device launches the hand-written kernel `csrc/threefry.cu` once and on
the CPU runs its plain torch version, `threefry_plain`. The plain version
holds 32-bit words in int64 tensors (torch has few uint32 ops), masked with
`& 0xFFFFFFFF` after every add and rotate.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Union

import numpy as np
import torch

from .kernels import counted, launch_counter

__all__ = [
    "PRNGKey", "split", "fold_in", "uniform", "randint", "bernoulli", "threefry2x32", "to_device",
    "threefry_plain", "threefry_kernel", "KEYS", "BITS", "UNIFORM", "RANDINT",
]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# What `_threefry` writes for counters c .. c+n-1 (csrc/threefry.cu): both
# hashed words (n, 2) as keys; their xor (n,) as 32 random bits; those bits
# as uniform float32 in [lo, lo + span); `randint`'s combination of two bit
# streams as int32.
KEYS, BITS, UNIFORM, RANDINT = range(4)


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (jax/_src/prng.py `_threefry2x32_lowering`).

    `k1`, `k2`, `x1`, `x2` are Python ints or int64 tensors holding uint32
    values (broadcast together). Returns the two hashed words in that form.
    """
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


def _words(key) -> tuple:
    k = np.asarray(key, np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(shape)


def PRNGKey(seed: int) -> np.ndarray:
    """Raw host key from an int32 seed (`jax.random.PRNGKey`, `threefry_seed`)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return np.array([0, seed & MASK], np.uint32)


def to_device(key, device) -> torch.Tensor:
    """The tensor key on `device` of a host key (or of a tensor key)."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64)
    return torch.tensor(np.asarray(key, np.uint32).reshape(2).astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# The hash of a run of counters: plain version and kernel
# ---------------------------------------------------------------------------


def _randint_params(minval: int, maxval: int) -> dict:
    """`randint`'s span and multiplier (jax/_src/random.py `_randint`), as
    Python ints: the offset is ((hi % span) * mult + lo % span) % span."""
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    mult = (2**16) % span
    return dict(minval=minval, rspan=span, mult=((mult * mult) & MASK) % span)


def threefry_plain(mode: int, key, n: int, device, counter=None, c0: int = 0, lo: float = 0.0,
                   span: float = 1.0, minval: int = 0, rspan: int = 1, mult: int = 0) -> torch.Tensor:
    """threefry2x32 under `key` (host or tensor) of the counter pairs
    (0, c + i) for i < n, c = c0 + `counter` (an int64 tensor, or none),
    written as `mode` says (KEYS (n, 2) int64, BITS (n,) int64, UNIFORM (n,)
    float32, RANDINT (n,) int32). The plain torch version of
    `threefry_kernel`, and what every draw on the CPU runs."""
    if isinstance(key, torch.Tensor):
        k1, k2 = key[0], key[1]
    else:
        k1, k2 = _words(key)
    idx = torch.arange(n, dtype=torch.int64, device=device) + c0
    if counter is not None:
        idx = idx + counter
    idx = idx & MASK
    if mode == KEYS:
        return torch.stack(threefry2x32(k1, k2, torch.zeros_like(idx), idx), dim=-1)
    if mode == RANDINT:
        (h1, h2), (l1, l2) = (threefry2x32(k1, k2, 0, j) for j in (0, 1))
        b1, b2 = threefry2x32(h1, h2, torch.zeros_like(idx), idx)
        higher = b1 ^ b2
        b1, b2 = threefry2x32(l1, l2, torch.zeros_like(idx), idx)
        lower = b1 ^ b2
        off = ((higher % rspan) * mult) & MASK
        off = (off + lower % rspan) & MASK
        off = off % rspan
        return (minval + off).to(torch.int32)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(idx), idx)
    bits = b1 ^ b2
    if mode == BITS:
        return bits
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # XLA contracts `floats * span + lo` into one fused multiply-add. The
    # product of two f32 values is exact in f64, so one f64 add and the cast
    # back reproduce the single rounding of the FMA.
    scaled = (floats.double() * float(span) + float(lo)).float()
    return torch.clamp(scaled, min=float(lo))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _device(device) -> torch.device:
    """`device` as a torch.device with its index ("cuda" is the current card)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def threefry_kernel(mode: int, key, n: int, device, counter=None, c0: int = 0, lo: float = 0.0,
                    span: float = 1.0, minval: int = 0, rspan: int = 1, mult: int = 0,
                    launches=None) -> torch.Tensor:
    """Launch csrc/threefry.cu: `threefry_plain`'s result on a CUDA device,
    in one launch. A tensor key and the counter are read from device memory
    by the kernel; a host key goes in as two immediates. `launches`: a
    launch count's address (`kernels.launch_counter`), or None for a launch
    not counted."""
    from .kernels import load_library

    device = _device(device)
    if device.type != "cuda":
        raise ValueError("the threefry kernel needs a CUDA device")
    if not 0 <= n < 2**32:
        raise ValueError(f"threefry: {n} counters do not fit in 32 bits")
    kt = None
    if isinstance(key, torch.Tensor):
        if key.device != device or key.dtype != torch.int64 or key.shape != (2,):
            raise ValueError("a tensor key must be a (2,) int64 tensor on the draw's device")
        kt, k1, k2 = key.contiguous(), 0, 0
    else:
        k1, k2 = _words(key)
    if counter is not None and (counter.device != device or counter.dtype != torch.int64 or counter.numel() != 1):
        raise ValueError("the counter must be one int64 on the draw's device")
    shape, dtype = {KEYS: ((n, 2), torch.int64), BITS: ((n,), torch.int64), UNIFORM: ((n,), torch.float32),
                    RANDINT: ((n,), torch.int32)}[mode]
    out = torch.empty(shape, dtype=dtype, device=device)
    if n == 0:
        return out
    lib = load_library("threefry")
    err = lib.rpt_threefry(
        mode, _ptr(kt), k1, k2, _ptr(counter), c0 & MASK, n, _ptr(out), float(np.float32(lo)),
        float(np.float32(span)), minval, rspan, mult, launches,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    return out


def _on_cpu(device: torch.device) -> bool:
    return device.type == "cpu"


@counted(slots=4)
def _threefry(mode: int, key, n: int, device, **kw) -> torch.Tensor:
    """The hash of a run of counters on `device`: the kernel on a CUDA
    device (counted, one count per mode), the plain version on the CPU."""
    device = _device(device)
    if _on_cpu(device):
        return threefry_plain(mode, key, n, device, **kw)
    return threefry_kernel(mode, key, n, device, launches=launch_counter(_threefry, device, mode), **kw)


def _key_device(key, device):
    """The device a draw lands on: a tensor key's own (which `device`, if
    given, must name), else `device` (the CPU when None)."""
    if isinstance(key, torch.Tensor):
        if device is not None and _device(device) != key.device:
            raise ValueError(f"a tensor key on {key.device} cannot draw on {device}")
        return key.device
    return _device(device)


# ---------------------------------------------------------------------------
# jax.random's functions
# ---------------------------------------------------------------------------


def split(key, num: Union[int, Sequence[int]] = 2):
    """`jax.random.split` (partitionable form: hash of a 64-bit iota)."""
    shape = _shape(num)
    if isinstance(key, torch.Tensor):
        return _threefry(KEYS, key, math.prod(shape), key.device).reshape(shape + (2,))
    k1, k2 = _words(key)
    out = [threefry2x32(k1, k2, i >> 32, i & MASK) for i in range(math.prod(shape))]
    return np.array(out, np.uint32).reshape(shape + (2,))


def fold_in(key, data):
    """`jax.random.fold_in`: hash of the counter pair (0, data). `data` is
    an int, or an int64 tensor on the key's device (then the key may be a
    host key, which is moved there); either gives a tensor key when the key
    or the data is a tensor."""
    if isinstance(data, torch.Tensor):
        if not isinstance(key, torch.Tensor):
            key = to_device(key, data.device)
        return _threefry(KEYS, key, 1, key.device, counter=data.reshape(1)).reshape(2)
    if isinstance(key, torch.Tensor):
        return _threefry(KEYS, key, 1, key.device, c0=int(data) & MASK).reshape(2)
    k1, k2 = _words(key)
    return np.array(threefry2x32(k1, k2, 0, int(data) & MASK), np.uint32)


def _random_bits(key, shape: tuple, device) -> torch.Tensor:
    """32 random bits per element as int64 (`_threefry_random_bits_partitionable`)."""
    device = _key_device(key, device)
    return _threefry(BITS, key, math.prod(shape), device).reshape(shape)


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0, device=None) -> torch.Tensor:
    """`jax.random.uniform` for float32: 23 random mantissa bits under
    exponent 0, minus one, scaled into [minval, maxval)."""
    if dtype != torch.float32:
        raise NotImplementedError("uniform: float32 only")
    shape = _shape(shape)
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    out = _threefry(UNIFORM, key, math.prod(shape), _key_device(key, device), lo=float(lo), span=float(span))
    return out.reshape(shape)


def randint(key, shape, minval: int, maxval: int, device=None) -> torch.Tensor:
    """`jax.random.randint` for int32: two 32-bit streams (the key split in
    two) combined modulo the span (jax/_src/random.py `_randint`), with
    uint32 wraparound."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    if not (-(2**31) <= minval < 2**31 and -(2**31) <= maxval < 2**31):
        raise OverflowError("randint: bounds must fit in int32")
    out = _threefry(RANDINT, key, math.prod(shape), _key_device(key, device), **_randint_params(minval, maxval))
    return out.reshape(shape)


def bernoulli(key, p: float = 0.5, shape=(), device=None) -> torch.Tensor:
    """`jax.random.bernoulli` (mode 'low'): uniform < p."""
    return uniform(key, shape, device=device) < np.float32(p)
