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
of `uniform`, `randint` and `bernoulli`) goes through `_threefry` (the
64-bit draws through `_threefry64`, counted apart), which on a CUDA device
launches the hand-written kernel `csrc/threefry.cu` once and on the CPU
runs its plain torch version, `threefry_plain`. The plain version
holds 32-bit words in int64 tensors (torch has few uint32 ops), masked with
`& 0xFFFFFFFF` after every add and rotate.

The draws come in two widths, as `jax.random`'s do with and without
`jax_enable_x64`. A float32 `uniform` and an int32 `randint` take 32 random
bits per element (the xor of the two hashed words); a float64 `uniform` and
an int64 `randint` take 64 (`bits1 << 32 | bits2`,
`_threefry_random_bits_partitionable`): 52 of them as an f64 mantissa, or
two 64-bit streams combined modulo the span in uint64. `split` and
`fold_in` are the same in both: keys stay uint32 pairs.
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
    "threefry_plain", "threefry_kernel", "KEYS", "BITS", "UNIFORM", "RANDINT", "UNIFORM64", "RANDINT64",
]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# What `_threefry` writes for counters c .. c+n-1 (csrc/threefry.cu): both
# hashed words (n, 2) as keys; their xor (n,) as 32 random bits; those bits
# as uniform float32 in [lo, lo + span); `randint`'s combination of two bit
# streams as int32; the 64 bits of both words as uniform float64; the
# 64-bit `randint` as int64.
KEYS, BITS, UNIFORM, RANDINT, UNIFORM64, RANDINT64 = range(6)
_OUT = {KEYS: torch.int64, BITS: torch.int64, UNIFORM: torch.float32, RANDINT: torch.int32,
        UNIFORM64: torch.float64, RANDINT64: torch.int64}


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


def PRNGKey(seed: int, x64: bool = False) -> np.ndarray:
    """Raw host key from an int32 seed (`jax.random.PRNGKey`,
    `threefry_seed`), or with `x64` from an int64 seed as JAX takes it under
    `jax_enable_x64`: its high word then becomes the key's first word (all
    ones for a negative seed, where the int32 key has 0)."""
    seed = int(seed)
    bits = 64 if x64 else 32
    if not -(2 ** (bits - 1)) <= seed < 2 ** (bits - 1):
        raise OverflowError(f"seed {seed} does not fit in int{bits}")
    return np.array([(seed >> 32) & MASK if x64 else 0, seed & MASK], np.uint32)


def to_device(key, device) -> torch.Tensor:
    """The tensor key on `device` of a host key (or of a tensor key)."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64)
    return torch.tensor(np.asarray(key, np.uint32).reshape(2).astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# The hash of a run of counters: plain version and kernel
# ---------------------------------------------------------------------------


def _randint_params(minval: int, maxval: int, bits: int = 32) -> dict:
    """`randint`'s span and multiplier (jax/_src/random.py `_randint`) for
    `bits`-bit draws, as Python ints: the offset is ((hi % span) * mult +
    lo % span) % span, with mult = (2^(bits/2) % span)^2 % span."""
    mask = (1 << bits) - 1
    span = 1 if maxval <= minval else (maxval - minval) & mask
    mult = (1 << (bits // 2)) % span
    return dict(minval=minval, rspan=span, mult=((mult * mult) & mask) % span)


def _reciprocal(rspan: int) -> tuple:
    """(m, sh1, sh2), the multiply-high reciprocal of an unsigned 64-bit
    division by `rspan` in [1, 2^64) (Granlund and Montgomery, PLDI 1994,
    Figure 4.1): with l = ceil(log2 rspan) and t = umulhi(x, m), x // rspan
    is (t + ((x - t) >> sh1)) >> sh2 for every 64-bit x. What the int64
    randint kernel divides by (csrc/threefry.cu `urem`); made once per
    draw."""
    l = (rspan - 1).bit_length()
    return ((1 << 64) * ((1 << l) - rspan)) // rspan + 1, min(l, 1), max(l - 1, 0)


# The int64 sign bit: x ^ _SIGN puts uint64 bits held in int64 in signed order.
_SIGN = -(1 << 63)


def _i64(v: int) -> int:
    """The int64 whose bits are the uint64 `v`."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _urem64(x: torch.Tensor, s: int) -> torch.Tensor:
    """x % s in uint64, for an int64 tensor x holding uint64 bits and a
    Python int s in [1, 2^64), by `%` on values below 2^63: for s < 2^63,
    the remainder of x >> 1 (made unsigned), doubled, plus x's low bit,
    less s where that reaches s; for a larger s, x less s where x >= s
    (both compared unsigned, as the bits' signed order with the sign
    flipped). int64 products and sums wrap as uint64 ones do."""
    if s >= 1 << 63:
        return torch.where((x ^ _SIGN) >= s + _SIGN, x - _i64(s), x)
    r = ((x >> 1) & ~_SIGN) % s * 2 + (x & 1)
    return torch.where((r ^ _SIGN) >= s + _SIGN, r - s, r)


def _two_sum(a, b):
    """Knuth's error-free sum: (s, e) with s = fl(a + b), s + e = a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """Veltkamp's split of a float64 (tensor or Python float) into a high
    and a low half of at most 26 bits each."""
    t = a * 134217729.0  # 2^27 + 1
    hi = t - (t - a)
    return hi, a - hi


def fma64(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a * b + c in one rounding, for a float64 tensor `a` and float64
    scalars (what XLA's contracted `floats * span + lo` and the kernel's
    `__fma_rn` give), from separately rounded torch ops: Dekker's exact
    product, then Boldo and Melquiond's correctly rounded sum of three terms
    by a round-to-odd partial sum (IEEE Trans. Computers 57(4), 2008)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(float(b))
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl  # p + e == a * b exactly
    th, tl = _two_sum(torch.full_like(a, float(c)), p)
    # v = tl + e rounded to odd: a rounded sum with an error left over and an
    # even last bit is moved one ulp toward the exact sum.
    v, w = _two_sum(tl, e)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(w > 0, torch.full_like(v, math.inf), torch.full_like(v, -math.inf))
    v = torch.where((w != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def threefry_plain(mode: int, key, n: int, device, counter=None, c0: int = 0, lo: float = 0.0,
                   span: float = 1.0, minval: int = 0, rspan: int = 1, mult: int = 0) -> torch.Tensor:
    """threefry2x32 under `key` (host or tensor) of the counter pairs
    (0, c + i) for i < n, c = c0 + `counter` (an int64 tensor, or none),
    written as `mode` says (KEYS (n, 2) int64, BITS (n,) int64, UNIFORM (n,)
    float32, RANDINT (n,) int32, UNIFORM64 (n,) float64, RANDINT64 (n,)
    int64). The plain torch version of `threefry_kernel`, and what every
    draw on the CPU runs."""
    if isinstance(key, torch.Tensor):
        k1, k2 = key[0], key[1]
    else:
        k1, k2 = _words(key)
    idx = torch.arange(n, dtype=torch.int64, device=device) + c0
    if counter is not None:
        idx = idx + counter
    idx = idx & MASK
    zero = torch.zeros_like(idx)
    if mode == KEYS:
        return torch.stack(threefry2x32(k1, k2, zero, idx), dim=-1)
    if mode in (RANDINT, RANDINT64):
        (h1, h2), (l1, l2) = (threefry2x32(k1, k2, 0, j) for j in (0, 1))
        if mode == RANDINT:
            b1, b2 = threefry2x32(h1, h2, zero, idx)
            higher = b1 ^ b2
            b1, b2 = threefry2x32(l1, l2, zero, idx)
            lower = b1 ^ b2
            off = ((higher % rspan) * mult) & MASK
            off = (off + lower % rspan) & MASK
            off = off % rspan
            return (minval + off).to(torch.int32)
        # The 64-bit words hi << 32 | lo as the int64 of their bits (hi
        # sign-extended from 32 bits, then scaled: no int64 overflow), each
        # reduced modulo the span in uint64, then combined with uint64
        # wraparound as the kernel does (`_urem64`).
        higher, lower = (_urem64(((w1 ^ 0x80000000) - 0x80000000) * (1 << 32) + w2, rspan)
                         for w1, w2 in (threefry2x32(h1, h2, zero, idx), threefry2x32(l1, l2, zero, idx)))
        return minval + _urem64(higher * _i64(mult) + lower, rspan)
    b1, b2 = threefry2x32(k1, k2, zero, idx)
    if mode == UNIFORM64:
        # The top 52 of the 64 bits b1 << 32 | b2 as a mantissa under
        # exponent 0, minus one, then floats * span + lo in one rounding.
        floats = ((b1 << 20) | (b2 >> 12) | 0x3FF0000000000000).view(torch.float64) - 1.0
        return torch.clamp(fma64(floats, span, lo), min=float(lo))
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
    out = torch.empty((n, 2) if mode == KEYS else (n,), dtype=_OUT[mode], device=device)
    if n == 0:
        return out
    if mode != UNIFORM64:
        lo, span = float(np.float32(lo)), float(np.float32(span))
    lib = load_library("threefry")
    err = lib.rpt_threefry(
        mode, _ptr(kt), k1, k2, _ptr(counter), c0 & MASK, n, _ptr(out), float(lo), float(span), minval, rspan,
        mult, *_reciprocal(rspan), launches, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    return out


def _on_cpu(device: torch.device) -> bool:
    return device.type == "cpu"


@counted(slots=4)
def _threefry(mode: int, key, n: int, device, **kw) -> torch.Tensor:
    """The hash of a run of counters on `device`, in a 32-bit mode (KEYS,
    BITS, UNIFORM, RANDINT): the kernel on a CUDA device (counted, one count
    per mode), the plain version on the CPU."""
    device = _device(device)
    if _on_cpu(device):
        return threefry_plain(mode, key, n, device, **kw)
    return threefry_kernel(mode, key, n, device, launches=launch_counter(_threefry, device, mode), **kw)


@counted(slots=2)
def _threefry64(mode: int, key, n: int, device, **kw) -> torch.Tensor:
    """`_threefry` for the 64-bit draws (UNIFORM64, RANDINT64), counted
    apart: slot 0 the float64 uniform, slot 1 the int64 randint."""
    device = _device(device)
    if _on_cpu(device):
        return threefry_plain(mode, key, n, device, **kw)
    return threefry_kernel(mode, key, n, device, launches=launch_counter(_threefry64, device, mode - UNIFORM64), **kw)


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
    """`jax.random.uniform`: for float32 23 random mantissa bits, for
    float64 (`jax_enable_x64`) 52, under exponent 0, minus one, scaled into
    [minval, maxval) in one rounding."""
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"uniform: float32 or float64, not {dtype}")
    shape = _shape(shape)
    ft = np.float32 if dtype == torch.float32 else np.float64
    lo = ft(minval)
    span = ft(maxval) - lo
    hash_, mode = (_threefry, UNIFORM) if dtype == torch.float32 else (_threefry64, UNIFORM64)
    out = hash_(mode, key, math.prod(shape), _key_device(key, device), lo=float(lo), span=float(span))
    return out.reshape(shape)


def randint(key, shape, minval: int, maxval: int, dtype=torch.int32, device=None) -> torch.Tensor:
    """`jax.random.randint`: two streams of 32 random bits (int32) or, for
    int64 (`jax_enable_x64`), of 64, one under each half of the split key,
    combined modulo the span (jax/_src/random.py `_randint`) with unsigned
    wraparound."""
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    if dtype == torch.int32:
        hash_, mode, kw, bits = _threefry, RANDINT, _randint_params(minval, maxval), 32
    elif dtype == torch.int64:
        hash_, mode, kw, bits = _threefry64, RANDINT64, _randint_params(minval, maxval, 64), 64
    else:
        raise NotImplementedError(f"randint: int32 or int64, not {dtype}")
    if not all(-(2**(bits - 1)) <= v < 2**(bits - 1) for v in (minval, maxval)):
        raise OverflowError(f"randint: bounds must fit in int{bits}")
    return hash_(mode, key, math.prod(shape), _key_device(key, device), **kw).reshape(shape)


def bernoulli(key, p: float = 0.5, shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """`jax.random.bernoulli` (mode 'low'): a uniform of `dtype`, the dtype
    of p in the JAX package, below p."""
    ft = np.float32 if dtype == torch.float32 else np.float64
    return uniform(key, shape, dtype=dtype, device=device) < ft(p)
