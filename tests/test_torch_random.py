"""The port's threefry2x32 against `jax.random`: every bit must agree.

`rpt_tpu_torch.random` reproduces JAX's partitionable threefry, so a render
of the port and one of the JAX package with the same seed draw the same
numbers and can be compared pixel by pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpt_tpu_torch import random as rnd

SEEDS = [0, 1, 42, -7, 2**31 - 1]


def test_partitionable_threefry_is_the_default():
    # The port implements the partitionable form only.
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(rnd.PRNGKey(seed), np.asarray(key))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(rnd.split(rnd.PRNGKey(seed), num), np.asarray(jax.random.split(key, num)))
    for data in (0, 5, 123456, 2**31 - 1):
        np.testing.assert_array_equal(rnd.fold_in(rnd.PRNGKey(seed), data), np.asarray(jax.random.fold_in(key, data)))
    # Keys derived from derived keys, as the renderer chains them.
    k2 = jax.random.split(jax.random.fold_in(key, 3), 3)[1]
    t2 = rnd.split(rnd.fold_in(rnd.PRNGKey(seed), 3), 3)[1]
    np.testing.assert_array_equal(t2, np.asarray(k2))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize(
    "shape,minval,maxval",
    [
        ((1000,), 0.0, 1.0),
        ((2, 333), -1.0 / 960.0, 1.0 / 960.0),  # the renderer's pixel jitter
        ((77, 2), 0.0, 2.0 * np.pi),  # `shape + (2,)` as the barycentric sampler draws
        ((500,), 1e-7, 1.0),  # the Beckmann half-vector draw
        ((4, 5, 6), -3.0, 5.5),
    ],
)
def test_uniform(seed, shape, minval, maxval):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32, minval, maxval))
    got = rnd.uniform(rnd.PRNGKey(seed), shape, minval=minval, maxval=maxval, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 6), (0, 1), (-100, 123457), (3, 2**31 - 1)])
def test_randint(seed, lo, hi):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(key, (2000,), lo, hi))
    got = rnd.randint(rnd.PRNGKey(seed), (2000,), lo, hi, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.5, 0.3])
def test_bernoulli(seed, p):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bernoulli(key, p, (1500,)))
    got = rnd.bernoulli(rnd.PRNGKey(seed), p, (1500,), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Tensor keys: (2,) int64 keys on a device, as the captured sample pass
# derives them. They must give the host keys' and jax.random's bits.
# ---------------------------------------------------------------------------


def _tkey(seed):
    return rnd.to_device(rnd.PRNGKey(seed), "cpu")


def _words(k):
    """A tensor key's words as uint32, to compare with jax's raw keys."""
    assert k.dtype == torch.int64
    return k.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_key_split_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_words(_tkey(seed)), np.asarray(key))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(_words(rnd.split(_tkey(seed), num)), np.asarray(jax.random.split(key, num)))
    for data in (0, 5, 123456, 2**31 - 1):
        want = np.asarray(jax.random.fold_in(key, data))
        np.testing.assert_array_equal(_words(rnd.fold_in(_tkey(seed), data)), want)
        # The counter on the device, from a host or a tensor key.
        ctr = torch.tensor([data], dtype=torch.int64)
        np.testing.assert_array_equal(_words(rnd.fold_in(_tkey(seed), ctr)), want)
        np.testing.assert_array_equal(_words(rnd.fold_in(rnd.PRNGKey(seed), ctr[0])), want)
    # Chains, as the renderer and the integrator derive their keys.
    k2 = jax.random.split(jax.random.fold_in(jax.random.split(jax.random.fold_in(key, 3), 3)[2], 1))[0]
    t2 = rnd.split(rnd.fold_in(rnd.split(rnd.fold_in(_tkey(seed), torch.tensor([3])), 3)[2], 1))[0]
    np.testing.assert_array_equal(_words(t2), np.asarray(k2))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize(
    "shape,minval,maxval",
    [
        ((1000,), 0.0, 1.0),
        ((2, 333), -1.0 / 960.0, 1.0 / 960.0),
        ((77, 2), 0.0, 2.0 * np.pi),
        ((500,), 1e-7, 1.0),
        ((4, 5, 6), -3.0, 5.5),
    ],
)
def test_tensor_key_uniform(seed, shape, minval, maxval):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32, minval, maxval))
    got = rnd.uniform(rnd.fold_in(_tkey(seed), 17), shape, minval=minval, maxval=maxval)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 6), (0, 1), (-100, 123457), (3, 2**31 - 1)])
def test_tensor_key_randint(seed, lo, hi):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(key, (2000,), lo, hi))
    got = rnd.randint(_tkey(seed), (2000,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_key_bernoulli(seed):
    key = jax.random.PRNGKey(seed)
    for p in (0.5, 0.3):
        want = np.asarray(jax.random.bernoulli(key, p, (1500,)))
        np.testing.assert_array_equal(rnd.bernoulli(_tkey(seed), p, (1500,)).numpy(), want)


def test_tensor_key_refuses_another_device():
    with pytest.raises(ValueError, match="cannot draw on"):
        rnd.uniform(_tkey(0), (4,), device="meta")


@pytest.mark.parametrize("mode", [rnd.KEYS, rnd.BITS, rnd.UNIFORM, rnd.RANDINT])
def test_threefry_plain_of_host_and_tensor_keys_agree(mode):
    """The plain version of the kernel (what the CPU runs) gives the same
    words for a host key and its tensor key, with and without a counter."""
    kw = {rnd.UNIFORM: dict(lo=-1.0, span=3.0), rnd.RANDINT: rnd._randint_params(-5, 9)}.get(mode, {})
    host = rnd.fold_in(rnd.PRNGKey(9), 4)
    for ctr in (None, torch.tensor([2**32 + 7], dtype=torch.int64)):
        a = rnd.threefry_plain(mode, host, 1001, "cpu", counter=ctr, c0=3, **kw)
        b = rnd.threefry_plain(mode, rnd.to_device(host, "cpu"), 1001, "cpu", counter=ctr, c0=3, **kw)
        assert torch.equal(a, b)


@pytest.mark.parametrize("span", [1, 2, 3, 6, 7, 120000, 2**32 - 1, 2**32, 2**32 + 1, 2**63 - 1, 2**63, 2**64 - 1])
def test_randint64_reciprocal_is_the_remainder(span):
    """The int64 randint kernel's remainder (csrc/threefry.cu `urem`) with
    the host's reciprocal (`random._reciprocal`), emulated step by step in
    Python ints: t = umulhi(x, m), q = (t + ((x - t) >> sh1)) >> sh2, then
    x - q * span, each in 64 bits, equals x % span for the edge values of
    x and 2,000 random 64-bit x."""
    m, sh1, sh2 = rnd._reciprocal(span)
    assert 0 < m < 2**64 and sh1 in (0, 1) and 0 <= sh2 <= 63
    mask = 2**64 - 1
    xs = [0, 1, span - 1, span, 2**63, 2**64 - 1]
    xs += [int(x) for x in np.random.default_rng(0).integers(0, 2**64, 2000, dtype=np.uint64)]
    for x in (x for x in xs if x <= mask):
        t = (x * m) >> 64
        q = (((t + (((x - t) & mask) >> sh1)) & mask) >> sh2) & mask
        assert (x - q * span) & mask == x % span, (x, span)
