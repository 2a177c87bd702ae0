"""The port's sampling draws (`rpt_tpu_torch/sampling.py`) against the JAX
package's (`rpt_tpu/sampling.py`), from the same seeds.

Each draw is held two ways. The uniform numbers under it must equal
`jax.random`'s bit for bit (the port's threefry is JAX's). The results,
which pass those numbers through `sqrt`, `cos` and `sin`, are held to a
stated tolerance: torch's libm and XLA's may round these functions an ulp
apart. In float32 that is 5e-7 absolute on values in [-1, 1] (4 ulps of
1.0; measured: 1 ulp at most). The lifted `z = sqrt(1 - |xy|^2)` of the
hemisphere amplifies a rounding of |xy|^2 near 1 (dz = d(|xy|^2) / 2z), so
z is held through z^2 to 1e-6 and z itself only where z > 0.01, to
1e-6 / z (measured: 2.0e-7 and 1.0e-7 / z). In float64, drawn under
`jax.enable_x64(True)` with 64-bit draws as `tests/test_torch_f64.py`
draws, the bars are 1e-15 and 2e-15 (measured: 1.1e-16 and 3.3e-16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpt_tpu import sampling as ref
from rpt_tpu_torch import random as rnd
from rpt_tpu_torch import sampling

SEEDS = [int(s) for s in np.random.default_rng(15).integers(0, 2**31 - 1, 4)]
SHAPES = [(1000,), (7, 33)]
# (atol of xy and of the circle, atol of z^2 and of z * |dz|) by real type.
BARS = {torch.float32: (5e-7, 1e-6), torch.float64: (1e-15, 2e-15)}


def _keys(seed, dtype):
    """The reference's key and the port's, for a draw of `dtype` (float64
    draws under x64, as the reference makes them there)."""
    x64 = dtype == torch.float64
    return jax.random.PRNGKey(seed), rnd.PRNGKey(seed, x64=x64)


def _ref(fn, seed, shape, dtype):
    with jax.enable_x64(dtype == torch.float64):
        jkey, _ = _keys(seed, dtype)
        out = np.asarray(fn(jkey, shape))
    assert out.dtype == (np.float64 if dtype == torch.float64 else np.float32)
    return out


def _draw(key, shape, dtype, lo=0.0, hi=1.0):
    return rnd.uniform(key, shape, dtype=dtype, minval=lo, maxval=hi, device="cpu")


def _ref_draw(seed, shape, dtype, split=None, lo=0.0, hi=1.0):
    with jax.enable_x64(dtype == torch.float64):
        key, _ = _keys(seed, dtype)
        if split is not None:
            key = jax.random.split(key)[split]
        return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def _assert_disk(got, want, seed, shape, dtype):
    """uniform_disk's draws bit for bit, its points to the bar."""
    _, key = _keys(seed, dtype)
    k1, k2 = rnd.split(key)
    np.testing.assert_array_equal(_draw(k1, shape, dtype).numpy(), _ref_draw(seed, shape, dtype, split=0))
    np.testing.assert_array_equal(_draw(k2, shape, dtype, 0.0, 2.0 * np.pi).numpy(),
                                  _ref_draw(seed, shape, dtype, split=1, lo=0.0, hi=2.0 * jnp.pi))
    np.testing.assert_allclose(got, want, rtol=0, atol=BARS[dtype][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_disk_matches_reference(seed, shape, dtype):
    got = sampling.uniform_disk(_keys(seed, dtype)[1], shape, device="cpu", dtype=dtype)
    assert got.dtype == dtype and tuple(got.shape) == shape + (2,)
    want = _ref(ref.uniform_disk, seed, shape, dtype)
    _assert_disk(got.numpy(), want, seed, shape, dtype)
    assert (np.sum(got.numpy() ** 2, axis=-1) <= 1.0 + BARS[dtype][0]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_circle_matches_reference(seed, shape, dtype):
    got = sampling.uniform_circle(_keys(seed, dtype)[1], shape, device="cpu", dtype=dtype)
    assert got.dtype == dtype and tuple(got.shape) == shape + (2,)
    want = _ref(ref.uniform_circle, seed, shape, dtype)
    # The angle is one draw on the undivided key.
    np.testing.assert_array_equal(_draw(_keys(seed, dtype)[1], shape, dtype, 0.0, 2.0 * np.pi).numpy(),
                                  _ref_draw(seed, shape, dtype, lo=0.0, hi=2.0 * jnp.pi))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BARS[dtype][0])
    np.testing.assert_allclose(np.hypot(got.numpy()[..., 0], got.numpy()[..., 1]), 1.0, atol=4 * BARS[dtype][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_cosine_hemisphere_matches_reference(seed, shape, dtype):
    got = sampling.cosine_hemisphere(_keys(seed, dtype)[1], shape, device="cpu", dtype=dtype).numpy()
    assert got.dtype == (np.float64 if dtype == torch.float64 else np.float32) and got.shape == shape + (3,)
    want = _ref(ref.cosine_hemisphere, seed, shape, dtype)
    # The disk under it, then the lift.
    _assert_disk(got[..., :2], want[..., :2], seed, shape, dtype)
    z, zw = got[..., 2], want[..., 2]
    assert (z >= 0).all()
    np.testing.assert_allclose(z.astype(np.float64) ** 2, zw.astype(np.float64) ** 2, rtol=0, atol=BARS[dtype][1])
    far = zw > 0.01
    assert far.mean() > 0.9
    assert (np.abs(z - zw)[far] * zw[far] <= BARS[dtype][1]).all()
