"""The port's particle ODEs (`rpt_tpu_torch.ode`) against `rpt_tpu.ode`.

The mirrors of `tests/test_ode.py` run the port alone; the rest run both
packages on the same seeded numpy inputs. The port writes out jnp's forms
(integer powers as `integer_pow`, the grid as XLA folds `jnp.linspace`
inside a jitted program, `jnp.hypot`'s scaled form), so most values agree
bit for bit; reductions over particles and XLA's fused multiply-adds leave
a few float32 ulps, and the bars below are set from measured values:

- time derivatives: within 1e-5 of the largest |component| (measured at
  most 8.4e-7 on 25 marbles; 0 on three bodies);
- closest points: within 4e-6 (measured 1.9e-6), the grid bit for bit;
  at 2001 points an argmin near-tie may pick the neighbouring grid point
  (8 of 20,000 measured; bar 0.25%), as close to the point to 1e-6
  (measured 1.7e-7);
- trajectories: within 1e-6 (measured 6.3e-8 on the circle, 6e-8 on
  marbles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpt_tpu.ode as ref_ode
from rpt_tpu.ode.particle import monomial_closest_point as ref_closest
from rpt_tpu_torch import convert
from rpt_tpu_torch.ode import MarblesSystem, ParticleState, SimpleCircleSystem, SolidGravitySystem
from rpt_tpu_torch.ode import particle
from rpt_tpu_torch.ode.particle import monomial_closest_point
from rpt_tpu_torch.scenes import marbles_initial_state

DERIV_RTOL = 1e-5
CLOSEST_ATOL = 4e-6
TRAJ_ATOL = 1e-6


def create(pos, vel=None):
    return ParticleState.create(pos, vel, device="cpu")


def port_state(ref_state):
    return convert.particle_state_from_arrays(np.asarray(ref_state.pos), np.asarray(ref_state.vel), device="cpu")


# ---------------------------------------------------------------------------
# Mirrors of tests/test_ode.py, through the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("time, want", [(2 * np.pi, [1, 0, 0]), (np.pi, [-1, 0, 0])])
def test_rk4_works(time, want):
    out = SimpleCircleSystem().rk4_integrate(create([[1.0, 0.0, 0.0]]), time, 0.005)
    assert np.linalg.norm(out.pos[0].numpy() - want) < 1e-3


def test_on_surface_points():
    surf_h = 1.0
    for x, z in [(0.0, 1.0), (0.0, -1.0), (0.23234, 0.723423), (0.12323, -0.23423)]:
        y = (x**2 + z**2) ** 2 * surf_h
        pt = torch.tensor([x, y, z])
        cp = monomial_closest_point(pt, surf_h).numpy()
        assert np.linalg.norm(cp - pt.numpy()) < 0.03


def test_degenerate_origin():
    cp = monomial_closest_point(torch.tensor([0.0, 0.0, 0.0]), 1.0).numpy()
    np.testing.assert_allclose(cp, [0, 0, 0], atol=1e-9)


def test_grid_optimality():
    surf_h = 1.0
    for x, y in [(0.123, 0.3124), (-0.123, 0.4123), (0.3, -1.0), (-0.7, 2.0)]:
        pt = np.array([x, y, 0.0])
        cp = monomial_closest_point(torch.tensor(pt, dtype=torch.float32), surf_h).numpy()
        d_best = np.linalg.norm(pt - cp)
        xs = np.linspace(-1, 1, 200)
        cands = np.stack([xs, surf_h * xs**4, np.zeros_like(xs)], -1)
        assert d_best <= np.linalg.norm(cands - pt, axis=-1).min() + 5e-3


def test_gravity_momentum_conservation():
    state = create([[1.0, 0.0, 0.0], [-1.0, 0.5, 0.0], [0.0, -0.5, 1.0]],
                   [[0.1, 0.0, 0.0], [0.0, 0.2, 0.0], [0.0, 0.0, -0.3]])
    deriv = SolidGravitySystem().time_derivative(state)
    np.testing.assert_allclose(deriv.vel.sum(0).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(deriv.pos.numpy(), state.vel.numpy())


def test_gravity_two_body_attraction():
    deriv = SolidGravitySystem().time_derivative(create([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]]))
    acc = deriv.vel.numpy()
    expect = 0.25 - 1e-4 / 32.0
    np.testing.assert_allclose(acc[0], [-expect, 0, 0], rtol=1e-5)
    np.testing.assert_allclose(acc[1], [expect, 0, 0], rtol=1e-5)


def test_marbles_finite_trajectory():
    pos = np.random.RandomState(42).randn(6, 3) * 0.3 + np.array([0.0, 2.0, 0.0])
    out = MarblesSystem(radius=0.2).rk4_integrate(create(pos), 1.0 / 16.0, 1.0 / 2000.0)
    assert bool(torch.isfinite(out.pos).all()) and bool(torch.isfinite(out.vel).all())


def test_marbles_gravity_pulls_down():
    deriv = MarblesSystem(radius=0.1).time_derivative(create([[0.0, 5.0, 0.0]]))
    assert float(deriv.vel[0, 1]) < 0.0


# ---------------------------------------------------------------------------
# Against rpt_tpu.ode on the same inputs
# ---------------------------------------------------------------------------


def _bodies(kind):
    rng = np.random.default_rng(5)
    if kind == "three":
        return (np.array([[1.0, 0.0, 0.0], [-1.0, 0.5, 0.0], [0.0, -0.5, 1.0]]),
                np.array([[0.1, 0.0, 0.0], [0.0, 0.2, 0.0], [0.0, 0.0, -0.3]]))
    # 25 marbles in and around the glass, many in contact with it and each other
    return rng.normal(size=(25, 3)) * 0.3 + np.array([0.0, 0.6, 0.0]), rng.normal(size=(25, 3)) * 0.5


@pytest.mark.parametrize("system", ["SimpleCircleSystem", "SolidGravitySystem", "MarblesSystem"])
@pytest.mark.parametrize("bodies", ["three", "marbles"])
def test_time_derivative_matches_reference(system, bodies):
    pos, vel = _bodies(bodies)
    args = (0.15,) if system == "MarblesSystem" else ()
    want = getattr(ref_ode, system)(*args).time_derivative(ref_ode.ParticleState.create(pos, vel))
    got = getattr(particle, system)(*args).time_derivative(create(pos, vel))
    for f in ("pos", "vel"):
        w, g = np.asarray(getattr(want, f), np.float64), getattr(got, f).numpy()
        assert g.dtype == np.float32
        assert np.abs(g - w).max() <= DERIV_RTOL * max(np.abs(w).max(), 1e-30), f


@pytest.mark.parametrize("resolution", [201, 2001])
def test_closest_point_matches_reference(resolution):
    """The grid is the one jnp.linspace gives inside a jitted program (as
    in the reference's scan), bit for bit; the closest points agree with
    the jitted reference (`assert_closest_agree`)."""
    grid = jax.jit(lambda z: z + jnp.linspace(-1.0, 1.0, resolution))(jnp.float32(0.0))
    assert np.array_equal(particle._linspace(resolution, torch.float32, "cpu").numpy(), np.asarray(grid))
    rng = np.random.default_rng(resolution)
    pts = (rng.normal(size=(2000, 3)) * np.array([0.7, 1.0, 0.7]) + np.array([0.0, 0.8, 0.0])).astype(np.float32)
    pts[0] = 0.0
    want = np.asarray(jax.jit(ref_closest, static_argnums=(1, 2))(jnp.asarray(pts), 2.0, resolution))
    got = monomial_closest_point(torch.tensor(pts), 2.0, resolution).numpy()
    assert_closest_agree(pts, got, want)
    # The eager reference builds its grid in another rounding (1 ulp on 53
    # of 201 points); the closest points stay within the same bars.
    if resolution == 201:
        assert_closest_agree(pts, got, np.asarray(ref_closest(jnp.asarray(pts), 2.0, resolution)))


def assert_closest_agree(pts, got, want):
    """Within CLOSEST_ATOL, but for argmin near-ties: two grid points whose
    squared distances round apart in XLA's fused multiply-adds (8 of 20,000
    points at 2001, none at 201). There each package's point is as close as
    the other's to float32 rounding, and such ties stay rare."""
    far = np.abs(got - want.astype(np.float64)).max(-1) > CLOSEST_ATOL
    assert far.mean() <= 0.0025, f"{far.sum()} of {far.size} closest points differ"
    d_got = np.linalg.norm(pts.astype(np.float64) - got, axis=-1)
    d_want = np.linalg.norm(pts.astype(np.float64) - want, axis=-1)
    assert np.abs(d_got - d_want).max() <= 1e-6


@pytest.mark.parametrize("case", ["circle", "marbles6", "marbles25_frame"])
def test_rk4_integrate_matches_reference(case):
    if case == "circle":
        name, sys_args, time, step = "SimpleCircleSystem", (), 2 * np.pi, 0.005
        pos = [[1.0, 0.0, 0.0]]
    elif case == "marbles6":
        name, sys_args, time, step = "MarblesSystem", (0.2,), 1.0 / 16.0, 1.0 / 2000.0
        pos = np.random.RandomState(42).randn(6, 3) * 0.3 + np.array([0.0, 2.0, 0.0])
    else:  # one frame of examples/marbles.py: 1/16 s at 1/10000, packed and in contact
        name, sys_args, time, step = "MarblesSystem", (0.15,), 1.0 / 16.0, 1.0 / 10000.0
        pos = np.random.RandomState(42).randn(25, 3) * 0.3 + np.array([0.0, 2.0, 0.0])
    ref_state = ref_ode.ParticleState.create(pos)
    want = getattr(ref_ode, name)(*sys_args).rk4_integrate(ref_state, time, step)
    got = getattr(particle, name)(*sys_args).rk4_integrate(port_state(ref_state), time, step)
    for f in ("pos", "vel"):
        assert np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f), np.float64)).max() <= TRAJ_ATOL, f


def test_rk4_step_count_and_remainder_are_the_reference():
    """floor(time/step - 1e-12) steps, then one of time - n*step: 624 full
    steps and one of 1e-4 - ulps for a 1/16 s frame at 1/10000."""
    calls = []

    class Recording(SimpleCircleSystem):
        def rk4_step(self, state, step):
            calls.append(step)
            return super().rk4_step(state, step)

    Recording().rk4_integrate(create([[1.0, 0.0, 0.0]]), 1.0 / 16.0, 1.0 / 10000.0)
    n = int(np.floor((1.0 / 16.0) / (1.0 / 10000.0) - 1e-12))
    assert len(calls) == n + 1 == 625
    assert calls[:-1] == [1.0 / 10000.0] * n and calls[-1] == 1.0 / 16.0 - n * (1.0 / 10000.0)


def test_marbles_initial_state_is_the_example():
    st = marbles_initial_state(device="cpu")
    rng = np.random.RandomState(123)
    want = np.stack([np.array([(i // 5) / 5.0 - 0.375, rng.uniform(4.0, 6.0), (i % 5) / 5.0 - 0.375])
                     for i in range(25)]).astype(np.float32)
    assert np.array_equal(st.pos.numpy(), want) and not st.vel.any()


def test_state_arithmetic_matches_reference():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 4, 3)), rng.normal(size=(2, 4, 3))
    ra, rb = ref_ode.ParticleState.create(*a), ref_ode.ParticleState.create(*b)
    pa, pb = create(*a), create(*b)
    for want, got in [(ra + rb, pa + pb), (ra * 0.3, pa * 0.3), (0.3 * ra, 0.3 * pa), (ra / 3.0, pa / 3.0)]:
        assert np.array_equal(got.pos.numpy(), np.asarray(want.pos))
        assert np.array_equal(got.vel.numpy(), np.asarray(want.vel))


def test_create_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ParticleState.create([[0.0, 1.0, 0.0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        marbles_initial_state()
    assert ParticleState.create([[0.0, 1.0, 0.0]], device="cpu").pos.device.type == "cpu"
