"""The benchmark's arithmetic: rays, rates, percentiles, the roofline's bytes."""

import types

import numpy as np
import pytest

from portbench import registry
from portbench.frames import Frame
from portbench.rays import rays_per_sample
from portbench.spec import SceneSpec


def test_rays_per_sample_counts_a_shadow_ray_per_light_per_depth():
    assert rays_per_sample(8, 0) == 9
    assert rays_per_sample(5, 2) == 18


@pytest.mark.parametrize("config, rays", [("pegasus_trefoil", 129_600_000)])
def test_frame_rays_of_each_configuration(config, rays):
    from portbench.rays import frame_rays

    spec = registry.builder(config)(registry.config(config))
    assert frame_rays(spec, spec.spp) == rays


def _ctx(frames, **kw):
    base = dict(frames=frames, window_start=0.0, rays_per_frame=1_000_000, traced=(), trace=None, setup_s=3.0,
                stretch_samples=0, launches=None, peak=None, spec=None)
    base.update(kw)
    ctx = types.SimpleNamespace(**base)
    ctx.updates = lambda: [u for f in ctx.frames if f.k not in ctx.traced for u in f.updates]
    return ctx


def _frame(k, start, end, updates=()):
    return Frame(k, 0, start, end, list(updates), np.zeros((1, 3), np.uint8))


def test_rate_is_every_completed_frame_over_the_window_to_its_last_end():
    frames = [_frame(0, 0.0, 0.5), _frame(1, 0.5, 1.5), _frame(2, 1.5, 2.0)]
    assert registry.reader("mrays_per_s")(_ctx(frames)) == pytest.approx(3.0 / 2.0)


def test_percentiles_take_every_update_outside_the_stretch():
    ups = [[0.1] * 9 + [0.3], [0.1] * 9 + [0.5], [9.0] * 10]
    frames = [_frame(k, 0, 1, u) for k, u in enumerate(ups)]
    ctx = _ctx(frames, traced=(2,))
    everything = [u for u in ups[0] + ups[1]]
    assert registry.reader("update_ms_p95")(ctx) == pytest.approx(np.percentile(everything, 95) * 1e3)
    assert registry.reader("update_ms_p50")(ctx) == pytest.approx(100.0)


def test_walk_roofline_bytes_are_the_rays_read_and_the_answers_written():
    walk = registry._module(registry.PACKAGE + "/metrics/walk_roofline_share.py")
    assert walk.bytes_of(10, False, 4) == 10 * (32 + 8)
    assert walk.bytes_of(10, True, 4) == 10 * (32 + 1)
    assert walk.bytes_of(10, False, 8) == 10 * (64 + 12)


def test_walk_roofline_share_of_a_trace():
    from portbench.devtrace import Trace

    us = 1e6
    ops = [("void (anonymous namespace)::bvh8_walk<false>(float4 const*)", 0.0, 40.0),
           ("void (anonymous namespace)::tlas8_walk<true>(float4 const*)", 50.0, 83.0),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 90.0, 100.0),
           ("void at::native::index_elementwise_kernel<128, 4>(int)", 100.0, 110.0)]
    trace = Trace(ops=ops, spans=[], host_ops=[], start=0.0, end=120.0)
    spec = SceneSpec([], [], [], None, width=1000, height=1000, spp=1, max_bounces=0)
    ctx = _ctx([], trace=trace, spec=spec, peak={"hbm_bytes_per_s": 1e12})
    least = (1e6 * 40 + 1e6 * 33) / 1e12
    assert registry.reader("walk_roofline_share")(ctx) == pytest.approx(100 * least / (73 / us))
    assert registry.reader("walk_device_share")(ctx) == pytest.approx(100 * 73 / 93)
    assert registry.reader("elementwise_share")(ctx) == pytest.approx(100 * 10 / 93)
    assert registry.reader("device_idle_share.render")(ctx) == pytest.approx(100 * 27 / 120)


def test_a_split_metric_is_read_by_its_quantity_s_reader():
    assert registry.reader("device_idle_share.render") is registry.reader("device_idle_share")
    assert registry.reader("device_idle_share.update") is registry.reader("device_idle_share")


def test_a_reader_with_nothing_to_read_returns_none():
    ctx = _ctx([])
    for name in ("walk_roofline_share", "walk_device_share", "kernels_per_sample", "elementwise_share",
                 "threefry_launches_per_sample", "device_idle_share.update", "mrays_per_s", "update_ms_p95"):
        assert registry.reader(name)(ctx) is None
