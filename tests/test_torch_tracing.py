"""The port's spans of an entry call (`rpt_tpu_torch.profiling.span`): when
they are recorded, the tree one `render()` or `iterative_render()` records,
the counts they carry, the ring that bounds them, and where they reach
torch's profiler (only inside `profiling.device_trace`)."""

import math
import time

import numpy as np
import pytest
import torch

import rpt_tpu_torch
from rpt_tpu_torch import Camera, Environment, Material, Object, Renderer, Scene, profiling
from rpt_tpu_torch.scenes import procedural_sky, trefoil_mesh

RARE = {"rpt.scene.build", "rpt.graph.capture", "rpt.kernels.load"}
ROOTS = {"render": "rpt.render", "iterative_render": "rpt.iterative_render"}
SPP = 3


def _scene():
    """A small trefoil under a small sky: one mesh object, no transform, so
    the digest's bytes are easy to count."""
    scene = Scene()
    scene.set_environment(Environment.from_hdri(procedural_sky(8)))
    scene.add(Object(trefoil_mesh(30, 6)).material(Material.transparent_colored(rpt_tpu_torch.hex_color(0xF8F8FF),
                                                                                1.31, 0.2)))
    return scene


def _renderer(scene=None):
    camera = Camera.look_at((0.0, 0.5, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 4)
    return Renderer(scene or _scene(), camera, width=16, height=12, max_bounces=2, num_samples=SPP,
                    device="cpu")


def _digest_bytes(scene) -> int:
    """What the digest hashes of `_scene()`: the object's tag, its mesh's
    slot tag, vertices and normals as float64, its material's repr, the
    environment's tag, color as float64 and the map's own bytes."""
    (obj,) = scene.objects
    env = scene.environment
    return (len(b"O") + len(b"m0:") + 8 * (obj.shape.vertices.size + obj.shape.normals.size)
            + len(repr(obj.mat).encode()) + len(b"E") + 8 * 3 + env.hdri.nbytes)


def _leaf_bytes(scene) -> int:
    """What the digest's native hash reads of `_scene()`: the mesh's
    vertices and normals as float64 and the map's own bytes."""
    (obj,) = scene.objects
    return 8 * (obj.shape.vertices.size + obj.shape.normals.size) + scene.environment.hdri.nbytes


def _run(r, entry):
    """One call of `entry`; the image, as the user takes it."""
    if entry == "render":
        return r.render()
    return r.iterative_render(1, lambda i, b: None).image()


def _now():
    return time.perf_counter_ns()


def _since(t0):
    return [s for s in profiling.spans() if s.start_ns >= t0]


def _check_tree(recorded):
    """One root; every span shares its call id and lies inside its parent."""
    by_id = {s.id: s for s in recorded}
    (root,) = [s for s in recorded if s.parent is None]
    for s in recorded:
        assert s.call == root.id
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (p.name, s.name)
    return root, by_id


def _check_image(recorded):
    """`rpt.image`'s children: the tone map on the image's device (its
    `on`), then the copy of its bytes to the host."""
    (image,) = [s for s in recorded if s.name == "rpt.image"]
    children = sorted((s for s in recorded if s.parent == image.id), key=lambda s: s.start_ns)
    assert [s.name for s in children] == ["rpt.image.tonemap", "rpt.image.to_host"]
    tonemap, to_host = children
    assert tonemap.attrs["on"] == "cpu" and tonemap.end_ns <= to_host.start_ns


def test_a_span_is_the_shared_no_op_while_nothing_records():
    assert profiling.span("rpt.render") is profiling.NO_SPAN
    assert profiling.span("rpt.image", bytes=3) is profiling.span("rpt.update") is profiling.NO_SPAN
    with profiling.recording():
        assert isinstance(profiling.span("rpt.render"), profiling.Span)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("rpt.render"), profiling.Span)
    assert profiling.span("rpt.render") is profiling.NO_SPAN
    assert isinstance(profiling.rare_span("rpt.scene.build"), profiling.Span)


@pytest.mark.parametrize("entry", sorted(ROOTS))
def test_an_entry_call_records_its_tree(entry):
    """Off: nothing but rare spans. On: one call's tree (the compile and its
    digest, the passes, the image's tone map and copy), `passes.run`'s `n`
    adding up to the samples, the digest's `bytes` what the scene's arrays
    add up to and its `leaf_bytes` the mesh's and the map's, and the same
    image bit for bit."""
    r = _renderer()
    r.scene_data()  # the build, a rare span, out of the way
    t0 = _now()
    off = _run(r, entry)
    assert all(s.name in RARE for s in _since(t0))

    t0 = _now()
    with profiling.recording():
        on = _run(r, entry)
    assert np.array_equal(on, off)
    recorded = _since(t0)
    _check_image(recorded)
    if entry == "iterative_render":  # the user's image() is a call of its own, after the render's
        image = [s for s in recorded if s.name == "rpt.image"]
        assert len(image) == 1 and image[0].parent is None
        _check_tree([s for s in recorded if s.call == image[0].call])
        recorded = [s for s in recorded if s.call != image[0].call]
    root, by_id = _check_tree(recorded)
    assert root.name == ROOTS[entry]
    names = {s.name for s in recorded}
    assert names >= {"rpt.scene.compile", "rpt.scene.digest", "rpt.passes.run"}
    assert not names & RARE
    parent = {s.name: by_id[s.parent].name for s in recorded if s.parent is not None}
    assert parent["rpt.scene.digest"] == "rpt.scene.compile"
    if entry == "render":
        assert parent["rpt.image"] == "rpt.render"
        assert parent["rpt.image.to_host"] == parent["rpt.image.tonemap"] == "rpt.image"
        assert parent["rpt.passes.run"] == "rpt.render"
    else:
        assert parent["rpt.passes.run"] == parent["rpt.callback"] == parent["rpt.scene.compile"] == "rpt.update"
    assert sum(s.attrs["n"] for s in recorded if s.name == "rpt.passes.run") == SPP
    compiles = [s for s in recorded if s.name == "rpt.scene.compile"]
    assert compiles and all(s.attrs["hit"] for s in compiles)
    digests = [s for s in recorded if s.name == "rpt.scene.digest"]
    assert {s.attrs["bytes"] for s in digests} == {_digest_bytes(r.scene)}
    assert {s.attrs["leaf_bytes"] for s in digests} == {_leaf_bytes(r.scene)}


def test_iterative_render_records_an_update_and_a_callback_per_interval():
    """5 samples at an interval of 2: 3 updates of 2, 2 and 1 samples, each
    with its compile, its passes and its callback."""
    r = _renderer().set_num_samples(5)
    seen = []
    t0 = _now()
    with profiling.recording():
        r.iterative_render(2, lambda i, b: seen.append(i))
    recorded = _since(t0)
    _, by_id = _check_tree(recorded)
    updates = [s for s in recorded if s.name == "rpt.update"]
    assert [s.attrs["iteration"] for s in updates] == seen == [2, 4, 5]
    runs = [s for s in recorded if s.name == "rpt.passes.run"]
    assert [s.attrs["n"] for s in runs] == [2, 2, 1]
    callbacks = [s for s in recorded if s.name == "rpt.callback"]
    assert len(callbacks) == 3
    for u, run, cb in zip(updates, runs, callbacks):
        assert run.parent == cb.parent == u.id and run.end_ns <= cb.start_ns


def test_a_scene_build_is_recorded_always_on_a_miss_only():
    scene = _scene()
    t0 = _now()
    scene.compile(device="cpu")
    scene.compile(device="cpu")
    assert [s.name for s in _since(t0)] == ["rpt.scene.build"]
    scene.add(Object(rpt_tpu_torch.sphere()).material(Material.diffuse(rpt_tpu_torch.hex_color(0x777777))))
    scene.compile(device="cpu")
    assert [s.name for s in _since(t0)] == ["rpt.scene.build"] * 2


def test_the_ring_keeps_the_last_spans():
    t0 = _now()
    with profiling.recording():
        for i in range(profiling.RING + 10):
            with profiling.span("ring", i=i):
                pass
    kept = profiling.spans()
    assert len(kept) == profiling.RING
    assert [s.attrs["i"] for s in kept] == list(range(10, profiling.RING + 10))
    assert all(s.start_ns >= t0 for s in kept)


def _rpt_events(prof):
    return [e for e in prof.events() if e.name.startswith("rpt.")]


def test_a_bare_profiler_sees_no_span_while_the_spans_are_recorded():
    r = _renderer().set_num_samples(1).set_max_bounces(0)  # few torch ops for the profiler
    r.render()
    t0 = _now()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.render()
    assert {s.name for s in _since(t0)} >= {"rpt.render", "rpt.scene.digest", "rpt.passes.run", "rpt.image"}
    assert prof.events() and not _rpt_events(prof)


def test_device_trace_mirrors_every_span_with_its_nesting(tmp_path):
    """Inside `device_trace` each span is also a profiler range of the same
    name, inside the range of its parent span."""
    r = _renderer().set_num_samples(1).set_max_bounces(0)  # few torch ops for the profiler
    r.render()
    t0 = _now()
    with profiling.device_trace(str(tmp_path)) as prof:
        r.render()
    recorded = _since(t0)
    _, by_id = _check_tree(recorded)

    def outer(e):
        e = e.cpu_parent
        while e is not None and not e.name.startswith("rpt."):
            e = e.cpu_parent
        return e.name if e is not None else None

    mirrored = sorted((e.name, outer(e)) for e in _rpt_events(prof))
    spans = sorted((s.name, by_id[s.parent].name if s.parent is not None else None) for s in recorded)
    assert mirrored == spans and len(spans) >= 7
