"""The readers of the port's own spans (`source: program_span`): what each
takes from `rpt_tpu_torch.profiling.spans()`, that spans outside the traced
frame or after the window's start are left out, and None where there is no
trace or no span."""

import types

import numpy as np
import pytest

from portbench import port, registry
from portbench.frames import Frame

READERS = ("compile_ms.render", "compile_ms.update", "tonemap_ms", "digest_mb_per_call", "setup_program_s")
S = 1_000_000_000  # nanoseconds a second


def _span(name, start_s, end_s, **attrs):
    from rpt_tpu_torch.profiling import Span

    s = Span(name, attrs)
    s.start_ns, s.end_ns = int(start_s * S), int(end_s * S)
    return s


def _ctx(frames, traced=(1,), window_start=10.0, trace=True):
    return types.SimpleNamespace(frames=frames, traced=traced, window_start=window_start,
                                 trace=object() if trace else None)


def _frame(k, start, end):
    return Frame(k, 0, start, end, [], np.zeros((1, 3), np.uint8))


@pytest.fixture
def recorded(monkeypatch):
    """Set what `profiling.spans()` returns."""
    from rpt_tpu_torch import profiling

    def put(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))

    return put


FRAMES = [_frame(0, 10.0, 11.0), _frame(1, 11.0, 12.0), _frame(2, 12.0, 13.0)]


def test_the_readers_take_the_traced_frame_s_spans_alone(recorded):
    recorded([
        _span("rpt.scene.build", 1.0, 3.0), _span("rpt.graph.capture", 2.0, 5.0),  # union 4 s
        _span("rpt.kernels.load", 2.5, 2.6, built=False), _span("rpt.graph.capture", 7.0, 7.5),
        _span("rpt.graph.capture", 10.5, 10.7),  # in the window: no set-up
        _span("rpt.scene.compile", 10.1, 10.2, hit=True),  # frame 0, not traced
        _span("rpt.scene.compile", 11.10, 11.14, hit=True), _span("rpt.scene.compile", 11.50, 11.56, hit=True),
        _span("rpt.scene.digest", 11.10, 11.13, bytes=3_000_000),
        _span("rpt.scene.digest", 11.50, 11.55, bytes=5_000_000),
        _span("rpt.scene.digest", 12.1, 12.2, bytes=70_000_000),  # frame 2, not traced
        _span("rpt.image.tonemap", 11.8, 11.9), _span("rpt.image.tonemap", 11.95, 11.97),
        _span("rpt.image.tonemap", 11.99, 12.01),  # runs past the frame's end
    ])
    ctx = _ctx(FRAMES)
    assert registry.reader("compile_ms.render")(ctx) == pytest.approx(50.0)
    assert registry.reader("compile_ms.update")(ctx) == pytest.approx(50.0)
    assert registry.reader("tonemap_ms")(ctx) == pytest.approx(120.0)
    assert registry.reader("digest_mb_per_call")(ctx) == pytest.approx(4.0)
    assert registry.reader("setup_program_s")(ctx) == pytest.approx(4.5)
    assert registry.reader("compile_ms.update") is registry.reader("compile_ms")


@pytest.mark.parametrize("name", READERS)
def test_a_reader_with_no_trace_or_no_span_returns_none(recorded, name):
    recorded([_span("rpt.scene.compile", 5.0, 5.1), _span("rpt.scene.digest", 12.1, 12.2, bytes=1),
              _span("rpt.image.tonemap", 10.1, 10.2), _span("rpt.graph.capture", 10.5, 11.5)])
    assert registry.reader(name)(_ctx(FRAMES)) is None
    recorded([_span("rpt.scene.compile", 11.1, 11.2), _span("rpt.scene.digest", 11.1, 11.2, bytes=1),
              _span("rpt.image.tonemap", 11.1, 11.2), _span("rpt.graph.capture", 5.0, 6.0)])
    assert registry.reader(name)(_ctx(FRAMES)) is not None
    assert registry.reader(name)(_ctx(FRAMES, trace=False)) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent's port records no span and has no `spans()`: every reader
    returns None and raises nothing."""
    from rpt_tpu_torch import profiling

    monkeypatch.delattr(profiling, "spans")
    for name in READERS:
        assert registry.reader(name)(_ctx(FRAMES)) is None


def test_digest_mb_per_call_of_pegasus_trefoil_is_its_configuration_s_bytes():
    """The port's digest of the configuration's scene, recorded and read:
    the mesh's vertices and normals as float64 (2 x segments x sides
    triangles, 9 reals each), the floor's, the sky map's float32 bytes, and
    under a kilobyte of tags, matrices and materials' text."""
    import time

    from rpt_tpu_torch import profiling
    from rpt_tpu_torch.scene import _scene_digest

    cfg = registry.config("pegasus_trefoil")
    scene = port.renderer(registry.builder("pegasus_trefoil")(cfg), "cpu").scene
    start = time.perf_counter()
    with profiling.recording():
        _scene_digest(scene)
    frame = _frame(1, start, time.perf_counter())
    m, sky = cfg["mesh"], cfg["sky"]["height"]
    exact = (2 * m["segments"] * m["sides"] + 2) * 2 * 9 * 8 + sky * 2 * sky * 3 * 4
    got = registry.reader("digest_mb_per_call")(_ctx([frame], window_start=start))
    assert exact / 1e6 <= got <= exact / 1e6 + 0.001
    assert got == pytest.approx(18.85, abs=0.01)
