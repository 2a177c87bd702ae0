"""`color_bytes` on a floating tensor maps it on the tensor's own device
through exact threshold tables (`rpt_tpu_torch.color.byte_thresholds`) and
copies only the bytes: the tables against the numpy map they come from, the
tensor path against the numpy path and the JAX package's `color_bytes` bit
for bit, on every kind of value and layout, and the spans each path records.
The tensors here live on the CPU; `tests/test_torch_cuda.py` holds the card."""

import time

import numpy as np
import pytest
import torch

from rpt_tpu.color import color_bytes as ref_color_bytes
from rpt_tpu_torch import Buffer, Filter, color_bytes, profiling
from rpt_tpu_torch.color import byte_thresholds

TYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]
IDS = ["f32", "f64"]


def _numpy(x: np.ndarray) -> np.ndarray:
    """The numpy path (and the reference), NaN's cast warning silenced."""
    with np.errstate(invalid="ignore"):
        ours, ref = color_bytes(x), ref_color_bytes(x)
    assert np.array_equal(ours, ref)
    return ours


def _recorded(fn):
    """`fn()`'s result and the spans it records, oldest first."""
    t0 = time.perf_counter_ns()
    with profiling.recording():
        out = fn()
    return out, [s for s in profiling.spans() if s.start_ns >= t0]


@pytest.mark.parametrize("np_t,_", TYPES, ids=IDS)
def test_each_threshold_is_the_first_value_of_its_byte(np_t, _):
    """byte(t_k) == k and byte(the value below t_k) == k - 1, k = 1..255."""
    t, nan_byte = byte_thresholds(np_t)
    k = np.arange(1, 256)
    assert t.dtype == np_t and t.shape == (255,) and t[0] > 0 and np.all(np.diff(t) > 0)
    assert np.array_equal(_numpy(t), k)
    assert np.array_equal(_numpy(np.nextafter(t, np_t(-np.inf))), k - 1)
    assert nan_byte == int(_numpy(np.array([np.nan], np_t))[0])


def _values(np_t) -> np.ndarray:
    """1 M seeded random bit patterns in [-0.5, 2], 1 M values uniform in
    [-0.5, 2], subnormals, signed zeros and infinities, NaNs, 1.0, and the
    values on each side of every threshold."""
    rng = np.random.default_rng(28)
    finfo = np.finfo(np_t)
    u = np.dtype(f"u{finfo.bits // 8}")
    sign = np.array(-0.0, np_t).view(u)
    top = {True: np.array(2.0, np_t).view(u), False: np.array(0.5, np_t).view(u) | sign}
    pos = rng.integers(0, top[True], 500_000, dtype=u, endpoint=True)
    neg = rng.integers(sign, top[False], 500_000, dtype=u, endpoint=True)
    bits = np.concatenate([pos, neg]).view(np_t)
    uniform = rng.uniform(-0.5, 2.0, 1_000_000).astype(np_t)
    sub = np.array([finfo.smallest_subnormal, finfo.smallest_normal - finfo.smallest_subnormal], np_t)
    t, _ = byte_thresholds(np_t)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, finfo.max, finfo.min], np_t)
    edges = [np.nextafter(t, np_t(-np.inf)), t, np.nextafter(t, np_t(np.inf))]
    return np.concatenate([bits, uniform, sub, -sub, special, *edges])


@pytest.mark.parametrize("np_t,torch_t", TYPES, ids=IDS)
def test_the_tensor_path_gives_the_numpy_path_s_bytes(np_t, torch_t):
    x = _values(np_t)
    got = color_bytes(torch.from_numpy(x))
    assert got.dtype == np.uint8 and np.array_equal(got, _numpy(x))


@pytest.mark.parametrize("np_t,torch_t", TYPES, ids=IDS)
def test_shapes_and_layouts(np_t, torch_t):
    """An (H, W, 3) image, a permuted view of one, a single (3,) color and
    a filtered `Buffer.image` (a strided mean) on the tensor path."""
    g = torch.Generator().manual_seed(5)
    img = torch.rand((9, 13, 3), generator=g, dtype=torch_t) * 1.4 - 0.2
    view = img.permute(1, 0, 2)
    assert not view.is_contiguous()
    for x in (img, view, img[4, 7], img[..., 1]):
        got = color_bytes(x)
        assert got.shape == tuple(x.shape) and np.array_equal(got, _numpy(x.numpy()))
    buf = Buffer(sum=img * 3.0, sum_sq=(img * img).sum(-1) * 3.0, count=3)
    for f in (Filter(), Filter.box(1)):
        assert np.array_equal(buf.image(f), _numpy(buf.mean_image(f).numpy()))


@pytest.mark.parametrize("torch_t", [torch.float16, torch.bfloat16], ids=["f16", "bf16"])
def test_half_types_take_the_float32_table(torch_t):
    """float16 and bfloat16 widen exactly to float32: their bytes are the
    numpy path's on the widening, the span says where they were mapped."""
    x = torch.from_numpy(_values(np.float32)[::7].copy()).to(torch_t)
    got, recorded = _recorded(lambda: color_bytes(x))
    assert np.array_equal(got, _numpy(x.float().numpy()))
    (tonemap,) = [s for s in recorded if s.name == "rpt.image.tonemap"]
    assert tonemap.attrs["on"] == "cpu"


@pytest.mark.parametrize("np_t,torch_t", TYPES, ids=IDS)
def test_the_tensor_path_maps_then_copies_the_bytes(np_t, torch_t):
    """`rpt.image.tonemap` (on the tensor's device) ends before
    `rpt.image.to_host` starts, which copies one byte a channel."""
    x = torch.rand((6, 5, 3), dtype=torch_t)
    _, recorded = _recorded(lambda: color_bytes(x))
    assert [s.name for s in recorded] == ["rpt.image.tonemap", "rpt.image.to_host"]
    tonemap, to_host = recorded
    assert tonemap.attrs == {"on": "cpu"} and to_host.attrs == {"bytes": 6 * 5 * 3}
    assert tonemap.end_ns <= to_host.start_ns


@pytest.mark.parametrize("kind", ["ndarray", "list", "int_tensor"])
def test_other_inputs_take_the_numpy_path(kind):
    """Array-likes, and tensors of a type without a table, keep the numpy
    map: a tensor is copied first, and the span says `on="numpy"`."""
    base = np.array([[-1.0, 0.0, 0.25], [0.5, 1.0, 3.0]])
    color = {"ndarray": base, "list": base.tolist(), "int_tensor": torch.tensor([[0, 1, 2], [1, 0, 1]])}[kind]
    got, recorded = _recorded(lambda: color_bytes(color))
    want = _numpy(color.numpy() if kind == "int_tensor" else base)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8 and np.array_equal(got, want)
    names = [s.name for s in recorded]
    assert names == (["rpt.image.to_host"] if kind == "int_tensor" else []) + ["rpt.image.tonemap"]
    assert recorded[-1].attrs == {"on": "numpy"}
