"""The device trace of a traced run and its reduction.

`Stretch` runs `torch.profiler` (CUPTI) over a steady stretch of the window
and keeps, in the profiler's one timebase (microseconds), every device
operation (kernels, copies, sets), every span the harness opened with
`span` (what the host was doing: inside the entry, inside the callback,
making the image, between frames) and every top-level torch op. Everything
the per-layer readers need is computed from those lists here: busy time as
the union of the device operations' intervals, idle gaps, time by kernel
name, the traversal kernels' launches."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

HARNESS = "portbench."


@contextlib.contextmanager
def span(name: str):
    """A harness span, `portbench.<name>`, seen by the profiler when it
    runs (a no-op cost otherwise: `record_function` is cheap)."""
    import torch

    with torch.profiler.record_function(HARNESS + name):
        yield


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, float, float]]  # device operations: (name, start us, end us)
    spans: List[Tuple[str, float, float]]  # harness spans
    host_ops: List[Tuple[str, float, float]]  # top-level torch ops on the host
    start: float
    end: float

    def kernels(self):
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))]

    def busy_us(self) -> float:
        busy, last = 0.0, float("-inf")
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e > last:
                busy += e - max(s, last)
                last = e
        return busy

    def gaps(self):
        """(start, end) of every interval of the stretch with no device
        operation running."""
        out, last = [], self.start
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if s > last:
                out.append((last, min(s, self.end)))
            last = max(last, e)
        if self.end > last:
            out.append((last, self.end))
        return [(s, e) for s, e in out if e > s]

    def label(self, t: float) -> str:
        """What the host was doing at time t: the innermost harness span and
        the top-level torch op running then, if any."""
        inner = [s for s in self.spans if s[1] <= t <= s[2]]
        name = min(inner, key=lambda s: s[2] - s[1])[0].removeprefix(HARNESS) if inner else "outside the stretch"
        ops = [o for o in self.host_ops if o[1] <= t <= o[2]]
        return f"{name}: {ops[0][0] if ops else 'host code, no torch op'}"


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments and namespaces:
    `void (anonymous namespace)::bvh8_walk<false>(float4 const*, ...)` -> `bvh8_walk<false>`."""
    for ns in ("(anonymous namespace)::", "at::native::", "binary_internal::", "std::"):
        name = name.replace(ns, "")
    return name.removeprefix("void ").split("(")[0][:160]


def walk_kind(name: str) -> Optional[Tuple[bool, int]]:
    """(any hit?, bytes per real) of a traversal kernel of the port
    (`<family>_walk<kOccl, ...>` or `<family>_walk_f64<kOccl>`), or None."""
    for tag in ("_walk<", "_walk_f64<"):
        if tag in name:
            occl = name.split(tag, 1)[1].startswith("true")
            wide = tag == "_walk_f64<" or "double" in name.split(tag, 1)[1].split(">", 1)[0]
            return occl, 8 if wide else 4
    return None


class Stretch:
    """The profiler over a stretch of frames; `trace` once it has closed."""

    def __init__(self):
        self.trace: Optional[Trace] = None
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._rf = torch.profiler.record_function(HARNESS + "stretch")
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._rf.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = _reduce(self._prof.events())
        return False


def _reduce(events) -> Trace:
    import torch

    ops, spans, host = [], [], []
    for e in events:
        rng = (e.time_range.start, e.time_range.end)
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name.startswith(HARNESS):
            # A harness span is mirrored on the device's timeline as an
            # annotation: that copy is no device operation.
            if not on_device:
                spans.append((e.name, *rng))
        elif on_device:
            ops.append((e.name, *rng))
        elif e.cpu_parent is None and e.name.startswith("aten::"):
            host.append((e.name, *rng))
    stretch = [s for s in spans if s[0] == HARNESS + "stretch"]
    start, end = (stretch[0][1], stretch[0][2]) if stretch else (
        min((o[1] for o in ops), default=0.0), max((o[2] for o in ops), default=0.0))
    return Trace(ops=ops, spans=spans, host_ops=host, start=start, end=end)


def breakdown(trace: Trace, n: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by what the host was doing, in seconds."""
    by_name: dict = {}
    for name, s, e in trace.ops:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:n]
    return {
        "device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]],
        "idle_gaps": [[trace.label(0.5 * (s + e)), (e - s) * 1e-6] for s, e in gaps],
    }


def idle_percent(trace: Trace) -> float:
    """100 x (1 - the union of device operations over the stretch)."""
    return 100.0 * (1.0 - trace.busy_us() / (trace.end - trace.start))


def kernel_percent(trace: Trace, chosen) -> Optional[float]:
    """100 x the device time of the kernels whose name `chosen` accepts over
    the device time of every kernel; None without kernels."""
    kernels = trace.kernels()
    total = sum(e - s for _, s, e in kernels)
    if not total:
        return None
    return 100.0 * sum(e - s for n, s, e in kernels if chosen(n)) / total
