"""One run of one cell: set-up, the measured window, the metrics, the check.

`run_cell` is what `python3 -m portbench.run` calls on the card; the CPU
tests call it on the CPU at a tiny size (`device="cpu"`, no trace), where
it reports no metric at all, since a CPU run measures no device."""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from typing import Optional

from portbench import check, devtrace, frames as fr, port, registry, rays

# Caches that a run's libraries may fill, at fixed places inside the
# checkout (ignored by git), so that only a checkout's first run builds.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def set_cache_dirs() -> None:
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(registry.PACKAGE, "_cache", sub)


@dataclasses.dataclass
class Context:
    """What a metric's reader reads (`metrics/<name>.py` `read(ctx)`)."""

    spec: object
    frames: list  # the window's frames (`frames.Frame`)
    window_start: float  # perf_counter seconds
    rays_per_frame: int
    setup_s: float
    trace: Optional[devtrace.Trace] = None
    traced: tuple = ()  # k of the frames inside the traced stretch
    stretch_samples: int = 0
    launches: Optional[dict] = None  # launch counts added in the stretch, by wrapper name
    peak: Optional[dict] = None  # the card's row of peaks.json

    def updates(self) -> list:
        """Seconds of every update of the window's frames outside the stretch."""
        return [u for f in self.frames if f.k not in self.traced for u in f.updates]


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _quartiles(xs: list) -> str:
    import statistics

    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return f"min={min(xs):.4f} q1={q[0]:.4f} median={q[1]:.4f} q3={q[2]:.4f} max={max(xs):.4f} n={len(xs)}"


def _launch_counts() -> dict:
    from rpt_tpu_torch import kernels

    return {fn.__name__: n for fn, n in kernels.launch_counts().items()}


def _apply(cfg: dict, overrides: Optional[dict]) -> dict:
    for k, v in (overrides or {}).items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    return cfg


@dataclasses.dataclass
class Cell:
    """A cell made ready to run: its entries, its scene and the port's
    renderer behind the traffic's driver."""

    bench: dict
    spec: object
    limits: dict
    driver: fr.Driver


def prepare(workload: str, seed: int, checkout: str, device: str, root: str = registry.PACKAGE,
            overrides: Optional[dict] = None) -> Cell:
    """Everything before the warm frame: the cell's files found by name, its
    scene built, the port's renderer made, the checked pixels drawn."""
    bench = registry.benchmark(checkout)
    cell = registry.workload(bench, workload)
    cfg = _apply(registry.config(cell["config"], root), overrides)
    mix = registry.traffic(cell["traffic"], root)
    limits = registry.checks(workload, root)
    spec = registry.builder(cell["config"], root)(cfg)
    renderer = port.renderer(spec, device)
    pixels = check.sample_pixels(seed, spec.width, spec.height, limits["pixels"])
    driver = fr.Driver(renderer, cfg, mix, pixels)
    spec.spp = driver.spp
    return Cell(bench, spec, limits, driver)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, checkout: str, device: str = "cuda",
             t_start: Optional[float] = None, root: str = registry.PACKAGE, overrides: Optional[dict] = None) -> dict:
    """Run `workload` once; returns the result line's object. `t_start` is
    the process's start on the wall clock (set-up is counted from it)."""
    import torch

    t_start = time.time() if t_start is None else t_start
    on_card = device != "cpu"
    t_prepare = time.time()
    c = prepare(workload, seed, checkout, device, root, overrides)
    bench, spec, limits, driver = c.bench, c.spec, c.limits, c.driver
    pixels = driver.pixels
    t_warm = time.time()
    driver.frame(-1, fr.frame_seed(seed, -1))  # set-up: compile, capture, one warm frame
    log(f"setup parts: before_s={t_prepare - t_start:.3f} prepare_s={t_warm - t_prepare:.3f} "
        f"warm_frame_s={time.time() - t_warm:.3f}")

    window: list = []
    stretch, traced, launches = None, (), None
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    k = 0
    # Frames start until the window's end; a window holds at least one. A
    # traced run profiles its second frame, set-up long past, and runs past
    # the window's end if it must, so that one frame is traced.
    while time.perf_counter() - t0 < seconds or not window or (trace and stretch is None):
        if trace and k == 1:
            before = _launch_counts()
            with devtrace.Stretch() as stretch:
                window.append(driver.frame(k, fr.frame_seed(seed, k)))
            after = _launch_counts()
            launches = {n: after[n] - before.get(n, 0) for n in after}
            traced = (k,)
        else:
            window.append(driver.frame(k, fr.frame_seed(seed, k)))
        k += 1
    if on_card:
        torch.cuda.synchronize()
    log(f"setup_s={setup_s:.3f} frames={len(window)} window_s={time.perf_counter() - t0:.3f}")
    log("frame_s quartiles " + _quartiles([f.end - f.start for f in window]))
    if window[0].updates:
        log("update_s quartiles " + _quartiles([u for f in window for u in f.updates]))
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu", "count": 1}
    if on_card:
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())

    result = {"correct": False, "attempted": len(window), "failed": 0, "metrics": {}, "device": device_info}
    if on_card:
        peaks = registry.read_json(os.path.join(registry.PACKAGE, "peaks.json"))
        ctx = Context(spec=spec, frames=window, window_start=t0,
                      rays_per_frame=rays.frame_rays(spec, driver.spp), setup_s=setup_s,
                      trace=stretch.trace if stretch else None, traced=traced,
                      stretch_samples=len(traced) * driver.spp, launches=launches,
                      peak=peaks.get(device_info["kind"]))
        for m in registry.metrics_of(bench, workload, "per_layer" if trace else "end_to_end"):
            value = registry.reader(m["name"], root)(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        if ctx.trace is not None:
            device_info["busy_s"] = ctx.trace.busy_us() * 1e-6
            device_info["window_s"] = (ctx.trace.end - ctx.trace.start) * 1e-6
            result["breakdown"] = devtrace.breakdown(ctx.trace)

    # The check runs once the window is measured, the harness's hold on the renderer dropped.
    del c, driver, stretch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    chosen = [window[i] for i in check.sample_frames(seed, len(window), limits["frames"])]
    t_ref = time.perf_counter()
    refs = check.reference_renders(spec, [f.seed for f in chosen], pixels, device)
    log(f"reference_s={time.perf_counter() - t_ref:.3f} frames_checked={[f.k for f in chosen]}")
    verdict = check.verdict(check.numbers(chosen, refs, chosen[0].count), limits["limits"])
    result["correct"] = all(v["ok"] for v in verdict.values())
    result["failed"] = sum(1 for f, r in zip(chosen, refs)
                           if any(v > limits["limits"][n] for n, v in check.numbers([f], [r], f.count).items()))
    result["checks"] = {n: {"value": v["value"], "limit": v["limit"]} for n, v in verdict.items()}
    return result
