"""The scatter step of a wavefront depth, fused into one kernel on the card.

At every depth below `max_bounces`, `trace_paths` samples each lane's next
direction (`materials.sample_f`), evaluates the BSDF there
(`materials.bsdf`) and forms the path weight f |wi.n| / pdf, zero where the
sample does not count (no surface, total internal reflection on the
transmission lobe, a pdf of measure zero). `scatter` does all three and
returns (wi, w, ok).

It draws `sample_f`'s five uniforms first (`materials.sample_draws`, through
the threefry kernel on the card, with `sample_f`'s keys). Then, on a CUDA
device, it launches `csrc/scatter.cu` once (counted: slot 0 its float32
kernel, slot 1 its float64 one), which keeps every intermediate in
registers where torch ran some 450 elementwise kernels through device
memory. On the CPU it runs `scatter_plain`. The kernel repeats
`scatter_plain`'s arithmetic op for op and agrees with it bit for bit on
the card.

Under autograd the estimator is the reference's detached one: the sampled
direction and its pdf are constants (`stop_gradient`), so a gradient flows
through the BSDF's value and |wi.n|, never through the sampler. So where an
input the weight reads requires grad, the kernel still samples (its wi, ok
and the weight's divisor carry no gradient), and only `weight`, the BSDF
and the weight, is rebuilt in torch on those samples: the same values, and
the gradient of the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..kernels import counted, launch_counter
from ..materials import MatParams, SampleDraws, bsdf, sample_draws, sample_f_drawn
from ..utils.vmath import absolute, dot

__all__ = ["scatter", "scatter_plain", "scatter_kernel", "weight", "stop_gradient", "PDF_EPS"]

# Samples with a pdf this small are dropped (measure zero).
PDF_EPS = 1e-10


def stop_gradient(x: torch.Tensor) -> torch.Tensor:
    """`jax.lax.stop_gradient`: the value of x, as a constant."""
    return x.detach()


def weight(mat: MatParams, n: torch.Tensor, wo: torch.Tensor, wi: torch.Tensor, pdf_safe: torch.Tensor,
           ok: torch.Tensor) -> torch.Tensor:
    """The masked path weight f |wi.n| / pdf_safe where ok, else 0 (N, 3), at
    the sampled directions `wi` (constants) with the weight's divisor
    `pdf_safe` (the pdf where ok, else 1)."""
    f = bsdf(mat, n, wo, wi)
    w = f * (absolute(dot(wi, n)) / pdf_safe)[:, None]
    return torch.where(ok[:, None], w, torch.zeros_like(w))


def scatter_plain(draws: SampleDraws, mat: MatParams, n: torch.Tensor, wo: torch.Tensor, found: torch.Tensor):
    """The scatter step in torch ops from its draws: (wi (N, 3), the masked
    weight w (N, 3), ok (N,) bool). What the CPU runs, and what the kernel is
    held to."""
    wi, pdf, valid = sample_f_drawn(draws, mat, n, wo)
    # Detached sampling, as in the reference: the sampled direction and its
    # pdf are constants under differentiation, so gradients flow through the
    # BSDF's value only (the unbiased detached estimator; the values are
    # unchanged).
    wi, pdf = stop_gradient(wi), stop_gradient(pdf)
    ok = found & valid & (pdf > PDF_EPS)
    pdf_safe = torch.where(ok, pdf, torch.ones_like(pdf))
    return wi, weight(mat, n, wo, wi, pdf_safe, ok), ok


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _rows(t: torch.Tensor, n: int, dtype, device) -> torch.Tensor:
    """An (n, 3) input with its last axis contiguous (its rows may be a
    column slice of a wider packed tensor)."""
    if t.shape != (n, 3) or t.dtype != dtype or t.device != device:
        raise ValueError(f"scatter: a vector input is {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"not ({n}, 3) {dtype} on {device}")
    return t if t.stride(1) == 1 else t.contiguous()


def _column(t: torch.Tensor, n: int, dtype, device) -> torch.Tensor:
    if t.shape != (n,) or t.dtype != dtype or t.device != device:
        raise ValueError(f"scatter: a column is {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"not ({n},) {dtype} on {device}")
    return t.contiguous()


def scatter_kernel(draws: SampleDraws, mat: MatParams, n: torch.Tensor, wo: torch.Tensor, found: torch.Tensor,
                   launches=None, with_pdf: bool = False):
    """Launch csrc/scatter.cu: `scatter_plain`'s (wi, w, ok) on a CUDA
    device, in one launch of one thread a lane; with `with_pdf`, also the
    weight's divisor (N,) (the pdf where ok, else 1). `launches`: a launch
    count's address (`kernels.launch_counter`), or None for a launch not
    counted. Nothing it returns carries a gradient."""
    from ..kernels import load_library

    device, dtype = n.device, n.dtype
    if device.type != "cuda":
        raise ValueError("the scatter kernel needs a CUDA device")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the scatter kernel takes float32 or float64, not {dtype}")
    count = n.shape[0]
    nrm, wo_, color = (_rows(t, count, dtype, device) for t in (n, wo, mat.color))
    cols = [_column(t, count, dtype, device)
            for t in (mat.index, mat.roughness, mat.metallic, mat.transparent, *draws)]
    found = _column(found, count, torch.bool, device)
    wi = torch.empty((count, 3), dtype=dtype, device=device)
    w = torch.empty((count, 3), dtype=dtype, device=device)
    ok = torch.empty((count,), dtype=torch.bool, device=device)
    pdf = torch.empty((count,), dtype=dtype, device=device) if with_pdf else None
    out = (wi, w, ok, pdf) if with_pdf else (wi, w, ok)
    if count == 0:
        return out
    # torch.mean's factor, num_outputs / numel in the real type (csrc/scatter.cu).
    real = np.float32 if dtype == torch.float32 else np.float64
    third = float(real(count) / real(3 * count))
    lib = load_library("scatter")
    entry = lib.rpt_scatter if dtype == torch.float32 else lib.rpt_scatter_f64
    err = entry(count, _ptr(nrm), nrm.stride(0), _ptr(wo_), wo_.stride(0), _ptr(found), _ptr(color), color.stride(0),
                *map(_ptr, cols), third, _ptr(wi), _ptr(w), _ptr(ok), None if pdf is None else _ptr(pdf), launches,
                ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"scatter kernel launch failed: CUDA error {err}")
    return out


def _on_cpu(device: torch.device) -> bool:
    return device.type == "cpu"


def _records_grad(mat: MatParams, n: torch.Tensor, wo: torch.Tensor) -> bool:
    """Whether autograd records the weight: an input it reads requires grad."""
    inputs = (n, wo, *(getattr(mat, f.name) for f in dataclasses.fields(mat) if f.name != "emittance"))
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


@counted(slots=2)
def scatter(key, mat: MatParams, n: torch.Tensor, wo: torch.Tensor, found: torch.Tensor):
    """One depth's scatter step for the N lanes with unit normals `n` (N, 3),
    outgoing directions `wo` (N, 3), material parameters `mat` and hit mask
    `found` (N,): (wi (N, 3), the weight f |wi.n| / pdf where ok and 0
    elsewhere (N, 3), ok (N,) bool), with `sample_f`'s draws under `key`.
    The kernel off the CPU (counted on the card), else `scatter_plain`."""
    draws = sample_draws(key, tuple(n.shape[:-1]), n.device, n.dtype)
    if _on_cpu(n.device):
        return scatter_plain(draws, mat, n, wo, found)
    launches = launch_counter(scatter, n.device, 0 if n.dtype == torch.float32 else 1)
    if not _records_grad(mat, n, wo):
        return scatter_kernel(draws, mat, n, wo, found, launches=launches)
    # The kernel's samples are the plain version's constants; the weight's
    # graph is rebuilt on them.
    wi, _, ok, pdf_safe = scatter_kernel(draws, mat, n, wo, found, launches=launches, with_pdf=True)
    return wi, weight(mat, n, wo, wi, pdf_safe, ok), ok
