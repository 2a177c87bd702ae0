"""The traffic between the processes of a multi-process mesh
(`torch.distributed`), for `sharding` and `multihost`.

Torch has no global arrays, so a call over a mesh that spans processes
ends with the whole frame on every process: each process renders its own
shards, and `all_gather` concatenates their rows in rank order. For the
sharded gradient two autograd functions carry the reference's `psum`:

- `gather_rows` is that all-gather, differentiable. Its backward hands each
  process its own rows of the incoming gradient and sends nothing: every
  process takes the same loss of the same frame, so each already holds the
  whole frame's gradient. (`torch.distributed.nn.functional.all_gather`
  reduce-scatters its gradient with a sum, which would count it once per
  process.)
- `replicated` is the identity on the inputs every process holds alike
  (the material table, the camera). Its backward gathers every process's
  partial gradient and adds them in rank order on every process, so each
  process's leaves get the same bits, whatever order the backend would
  reduce in.

The backward collectives are reached by every process in the same order:
`gather_rows` takes the replicated tensors as inputs and hands them zeros,
so every process's frame requires grad and its backward reaches
`replicated`'s gather even where the loss ignores its pixels, and
`check_same` refuses, on every process, a call whose inputs requiring grad
differ between processes. Each replicated input is numbered by call, and
its backward raises if the processes' numbers differ, which would mean
their autograd engines reached the gathers in another order (several cards
in one process run their backward nodes on threads of their own).
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

# The number of the next replicated input of this process; the processes
# make the same calls in the same order, so their numbers agree.
_CALLS = itertools.count()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every process's `x`, concatenated in rank order, on `x`'s device
    (through the host under gloo). Every process's `x` has the same shape."""
    on = x.cpu() if dist.get_backend() == "gloo" else x.contiguous()
    parts = [torch.empty_like(on) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, on)
    return torch.cat(parts).to(x.device)


def check_same(what: str, value) -> None:
    """Raise on every process unless every process's `value` (a picklable
    description of its call) is the same: one `all_gather_object`."""
    values = [None] * dist.get_world_size()
    dist.all_gather_object(values, value)
    if any(v != values[0] for v in values):
        raise ValueError(f"every process must call with the same {what}; by rank: {values}")


class _Replicated(torch.autograd.Function):
    """The identity on tensors every process holds alike; backward: every
    process's partial gradients, added in rank order."""

    @staticmethod
    def forward(ctx, device, call, *xs):
        ctx.device, ctx.call = device, call
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        # One buffer: the call's number, then every gradient, in float64
        # (exact for the float32 and float64 gradients it carries).
        flat = torch.cat([torch.tensor([float(ctx.call)], dtype=torch.float64, device=ctx.device)] +
                         [g.reshape(-1).to(ctx.device, torch.float64) for g in grads])
        parts = all_gather(flat).view(dist.get_world_size(), -1)
        calls = parts[:, 0].tolist()
        if any(c != ctx.call for c in calls):
            raise RuntimeError(f"the processes reached the gradient gathers of calls {calls} at once: "
                               "their backward passes ran in another order")
        out, at = [], 1
        for g in grads:
            part = parts[:, at:at + g.numel()].to(g.dtype)
            total = part[0]
            for p in part[1:]:
                total = total + p
            out.append(total.reshape(g.shape).to(g.device))
            at += g.numel()
        return (None, None, *out)


def replicated(tensors: dict, device: torch.device) -> dict:
    """{name: tensor} with the identity of `_Replicated` applied to every
    tensor, in one node whose backward sums the processes' gradients
    (gathered on `device`)."""
    names = list(tensors)
    out = _Replicated.apply(device, next(_CALLS), *(tensors[n] for n in names))
    return dict(zip(names, out))


class _GatherRows(torch.autograd.Function):
    """`all_gather` of this process's rows; backward: this process's rows
    of the gradient, and zeros for `replicated`, with no communication."""

    @staticmethod
    def forward(ctx, rows, *replicated):
        ctx.rank, ctx.n = dist.get_rank(), rows.shape[0]
        ctx.like = [(r.shape, r.dtype, r.device) for r in replicated]
        return all_gather(rows)

    @staticmethod
    def backward(ctx, grad):
        own = grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n]
        return (own, *(torch.zeros(shape, dtype=dtype, device=device) for shape, dtype, device in ctx.like))


def gather_rows(rows: torch.Tensor, replicated_tensors: tuple) -> torch.Tensor:
    """Every process's `rows` in rank order, differentiable: see the
    module docstring. `replicated_tensors` are this call's outputs of
    `replicated`, through which every process's backward then passes."""
    return _GatherRows.apply(rows, *replicated_tensors)
