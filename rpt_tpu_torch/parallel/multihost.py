"""Multi-process rendering over a global ray mesh
(`rpt_tpu/parallel/multihost.py`).

Each process owns some shards of one global mesh, every process's shards in
process-major order. Every process builds the same scene and calls with the
same arguments (the reference's SPMD contract); each renders only its own
shards, folding their global indices into the keys, so its pixels are the
ones a single process would trace for those shards. Every sharded entry
point of `sharding` takes such a mesh: `render_multihost`,
`render_distributed`, `make_sharded_render_fn`, `render_pass_sharded`,
`make_sharded_many_fn` (chunks with `into=` included) and
`make_sharded_diff_fn`. Path tracing needs no collective while it renders:
the traffic between processes is one all-gather per sum, or per frame, of
the finished shards (`collective`), after which every process holds the
whole frame, bit for bit the single-process render on a mesh of the same
shard count on the same type of device. That whole frame on every process
stands in for the reference's global array and its `process_allgather`.

The sharded gradient sums the shards' gradients across processes: every
tensor of the material table and the camera that requires grad is
replicated, and its backward gathers every process's part of the gradient
and adds the parts in rank order on every process, so every process's
leaves get the same bits and an SGD step keeps the replicas equal. It is
held to the in-process gradient on a mesh of as many shards within 1e-6
of the largest |g| (float32): that gradient adds the shards in autograd's
order.

The processes join through `torch.distributed`: NCCL where the shards are
on CUDA cards, gloo where they are on the CPU. Two processes cannot share
one card under NCCL, so a run of several processes on one card asks for
gloo (`init_multihost(..., backend="gloo")`); its gathers then go through
the host.

There is no counterpart of the reference's `_replicate`, which makes its
per-process values global arrays for a multi-controller jit: every process
already holds the same host values, and torch has no global arrays.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..buffer import Buffer
from .sharding import RayMesh, make_ray_mesh, render_distributed

__all__ = [
    "init_multihost",
    "is_multihost",
    "make_global_ray_mesh",
    "render_multihost",
]

# How long a process waits for the others to join.
JOIN_TIMEOUT = datetime.timedelta(seconds=300)
# This process's shard devices, as `init_multihost` was given them (None:
# every card). The process group itself is torch.distributed's, global to
# the process in the same way.
_LOCAL: dict = {"devices": None}
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _shard_devices(local_device_ids) -> tuple:
    """This process's shard devices: an int names that CUDA card, anything
    else a torch device ("cpu"); a repeated entry is a repeated shard. None
    is every card (raises without one)."""
    if local_device_ids is None:
        return make_ray_mesh().devices
    return tuple(torch.device("cuda", i) if isinstance(i, int) else torch.device(i) for i in local_device_ids)


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to a multi-process run: `torch.distributed`'s
    process group over `tcp://coordinator_address` ("host:port", the
    address of process 0), or from a `torchrun` environment when no address
    is given. `local_device_ids` are this process's shards (see
    `_shard_devices`); `backend` is NCCL when they are all on cards and
    gloo otherwise, unless given (gloo for several processes on one card).

    Idempotent. A no-op, but for noting the shards, in a single process
    (no `num_processes` above 1 and no torchrun environment). A process that
    fails to join raises."""
    if dist.is_initialized():
        return
    env = all(k in os.environ for k in _TORCHRUN_ENV)
    if (num_processes is None or num_processes <= 1) and not (env and coordinator_address is None):
        if local_device_ids is not None:
            _LOCAL["devices"] = _shard_devices(local_device_ids)
        return
    if coordinator_address is not None and not (process_id is not None and 0 <= process_id < num_processes):
        raise ValueError(f"process_id {process_id} is not one of {num_processes} processes")
    devices = _shard_devices(local_device_ids)
    on_cards = all(d.type == "cuda" for d in devices)
    backend = backend or ("nccl" if on_cards else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    init_method = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id,
                                timeout=JOIN_TIMEOUT)
    except (RuntimeError, ValueError, OSError) as e:
        raise RuntimeError(f"process {process_id} of {num_processes} failed to join "
                           f"{init_method} over {backend}: {e}") from e
    _LOCAL["devices"] = devices


def is_multihost() -> bool:
    """Whether this process is one of several in a process group."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def make_global_ray_mesh() -> RayMesh:
    """The mesh of every process's shards, process-major, with this
    process's rank and its shards as `local`. Outside a process group, the
    shards `init_multihost` noted, or every card (raises without one).
    Every process must hold the same number of shards."""
    local = _LOCAL["devices"] if _LOCAL["devices"] is not None else _shard_devices(None)
    if not dist.is_initialized():
        return RayMesh(devices=local)
    rank, world = dist.get_rank(), dist.get_world_size()
    names = [None] * world
    dist.all_gather_object(names, [str(d) for d in local])
    if len({len(n) for n in names}) != 1:
        raise ValueError(f"every process must hold as many shards as the others: {[len(n) for n in names]}")
    first = rank * len(local)
    return RayMesh(devices=tuple(d for n in names for d in n), local=tuple(range(first, first + len(local))),
                   rank=rank, world_size=world)


def render_multihost(renderer, mesh: Optional[RayMesh] = None) -> Buffer:
    """`renderer`'s frame buffer with the pixels sharded over the global
    mesh (`make_global_ray_mesh()` when None): one call of
    `make_sharded_many_fn`, in which this process renders its own shards
    and one all-gather per sum gives every process the whole frame, on its
    first shard's device. On a single-process mesh this is
    `render_distributed`, and on any mesh it is its code."""
    return render_distributed(renderer, make_global_ray_mesh() if mesh is None else mesh)
