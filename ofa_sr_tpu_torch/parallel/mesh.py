"""Data parallelism over processes: counterpart of
ofa_sr_tpu/parallel/mesh.py, over torch.distributed.

The JAX package shards the batch over a device mesh inside one program and
lets XLA insert the collectives; PyTorch runs one process a device (the
reference's Horovod shape), so the port writes its few collectives out:
- `init_distributed` joins the processes (torchrun's environment, or an
  address, a world size and a rank given here), `make_mesh` describes this
  process's place in them;
- `shard_batch`: rank r takes rows [r*B/W, (r+1)*B/W) of a global batch,
  so the ranks' rows in rank order are the global batch in JAX's row order;
- `shard_params`: every rank starts from rank 0's parameters and buffers;
- train-mode BN takes its moments over the global batch (the BN wrappers'
  `group`: an all-reduce of the (2, C) column totals each way), and the
  trainer all-reduces the step's gradients once, after its subnets
  (train/train_step.py).

Only `all_reduce` and `broadcast` are used: gloo takes CUDA tensors for
those two alone, and two processes sharing one GPU (which NCCL refuses)
run over gloo. A gather is an all-reduce of a zero-filled buffer into which
each rank writes its own part: adding zeros is exact.

The backend follows the device: NCCL for CUDA, gloo for the CPU, unless
the caller names one (gloo on CUDA for processes that share a card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place among the processes of a run: the process
    group (None for a single process, which takes no collective), its
    rank, the world size and its device."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device


def init_distributed(coordinator_address=None, num_processes=None, process_id=None, *,
                     device="cuda", backend=None, timeout_s=None):
    """Join the run's processes; returns (rank, world size).

    With no address and no process count it reads torchrun's environment
    (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT), as
    `jax.distributed.initialize()` reads its own, and is a no-op for a
    single process. `coordinator_address` is "host:port" (or a
    torch.distributed init method such as "tcp://host:port"). A second call
    returns the group already joined.

    `device`: this process's device; a CUDA device without an index is
    torchrun's LOCAL_RANK, made the current device. `backend`: by default
    the device's, NCCL for CUDA and gloo for the CPU. `timeout_s`: the
    collectives' timeout, so a rank that waits for a lost peer fails
    instead of hanging."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        if num_processes <= 1:
            return 0, 1
        init_method, process_id = "env://", int(os.environ["RANK"])
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("init_distributed takes an address, a process count and a "
                             "process id together, or none of them")
        init_method = (coordinator_address if "://" in coordinator_address
                       else "tcp://" + coordinator_address)
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(index)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the joined processes (`init_distributed`), or of this
    process alone: a world of one without a group."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return Mesh(None, 0, 1, dev)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev)


def all_reduce_sum(t, group):
    """Sum `t` over the ranks of `group` in place and return it; `t` itself
    where `group` is None."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def world_size(group) -> int:
    """The ranks of `group`; 1 for None (this process alone)."""
    return 1 if group is None else dist.get_world_size(group)


def capturable(group) -> bool:
    """Whether a CUDA graph can capture `group`'s collectives: NCCL's run
    on the device (once the communicator exists, made by an eager
    collective first), gloo's pass through the host. True for None (no
    collective)."""
    return group is None or dist.get_backend(group) == dist.Backend.NCCL


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) with its gradient: each rank's input feeds every
    rank's output, so the cotangent is the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone(), ctx.group), None


def all_reduce_sum_autograd(t, group):
    """A new tensor, `t` summed over the ranks of `group`, differentiable
    (the plain train-mode BN branch's moments)."""
    return t if group is None else _AllReduceSum.apply(t, group)


def _rows(x, mesh):
    b = x.shape[0]
    if b % mesh.world:
        raise ValueError("a global batch of %d rows does not split over %d ranks"
                         % (b, mesh.world))
    n = b // mesh.world
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a dict of arrays or tensors, or
    one of them): rows [r*B/W, (r+1)*B/W), views where the input allows.
    Raises where B is not a multiple of the world size."""
    if isinstance(batch, dict):
        return {k: _rows(v, mesh) for k, v in batch.items()}
    return _rows(batch, mesh)


@torch.no_grad()
def shard_params(module, mesh: Mesh):
    """Give every rank rank 0's parameters and buffers (the reference's
    `hvd.broadcast_parameters`): one broadcast a dtype, of the tensors
    flattened in `state_dict` order. Returns the module."""
    if mesh.group is None:
        return module
    by_dtype = {}
    for t in module.state_dict(keep_vars=True).values():
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, tensors in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.detach().copy_(part.view_as(t))
    return module
