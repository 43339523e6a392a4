"""Process groups and the collectives of data-parallel training.

Counterpart of neurons_tpu/parallel/distributed.py over torch.distributed:
`initialize` joins a process group from the same environment as the JAX
package (the torchrun / Accelerate variables), `is_main_process` gates
logs, metrics and saves to rank 0, `barrier`, `broadcast_from_host0`,
`process_allgather` and `round_robin_indices` keep the JAX semantics, and
every one of them is the identity in a single process (no group).

Launch N ranks on one node with torchrun:

    torchrun --nproc_per_node=N -m neurons_tpu_torch.cli train-decoupler ...

Backends: NCCL for CUDA tensors, gloo for CPU ones (`initialize(backend=
"gloo")`). NCCL takes one card a rank, so two ranks on one card (a check
of the multi-process path on a one-card host) run over gloo, whose
all_reduce, all_gather and broadcast take CUDA tensors as they are (with
torch 2.11 on the H100; no staging through the host here).

Beside the JAX package's glue, the collectives its GSPMD inserts for the
training steps, as autograd functions: `gather_rows` (all-gather along
axis 0; backward: the gradient summed over ranks, this rank's rows) and
`sum_across_ranks` (all-reduce; backward: all-reduce), so that a loss term
over the global batch is computed from this rank's rows, and
`all_reduce_grads_` (the gradients averaged over ranks, in flat buckets).
Each rank's loss is then the global loss, and the average of the ranks'
gradients is the one-process gradient of the global batch.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_PORT = "12355"
#: elements of one flat bucket of `all_reduce_grads_` (256 MB of f32)
GRAD_BUCKET_ELEMENTS = 1 << 26


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group the environment describes (the Accelerate
    init). Arguments default from JAX_COORDINATOR_ADDRESS, else
    MASTER_ADDR:MASTER_PORT (port 12355 by default); NUM_PROCESSES, else
    WORLD_SIZE; PROCESS_ID, else RANK. Returns False, joining nothing,
    without an address or for a world of 1; True once in a group (at once
    when this process already is). `backend`: "nccl" (the default, CUDA)
    or "gloo" (CPU tensors)."""
    if dist.is_initialized():
        return True
    backend = backend or "nccl"
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        port = os.environ.get("MASTER_PORT", DEFAULT_PORT)
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(
        os.environ.get("NUM_PROCESSES", os.environ.get("WORLD_SIZE", "1")))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", os.environ.get("RANK", "0")))
    if num_processes <= 1:
        return False
    join_group(coordinator_address, num_processes, process_id, backend)
    return True


def join_group(address: str, world: int, rank: int,
               backend: str = "nccl") -> None:
    """`init_process_group` at tcp://`address` (host:port) for `world`
    ranks, any size (`initialize` joins none for a world of 1); under NCCL
    this process's card is then cuda:LOCAL_RANK."""
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank,
                            device_id=_device_id(backend))


def _device_id(backend: str) -> Optional[torch.device]:
    """Under NCCL: this process's card, made the current device."""
    if backend != "nccl":
        return None
    torch.cuda.set_device(local_rank())
    return torch.device("cuda", local_rank())


def local_rank() -> int:
    """This process's card on its node (torchrun's LOCAL_RANK, else 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank-0 gate (the reference's accelerator.is_main_process)."""
    return rank() == 0


def barrier(name: str = "barrier") -> None:
    """Block until every rank arrives (the reference's
    accelerator.wait_for_everyone()). Single process: returns at once."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_from_host0(tree):
    """Rank 0's `tree` (any picklable value: numbers, arrays, dicts) on
    every rank. Single process: the identity."""
    if not dist.is_initialized():
        return tree
    box = [tree if is_main_process() else None]
    dist.broadcast_object_list(box, src=0, device=_comm_device())
    return box[0]


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def map_leaves(fn: Callable, tree):
    """`tree` (nested dicts, lists and tuples) with `fn` applied to every
    leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def process_allgather(tree):
    """Every rank's `tree` stacked on a new leading axis of length world
    size, as numpy arrays (the reference's accelerator.gather). Single
    process: a leading axis of 1."""
    if not dist.is_initialized():
        return map_leaves(lambda x: _to_numpy(x)[None], tree)

    def gather(x):
        t = torch.as_tensor(_to_numpy(x)).to(_comm_device())
        parts = [torch.empty_like(t) for _ in range(world_size())]
        dist.all_gather(parts, t)
        return torch.stack(parts).cpu().numpy()

    return map_leaves(gather, tree)


def round_robin_indices(total: int, shard: Optional[int] = None,
                        num_shards: Optional[int] = None) -> np.ndarray:
    """The stage-5 clip split `org_idx = rank + i * num_devices`. Defaults
    to this process's rank over all ranks."""
    shard = rank() if shard is None else shard
    num_shards = world_size() if num_shards is None else num_shards
    return np.arange(shard, total, num_shards)


# ------------------------------------------------- training collectives ----

def _comm_device() -> torch.device:
    """Where a collective's host-side values live: this process's card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks, in place. Single process: `t`."""
    if dist.is_initialized():
        dist.all_reduce(t)
    return t


@torch.no_grad()
def broadcast_(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's `t` on every rank, in place. Single process: `t`."""
    if dist.is_initialized():
        dist.broadcast(t, src=0)
    return t


def _all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _all_gather_rows(t)

    @staticmethod
    def backward(ctx, g):
        # every rank's gradient of its use of all rows, summed; this rank's
        # rows of it
        g = g.contiguous()
        n = g.shape[0] // world_size()
        if dist.get_backend() == "nccl":
            out = torch.empty((n,) + g.shape[1:], dtype=g.dtype,
                              device=g.device)
            dist.reduce_scatter_tensor(out, g)
            return out
        g = g.clone()
        dist.all_reduce(g)
        return g[rank() * n:(rank() + 1) * n].clone()


class _SumAcrossRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` concatenated along axis 0 in rank order (the rows
    of the global batch). Differentiable where `t` requires a gradient:
    this rank's rows get the gradient of every rank's use of them, summed.
    Single process: `t`."""
    if world_size() == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherRows.apply(t)
    return _all_gather_rows(t)


def sum_across_ranks(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks (a new tensor); differentiable, its
    backward the gradient summed over the ranks. Single process: `t`."""
    if world_size() == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _SumAcrossRanks.apply(t)
    return all_reduce_(t.clone())


def mean_across_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of `t` (each rank's mean over its rows: the
    global mean for shards of equal size); differentiable."""
    return sum_across_ranks(t) / world_size()


def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    bucket, size = [], 0
    for t in tensors:
        if bucket and (size + t.numel() > GRAD_BUCKET_ELEMENTS
                       or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_grads_(params: Iterable[torch.Tensor]) -> None:
    """Average each parameter's `.grad` over the ranks, in place, in flat
    buckets of up to GRAD_BUCKET_ELEMENTS of one type (one collective a
    bucket). Within a group of one rank the buckets still make their round
    trip; without a group nothing happens."""
    if not dist.is_initialized():
        return
    n = world_size()
    for bucket in _buckets([p.grad for p in params]):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat.div_(n)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def destroy() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()

