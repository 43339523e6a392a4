"""The data-parallel layout of the training loops, and their batch feed.

Counterpart of neurons_tpu/parallel/mesh.py. The JAX package builds a
named device mesh and lets GSPMD shard the batch over its `data` axis; the
port's `Mesh` is a small record of the process group (world size, this
rank, this rank's device) whose `data` axis is the group's ranks. Every
rank assembles the same global batch from the same seed, as every JAX host
does, and takes its own rows: axis 0 split into contiguous blocks in rank
order, GSPMD's P("data") layout (`shard_batch`). `prefetch_to_device`
feeds the loops: on a card it stages each batch's rows in pinned host
memory and copies them on a side stream, `size` batches ahead.

No counterpart (documented divergences): `data_sharding`,
`replicated_sharding`, `fsdp_sharding`, `shard_opt_state`,
`shard_opt_state_like` and `opt_sharding_fn` return `NamedSharding`s or
place optax state; outside its own tests and tools the JAX package calls
none of them, and a torch tensor has no sharding to carry. Nor do
`MeshConfig`'s `model` and `frame` axes, the axis sizes' resolution,
`Mesh.shape` and `local_mesh_size`: the JAX package shards no tensor over
`model` or `frame` outside `parallel/`, and its callers build
`MeshConfig(data=-1)` only, so the port's mesh is the process group's
ranks, all on the data axis.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.parallel import distributed
from neurons_tpu_torch.parallel.distributed import map_leaves


@dataclass(frozen=True)
class Mesh:
    """The process group as the loops see it: `world` ranks, all on the
    batch axis, this `rank`, and this rank's `device`."""

    world: int
    rank: int
    device: torch.device


def create_mesh(device="cuda") -> Mesh:
    """The mesh of the current process group (one rank without a group).
    `device` resolves as an entry point's does (cuda:LOCAL_RANK under a
    group)."""
    return Mesh(world=distributed.world_size(), rank=distributed.rank(),
                device=resolve_device(device))


def local_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of `n` rows; `n` must divide by the
    world size (drop_last semantics, as the JAX package requires)."""
    if n % mesh.world:
        raise ValueError(f"a batch axis of {n} does not divide over "
                         f"{mesh.world} ranks")
    m = n // mesh.world
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


def _is_on(t, device: torch.device) -> bool:
    return (torch.is_tensor(t) and t.device.type == device.type
            and (device.index is None or t.device.index == device.index))


def _host_rows(mesh: Mesh, x) -> torch.Tensor:
    if torch.is_tensor(x):
        x = x.detach().cpu()
    else:
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x[local_rows(mesh, x.shape[0])]


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every leaf (host arrays or tensors) on its
    device. A tensor already on the device passes through unchanged (its
    caller owns its layout)."""

    def put(x):
        if _is_on(x, mesh.device):
            return x
        return _host_rows(mesh, x).to(mesh.device)

    return map_leaves(put, tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's value of every tensor leaf on every rank, in place; the
    tree is returned. One rank: the tree unchanged."""
    if mesh.world > 1:
        map_leaves(lambda t: distributed.broadcast_(t) if torch.is_tensor(t)
                   else t, tree)
    return tree


def prefetch_to_device(iterator: Iterator, mesh: Mesh,
                       size: int = 2) -> Iterator:
    """The dicts `shard_batch` gives for the batches of `iterator`, in
    order, read at most `size` batches ahead. On a card each batch's rows
    are staged in pinned host memory and copied with non_blocking on a side
    stream; the consuming stream waits on an event recorded after the copy,
    and every tensor is recorded on it, so the allocator keeps its memory
    until the consumer's work is done. On the CPU: a plain generator over
    `shard_batch`."""
    if mesh.device.type != "cuda":
        for batch in iterator:
            yield shard_batch(mesh, batch)
        return
    side = torch.cuda.Stream(mesh.device)
    queue: collections.deque = collections.deque()

    def pinned(x):
        if _is_on(x, mesh.device):
            return x
        return _host_rows(mesh, x).pin_memory()

    def copied(x):
        return x if _is_on(x, mesh.device) else x.to(mesh.device,
                                                      non_blocking=True)

    def enqueue():
        batch = next(iterator, None)
        if batch is None:
            return
        host = map_leaves(pinned, batch)
        with torch.cuda.stream(side):
            dev = map_leaves(copied, host)
            done = torch.cuda.Event()
            done.record(side)
        queue.append((dev, done))

    for _ in range(size):
        enqueue()
    while queue:
        dev, done = queue.popleft()
        consumer = torch.cuda.current_stream(mesh.device)
        consumer.wait_event(done)
        map_leaves(lambda t: t.record_stream(consumer)
                   if torch.is_tensor(t) else None, dev)
        yield dev
        enqueue()
