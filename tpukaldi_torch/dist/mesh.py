"""Data parallelism over `torch.distributed` (counterpart of tpukaldi's
`dist/mesh.py`).

tpukaldi runs one process over a `jax.sharding.Mesh` whose 'data' axis
shards the batch, and XLA inserts the gradient psum.  The port runs one
process per device (DDP's model): every rank holds the whole model, takes
its own columns of a (T, B, D) batch or its rows of an (N, D) frame batch,
and the gradients are summed between `loss.backward()` and the optimizer
step by an explicit all-reduce (`all_reduce_grads`), one flat buffer per
architecture.  No `nn.parallel.DistributedDataParallel`: an explicit reduce
is what a captured step graph (`train/step.py::StepGraph`) can hold, and it
sits where tpukaldi's clip expects the global gradient.

Each rank's loss is weighted by its share of the global batch's rows
before the backward (`shard_weight`), so the summed gradients are those of
the global masked mean: the row mask is over time only, so each column of
a sequence batch holds as many rows, and a frame batch weighs by rows.
Batchnorm in training takes the global batch's moments
(`models/common.py::BatchNorm` under `global_batch_moments`), as
tpukaldi's sharded step computes them.

NCCL carries CUDA tensors, gloo CPU tensors (and CUDA tensors, without
capture).  With no process group the mesh is world size 1 and runs no
collective, as tpukaldi's mesh over one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataParallelMesh:
    """The process group in place, as this rank sees it: its rank, the
    world size, its rank on its host, the device it computes on and the
    group's backend ("" with no group: world size 1, no collective)."""

    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: str

    @property
    def active(self) -> bool:
        """A process group is in place: the steps run their collectives
        (at world size 1 too, each then a copy)."""
        return bool(self.backend)

    @property
    def capturable(self) -> bool:
        """Its collectives can sit in a CUDA graph: NCCL's can, gloo's
        cannot, and with no group there is none."""
        return self.backend != "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda", backend: Optional[str] = None) -> None:
    """Join the process group at `coordinator_address` ("host:port") as
    rank `process_id` of `num_processes` (tpukaldi's
    `jax.distributed.initialize`): NCCL for a CUDA `device`, gloo for the
    CPU, or `backend` where given.  A no-op when there is no coordinator,
    as tpukaldi's."""
    if coordinator_address is None:
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        # the step graphs capture NCCL's all-reduce; PyTorch's CUDA-graph
        # notes ask for async error handling off around captured collectives
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        if device.index is not None:
            torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def data_parallel_mesh(device=None) -> DataParallelMesh:
    """The group in place (world size 1, no backend, without one).
    `device` defaults to the group's: `cuda:<local rank>` under NCCL, the
    CPU under gloo."""
    if not (dist.is_available() and dist.is_initialized()):
        return DataParallelMesh(0, 1, 0, torch.device(device or "cpu"), "")
    backend = str(dist.get_backend())
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if device is None:
        device = f"cuda:{local}" if backend == "nccl" else "cpu"
    return DataParallelMesh(dist.get_rank(), dist.get_world_size(), local,
                            torch.device(device), backend)


def warm_up(mesh: DataParallelMesh) -> None:
    """One all-reduce on the mesh's device, so that NCCL's communicator
    exists before a step graph captures a collective."""
    if mesh.active:
        dist.all_reduce(torch.zeros(1, device=mesh.device))


def barrier(mesh: DataParallelMesh) -> None:
    """Wait for every rank (where rank 0 writes what the others read)."""
    if mesh.active and mesh.world_size > 1:
        if mesh.backend == "nccl":
            dist.barrier(device_ids=[mesh.device.index or 0])
        else:
            dist.barrier()


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def replicate(tree, mesh: DataParallelMesh):
    """Rank 0's values of every tensor in `tree` (a tensor, a module's
    parameters and buffers, or dicts and lists of them) broadcast in place
    to every rank; returns `tree`."""
    if mesh.active and mesh.world_size > 1:
        with torch.no_grad():
            for t in _tensors(tree):
                dist.broadcast(t.data, src=0)
    return tree


# every rank loads the same values (seeded init), so placing a tree over a
# multi-host mesh is the same broadcast
replicate_global = replicate


def _batch_axis(x, batch_axis: Optional[int]) -> int:
    """tpukaldi's convention (`train/step.py::_constrain_batch`): axis 1 of
    a time-major (T, B, D) tensor, axis 0 otherwise."""
    if batch_axis is not None:
        return batch_axis
    return 1 if x.ndim == 3 else 0


def shard_bounds(n: int, mesh: DataParallelMesh) -> tuple:
    """[start, stop) of this rank's share of `n` rows, split as
    `torch.tensor_split` splits them (the first n % world ranks take one
    more).  Raises where a rank would get none."""
    if n < mesh.world_size:
        raise ValueError(f"a batch of {n} rows cannot be split over "
                         f"{mesh.world_size} ranks")
    q, r = divmod(n, mesh.world_size)
    start = mesh.rank * q + min(mesh.rank, r)
    return start, start + q + (mesh.rank < r)


def shard_batch(array, mesh: DataParallelMesh,
                batch_axis: Optional[int] = None):
    """This rank's columns of a (T, B, D) batch or rows of an (N, D) one
    (a tensor or a numpy array, returned as it came: a view, or the array
    itself at world size 1)."""
    if mesh.world_size == 1:
        return array
    axis = _batch_axis(array, batch_axis)
    start, stop = shard_bounds(array.shape[axis], mesh)
    index = [slice(None)] * array.ndim
    index[axis] = slice(start, stop)
    return array[tuple(index)]


def shard_weight(n: int, mesh: DataParallelMesh) -> float:
    """This rank's share of a batch of `n` rows (1.0 at world size 1)."""
    if mesh.world_size == 1:
        return 1.0
    start, stop = shard_bounds(n, mesh)
    return (stop - start) / n


def global_batch_from_host_shards(array, mesh: DataParallelMesh,
                                  batch_axis: Optional[int] = None
                                  ) -> torch.Tensor:
    """Each rank passes ITS shard of the batch; every rank gets the global
    batch, the shards in rank order along the batch axis (they may differ
    in size)."""
    x = torch.as_tensor(np.asarray(array) if not isinstance(
        array, torch.Tensor) else array)
    if not mesh.active or mesh.world_size == 1:
        return x
    axis = _batch_axis(x, batch_axis)
    x = x.to(mesh.device)
    sizes = [torch.zeros(1, dtype=torch.int64, device=mesh.device)
             for _ in range(mesh.world_size)]
    dist.all_gather(sizes, torch.tensor([x.shape[axis]], device=mesh.device))
    sizes = [int(s) for s in sizes]
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, max(sizes) - x.shape[axis]]
    padded = torch.nn.functional.pad(x, pad).contiguous()
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded)
    return torch.cat([p.narrow(axis, 0, n) for p, n in zip(parts, sizes)],
                     dim=axis)


def reduce_weighted(x: torch.Tensor, weight: float,
                    mesh: DataParallelMesh) -> torch.Tensor:
    """sum over ranks of `weight` * x: a global mean from each rank's mean
    and its `shard_weight` (x itself, untouched, with no group)."""
    if not mesh.active:
        return x
    y = x * weight if weight != 1.0 else x.clone()
    dist.all_reduce(y)
    return y


def scalar_from_global(x) -> float:
    """A reduced (global) scalar on this rank, as a float."""
    return float(x)


def all_reduce_grads(optimizers: Dict,
                     mesh: Optional[DataParallelMesh] = None) -> None:
    """Sum each architecture's gradients over the ranks, in one flat buffer
    per architecture, and write the sums back into `.grad`.  Each rank's
    gradients are those of its weighted loss (`shard_weight`: the train
    step weights the loss, so that the batchnorm moments' cross-rank terms
    are weighted too), so the sums are the global batch's.  Parameters
    without a gradient are left out, as they are on every rank."""
    mesh = mesh or data_parallel_mesh()
    if not mesh.active:
        return
    for opt in optimizers.values():
        grads = [p.grad for p in opt.params if p.grad is not None]
        if not grads:
            continue
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n
