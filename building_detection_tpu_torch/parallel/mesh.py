"""The port's mesh: one process per device, over ``torch.distributed``.

The counterpart of ``building_detection_tpu/parallel/mesh.py``.  JAX runs one
controller over many devices: its ``Mesh`` spans every global device and XLA
inserts the collectives.  torch runs one process per device, so here:

* a :class:`Mesh` is this process's view of the run: the ``data`` and
  ``model`` sizes, its rank and the world size, its device and the process
  group the data axis reduces over;
* an array sharded over ``data`` is, on each rank, only that rank's rows:
  :func:`data_rows`, :func:`shard_batch` and :func:`shard_staged` stand
  where ``data_sharded``, ``shard_batch`` and ``staged_sharded`` stand
  (rank ``r`` of ``d`` holds the ``r``-th of ``d`` equal contiguous parts,
  the rows JAX's sharding gives the ``r``-th device of the data axis);
* "replicated" means equal on every rank, which :func:`replicate` checks
  by one broadcast from rank 0.

Without a process group, or at world size 1, the mesh has ``data == 1`` and
no group: nothing in the port then runs a collective, and a train step is
the single-device step bit for bit.  ``model > 1`` (channel tensor
parallelism, ``parallel/tp.py`` in the JAX package) is not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel run.

    ``device`` is the device the mesh pins (``None``: the trainer's
    ``device`` argument decides); ``group`` is the process group of the data
    axis, ``None`` at ``data == 1``; ``backend`` is the process group's
    backend, ``None`` without one.
    """

    data: int
    model: int
    rank: int
    world_size: int
    device: Optional[torch.device] = None
    group: Optional[Any] = None
    backend: Optional[str] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def data_axis_size(world_size: int, data: int = -1, model: int = 1, batch_size: Optional[int] = None) -> int:
    """The data axis of :func:`make_mesh`: ``data=-1`` takes every process,
    capped at ``gcd(batch_size, processes)`` so the batch always divides it
    (the JAX package's rule, shared by bdt-train and bdt-eval)."""
    if data == -1:
        data = world_size // model
        if batch_size is not None:
            data = math.gcd(batch_size, data)
    return data


def check_covers_ranks(world_size: int, data: int, model: int = 1, batch_size: Optional[int] = None) -> None:
    """Raise unless a ``data x model`` mesh uses every process exactly: a
    rank outside the mesh would own no rows and idle, or block the others in
    their first collective."""
    used = data * model
    if data < 1 or used > world_size:
        raise ValueError(
            f"a mesh of data={data} x model={model} needs {used} processes and the run has {world_size}: "
            "launch one process per device with init_distributed first: bdt-train --coordinator HOST:PORT "
            "--num-processes N --process-id I, or torchrun --nproc-per-node N ... --num-processes 0"
        )
    if used < world_size:
        raise ValueError(
            f"mesh uses {used} of {world_size} processes and excludes rank(s) {list(range(used, world_size))} "
            f"(batch_size={batch_size} caps the data axis at {data}); raise --batch-size to cover every "
            "process or pass --data-parallel explicitly"
        )


def _one_device(devices) -> Optional[torch.device]:
    if devices is None:
        return None
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    devices = list(devices)
    if len(devices) != 1:
        raise NotImplementedError(
            f"one process drives one device here, got {len(devices)}; several devices in one process "
            "(tile and ensemble parallelism) are not ported yet"
        )
    return torch.device(devices[0])


def make_mesh(
    data: int = -1,
    model: int = 1,
    devices: Union[None, str, torch.device, Sequence] = None,
    batch_size: Optional[int] = None,
) -> Mesh:
    """The mesh over every process of the run (one process without a
    process group).  ``devices`` is this process's device, or ``None`` to
    leave it to the trainer; under NCCL it is the card
    :func:`parallel.distributed.init_distributed` selected."""
    if model != 1:
        raise NotImplementedError(
            "channel tensor parallelism (model > 1, parallel/tp.py in the JAX package) is not ported yet"
        )
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    data = data_axis_size(world, data, model, batch_size)
    check_covers_ranks(world, data, model, batch_size)
    device = _one_device(devices)
    if device is None and backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    group = dist.group.WORLD if data > 1 else None
    return Mesh(data, model, rank, world, device, group, backend)


def data_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row array sharded over the data axis."""
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not split over data={mesh.data}")
    k = n // mesh.data
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of each array of a global host batch (a tuple of
    arrays or tensors whose leading dim divides by ``data``): views, on the
    arrays' own device."""
    return tuple(x[data_rows(mesh, len(x))] for x in batch)


def shard_staged(x, mesh: Mesh):
    """This rank's rows of a staged ``(steps, batch, ...)`` array: its
    second dim is the batch."""
    return x[:, data_rows(mesh, x.shape[1])]


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Check that ``tensors`` are equal on every rank of the data axis: one
    broadcast of rank 0's values, and one all-reduce of the verdict, so a
    rank that differs makes every rank raise.  Nothing runs at
    ``data == 1``."""
    if mesh.group is None:
        return
    mine = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    rank0 = mine.clone()
    dist.broadcast(rank0, src=0, group=mesh.group)
    differ = (rank0 != mine).any().to(torch.float32).reshape(1)
    dist.all_reduce(differ, group=mesh.group)
    if float(differ) > 0:
        raise ValueError(
            f"the replicated tensors differ between ranks ({int(float(differ))} of {mesh.data} ranks differ "
            "from rank 0): every rank must build the same model from the same seed and weights"
        )
