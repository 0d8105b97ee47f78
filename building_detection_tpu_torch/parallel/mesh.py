"""The port's mesh: the devices of a run's data and model axes.

The counterpart of ``building_detection_tpu/parallel/mesh.py``.  JAX runs one
controller over many devices: its ``Mesh`` spans every global device and XLA
inserts the collectives.  torch has two forms of it here:

* **Training runs one process per device**, over ``torch.distributed``.  A
  :class:`Mesh` is this process's view of the run: the ``data`` and
  ``model`` sizes, its rank and the world size, its device and the process
  groups of its two axes.  Rank ``r`` sits at data index ``r // model`` and
  model index ``r % model``, JAX's ``np.array(devices).reshape(data,
  model)``: the data group of a rank is the ranks of its model index, its
  model group the ranks of its data index.  An array sharded over ``data``
  is, on each rank, only its data index's rows: :func:`data_rows`,
  :func:`shard_batch` and :func:`shard_staged` stand where
  ``data_sharded``, ``shard_batch`` and ``staged_sharded`` stand (data index
  ``i`` of ``d`` holds the ``i``-th of ``d`` equal contiguous parts, the
  rows JAX's sharding gives the ``i``-th row of the mesh), and "replicated"
  means equal on every rank of the data axis, which :func:`replicate`
  checks by one broadcast.  Channel tensor parallelism
  (``parallel/tp.py``) shards parameters over the model group;
  :func:`check_tp_replicas` checks the shards equal over the data group and
  the rest over every rank.
* **Inference runs one process over several local devices**:
  ``make_mesh(devices=[d0, d1, ...], data, model)`` in a process with no
  process group (or at world size 1) gives a mesh whose ``data x model``
  grid is those devices, row-major as in JAX, in ``Mesh.devices``.  The
  predictors hold a replica of each member on the first device of each
  data row (:func:`predictor_devices`), run each row's contiguous part of a
  tile batch there, member by member across the rows
  (``infer.fused_ensemble.shard_forward``), and under channel tensor
  parallelism run each sharded layer's channel slices on the row's model
  devices.  A list may name a device more than once (``["cpu", "cpu"]``,
  ``["cuda:0", "cuda:0"]``): each entry is one shard, and the entries of
  one device share its weights, which is how a machine with one device
  runs the split.

Without a process group, or at world size 1, a training mesh has ``data ==
model == 1`` and no group: nothing in the port then runs a collective, and
a train step is the single-device step bit for bit.

Several local devices in each of several processes (JAX's hybrid: one
controller a host over its devices, several hosts) run one worker a device,
started by :func:`parallel.launch.launch`: worker ``k`` of process ``p`` is
rank ``p * K + k``, JAX's process-major device order, and ``Mesh.local_size``
(``K``, the launcher's ``LOCAL_WORLD_SIZE``) and ``Mesh.process_index`` say
where a rank sits.  A model group of ``model <= K`` ranks then lies inside
one process, as the inner axis of JAX's mesh does.  ``make_mesh(devices=[...])``
with several devices under a process group of more than one rank is refused
with what to run instead.  The fused predictor and the per-model
``TiledPredictor`` (tile data parallelism and, with ``tp=True``, channel
TP over the model group) also run over a mesh that spans processes, a rank
on its one device (:func:`rank_device`), as the JAX package's do.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from building_detection_tpu_torch.core.device import check_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """A run's data and model axes, as this process sees it.

    ``device`` is the device the mesh pins (``None``: the trainer's or the
    predictor's ``device`` argument decides); ``group`` is the process group
    of this rank's data axis, ``None`` at ``data == 1`` and on a mesh of
    local devices, and ``model_group`` that of its model axis, ``None`` at
    ``model == 1`` and on a mesh of local devices; ``backend`` is the
    process group's backend, ``None`` without one.  ``devices`` are this
    process's devices, the first of them ``device``: one entry for a
    training process, ``data * model`` entries, row-major, on a mesh of
    local devices (:func:`make_mesh`).  ``local_size`` is the ranks a
    launcher process runs (:mod:`parallel.launch`; 1 for a process of its
    own), so rank ``r`` is worker ``r % local_size`` of process ``r //
    local_size``.
    """

    data: int
    model: int
    rank: int
    world_size: int
    device: Optional[torch.device] = None
    group: Optional[Any] = None
    backend: Optional[str] = None
    devices: Tuple[Optional[torch.device], ...] = ()
    model_group: Optional[Any] = None
    local_size: int = 1

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))

    @property
    def data_index(self) -> int:
        """This rank's row of the mesh: the part of a data-sharded array it holds."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's column of the mesh: the channel slice it holds under TP."""
        return self.rank % self.model

    @property
    def process_index(self) -> int:
        """The launcher process this rank is a worker of: JAX's
        ``process_index`` of the device the rank stands for."""
        return self.rank // self.local_size

    @property
    def local_rank(self) -> int:
        """This rank's worker index inside its launcher process."""
        return self.rank % self.local_size

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def data_axis_size(world_size: int, data: int = -1, model: int = 1, batch_size: Optional[int] = None) -> int:
    """The data axis of :func:`make_mesh`: ``data=-1`` takes every process,
    capped at ``gcd(batch_size, processes)`` so the batch always divides it
    (the JAX package's rule, shared by bdt-train and bdt-eval)."""
    if data == -1:
        data = max(world_size // model, 1)
        if batch_size is not None:
            data = math.gcd(batch_size, data)
    return data


def check_covers_ranks(
    world_size: int, data: int, model: int = 1, batch_size: Optional[int] = None, local_size: int = 1
) -> None:
    """Raise unless a ``data x model`` mesh uses every process exactly (a
    rank outside the mesh would own no rows and idle, or block the others in
    their first collective) and a global batch of ``batch_size`` splits
    over its data axis.  ``local_size`` is the workers a launcher process
    runs: the message names the launcher processes whose workers all fall
    off the mesh, as the JAX package names the processes whose devices do."""
    used = data * model
    if data < 1 or used > world_size:
        raise ValueError(
            f"a mesh of data={data} x model={model} needs {used} processes and the run has {world_size}: "
            "launch one process per device with init_distributed first: bdt-train --coordinator HOST:PORT "
            "--num-processes N --process-id I [--local-devices K], or torchrun --nproc-per-node N ... "
            "--num-processes 0, or parallel/launch.py's launch(fn, ..., local_devices=K)"
        )
    if used < world_size:
        left = list(range(used, world_size))
        whole = sorted({r // local_size for r in left if (r // local_size) * local_size >= used})
        procs = f", all workers of process(es) {whole}," if local_size > 1 and whole else ""
        raise ValueError(
            f"mesh uses {used} of {world_size} processes and excludes rank(s) {left}{procs} "
            f"(batch_size={batch_size} caps the data axis at {data}); raise --batch-size to cover every "
            "process or pass --data-parallel explicitly"
        )
    if batch_size is not None and batch_size % data:
        raise ValueError(
            f"a global batch of {batch_size} does not split over data={data}: pass a --batch-size that {data} "
            "divides, or --data-parallel -1 (the largest data axis the batch divides)"
        )


def launched_local_size(world_size: int) -> int:
    """The workers of each launcher process: ``LOCAL_WORLD_SIZE`` where a
    launcher (:mod:`parallel.launch`, torchrun) set it and it divides the
    world, else 1 (a process of its own)."""
    size = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return size if size >= 1 and world_size % size == 0 else 1


def _local_devices(devices) -> Tuple[Optional[torch.device], ...]:
    if devices is None:
        return (None,)
    if isinstance(devices, (str, torch.device)):
        return (torch.device(devices),)
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh(devices=[]) names no device")
    return devices


def make_mesh(
    data: int = -1,
    model: int = 1,
    devices: Union[None, str, torch.device, Sequence] = None,
    batch_size: Optional[int] = None,
) -> Mesh:
    """The mesh of this run.

    With one device (or ``devices=None``) it spans every process of the run
    (this one alone without a process group), ``data x model`` of them:
    ``devices`` is this process's device, or ``None`` to leave it to the
    trainer; under NCCL it is the card
    :func:`parallel.distributed.init_distributed` selected.  With
    ``model > 1`` every rank creates the process groups of every row and
    column in the same order (``torch.distributed.new_group`` is collective).

    With several ``devices``, in a process without a process group or at
    world size 1, the ``data x model`` grid is those local devices, row-major
    (``data=-1`` takes ``len(devices) // model``; an explicit ``data`` times
    ``model`` must equal their number), for the predictors' tile data
    parallelism and channel tensor parallelism.  A device may appear more
    than once: each entry is one shard."""
    if model < 1:
        raise ValueError(f"make_mesh(model={model}): the model axis needs at least one device")
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    local = _local_devices(devices)
    if len(local) > 1:
        if world > 1:
            raise ValueError(
                f"{len(local)} local devices in each of {world} processes: under a process group a process "
                "drives one device. Start a worker a device instead, with parallel/launch.py (launch(fn, ..., "
                f"local_devices={len(local)}), or bdt-train/bdt-eval --local-devices {len(local)}); each worker "
                "then calls make_mesh() over the ranks of every process, JAX's process-major device order"
            )
        if data == -1:
            data = len(local) // model
        if data * model != len(local):
            raise ValueError(
                f"make_mesh(data={data}, model={model}) over {len(local)} local devices: data must equal their "
                f"number divided by model={model}"
            )
        return Mesh(data, model, rank, world, local[0], None, backend, local)
    local_size = launched_local_size(world) if world > 1 else 1
    data = data_axis_size(world, data, model, batch_size)
    check_covers_ranks(world, data, model, batch_size, local_size)
    device = local[0]
    if device is None and backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    data_group = model_group = None
    if model == 1:
        data_group = dist.group.WORLD if data > 1 else None
    elif data == 1:
        model_group = dist.group.WORLD
    else:
        # collective: every rank creates every group, in this order
        data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
        model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
        data_group, model_group = data_groups[rank % model], model_groups[rank // model]
    return Mesh(data, model, rank, world, device, data_group, backend, model_group=model_group, local_size=local_size)


def _canonical(device: torch.device) -> torch.device:
    """``device`` as a tensor on it names it: ``cuda`` with the current
    card's index, ``cpu`` without one."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        return torch.device("cpu")
    return device


def predictor_devices(mesh: Optional[Mesh], device=None) -> Tuple[torch.device, ...]:
    """The devices a predictor runs its tile shards on, the first one its
    home (the scene canvas, the OR and the fetch): the first device of each
    data row of the mesh, or ``(device,)`` without a mesh.  ``device``
    (default: the card) stands for the entries the mesh leaves unnamed; a
    mesh that names its devices takes no ``device``.  Every device of the
    mesh passes :func:`core.device.check_device`: a card that is not there
    raises here, at set-up.  On a mesh that spans processes it is this
    rank's one device (:func:`rank_device`)."""
    if isinstance(mesh, Mesh) and mesh.world_size > 1:
        return (rank_device(mesh, device),)
    entries = mesh_devices(mesh, device)
    step = 1 if mesh is None else mesh.model
    return entries[::step]


def rank_device(mesh: Mesh, device=None) -> torch.device:
    """This rank's device on a mesh that spans processes: the one the mesh
    pins (NCCL: the card ``init_distributed`` selected), else ``device``,
    else the card; checked as :func:`predictor_devices` says."""
    if mesh.device is not None and device is not None and _canonical(torch.device(device)) != _canonical(mesh.device):
        raise ValueError(f"device {device} contradicts the mesh's device {mesh.device}")
    dev = mesh.device if mesh.device is not None else torch.device(device if device is not None else "cuda")
    check_device(dev)
    return _canonical(dev)


def mesh_devices(mesh: Optional[Mesh], device=None) -> Tuple[torch.device, ...]:
    """Every device of a predictor's mesh, row-major (``data * model``
    entries; ``(device,)`` without a mesh), checked as
    :func:`predictor_devices` says."""
    if mesh is None:
        entries: Tuple[Optional[torch.device], ...] = (None,)
    elif not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a building_detection_tpu_torch.parallel.mesh.Mesh (from make_mesh), "
            f"got {type(mesh).__name__}"
        )
    else:
        check_local(mesh)
        entries = mesh.devices
        if len(entries) != mesh.data * mesh.model:
            raise ValueError(
                f"a predictor's mesh of data={mesh.data} x model={mesh.model} needs its devices: "
                "make_mesh(devices=[...], ...)"
            )
    if device is not None and any(d is not None for d in entries):
        raise ValueError(f"the mesh names its devices {[str(d) for d in entries]}: pass device=None")
    fill = torch.device(device if device is not None else "cuda")
    named = [fill if d is None else d for d in entries]
    for d in dict.fromkeys(named):
        check_device(d)
    return tuple(_canonical(d) for d in named)


def check_local(mesh: Optional[Mesh]) -> None:
    """Raise unless ``mesh`` is ``None`` or lies in this process: a mesh
    that spans processes has one device a rank (:func:`rank_device`), not
    a grid of this process's devices."""
    if isinstance(mesh, Mesh) and mesh.world_size > 1:
        raise NotImplementedError(
            f"this mesh spans {mesh.world_size} processes and each rank drives one device: rank_device(mesh) gives "
            "it, and the predictors (FusedEnsemblePredictor, TiledPredictor, Pipeline(mesh=)) take such a mesh "
            "as it is; a list of devices exists only for a mesh of this process's local devices, "
            "make_mesh(devices=[...])"
        )


def data_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row array sharded over the data axis:
    those of its data index."""
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not split over data={mesh.data}")
    k = n // mesh.data
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of each array of a global host batch (a tuple of
    arrays or tensors whose leading dim divides by ``data``): views, on the
    arrays' own device."""
    return tuple(x[data_rows(mesh, len(x))] for x in batch)


def shard_staged(x, mesh: Mesh):
    """This rank's rows of a staged ``(steps, batch, ...)`` array: its
    second dim is the batch."""
    return x[:, data_rows(mesh, x.shape[1])]


def _check_equal(tensors: Sequence[torch.Tensor], group, what: str) -> None:
    """Raise on every rank of ``group`` unless ``tensors`` are equal on all
    of them: one broadcast of the group's first rank's values, and one
    all-reduce of the verdict, so a rank that differs makes every rank
    raise."""
    if group is None or not tensors:
        return
    mine = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    first = mine.clone()
    dist.broadcast(first, src=dist.get_global_rank(group, 0), group=group)
    differ = (first != mine).any().to(torch.float32).reshape(1)
    dist.all_reduce(differ, group=group)
    if float(differ) > 0:
        raise ValueError(
            f"the {what} tensors differ between ranks ({int(float(differ))} of {dist.get_world_size(group)} ranks "
            "differ from the first): every rank must build the same model from the same seed and weights"
        )


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Check that ``tensors`` are equal on every rank of this rank's data
    axis.  Nothing runs at ``data == 1``."""
    _check_equal(tensors, mesh.group, "replicated")


def check_tp_replicas(sharded: Sequence[torch.Tensor], replicated: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Check the layout of a tensor-parallel model: each rank's ``sharded``
    tensors (its channel slices) equal on every data rank of its model
    index, and the ``replicated`` ones equal on every rank of the run."""
    replicate(sharded, mesh)
    _check_equal(replicated, dist.group.WORLD if mesh.world_size > 1 else None, "replicated")
