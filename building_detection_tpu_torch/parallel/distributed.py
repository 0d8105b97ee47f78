"""Multi-process execution: ``torch.distributed`` bring-up and per-process data.

The counterpart of ``building_detection_tpu/parallel/distributed.py``.  JAX
runs one controller per host over a global mesh; torch runs one process per
device, and every process executes the same steps on its own rows of each
global batch:

* :func:`init_distributed` brings the process group up (idempotent): with
  ``coordinator_address``, ``num_processes`` and ``process_id`` (a
  ``tcp://`` rendezvous), or with no arguments from the ``torchrun``
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
  ``LOCAL_RANK``; ``env://``), where JAX detects a pod; the workers of
  :func:`parallel.launch.launch`, one for each of a process's devices,
  read the same environment.  The backend is
  named, never swapped: ``nccl`` (the default, one card a rank) or
  ``gloo`` (CPU processes, or ranks sharing a card), and a failure to
  start one is raised, not retried with the other;
* per-process feeding: :func:`local_sample_indices` gives the samples a
  rank feeds, in the JAX package's order, and :func:`stage_local_dataset`
  stages only those on the rank's device;
* :func:`is_primary` guards the single writer of checkpoints and history.

The collectives of a train step are in :mod:`parallel.collectives`.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from building_detection_tpu_torch.core.device import check_device
from building_detection_tpu_torch.parallel import mesh as pmesh

TIMEOUT = datetime.timedelta(minutes=5)  # rendezvous and every collective
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> None:
    """Start this process's process group (idempotent).

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous.  With
    no arguments the ``torchrun`` environment is read, as set by torchrun
    or by :func:`parallel.launch.launch`.  ``backend`` is ``'nccl'`` when
    ``None``; pass ``'gloo'`` for CPU processes.  Under NCCL, or when
    ``local_device_ids`` names cards, one card becomes the process's current
    CUDA device (:func:`cuda_index`): ``local_device_ids`` are this
    process's cards, as in ``jax.distributed``, so a launched worker takes
    ``local_device_ids[LOCAL_RANK]``, a process of its own the one card it
    names; else the local rank (``LOCAL_RANK``, or ``process_id``) modulo
    the cards visible.  A process not started by a launcher drives one
    device: several ids there raise a ``ValueError``.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"init_distributed() with no arguments reads the torchrun environment, and {missing} "
                "are unset: launch under torchrun, or pass coordinator_address, num_processes and process_id"
            )
        # env:// reads the same variables, and joins the store torchrun's
        # agent already serves on MASTER_PORT instead of binding it again
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "init_distributed takes coordinator_address ('host:port'), num_processes and process_id "
                "together, or none of them under torchrun"
            )
        if local_device_ids is not None and len(local_device_ids) > 1:
            raise ValueError(
                f"local_device_ids={list(local_device_ids)}: a process started on its own drives one device. "
                "To drive several, start a worker for each with parallel/launch.py (launch(fn, ..., "
                "local_devices=K), or bdt-train/bdt-eval --local-devices K)"
            )
        init_method = f"tcp://{coordinator_address}"
        world, rank, local = int(num_processes), int(process_id), int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside 0..{world - 1}")
    backend = backend or "nccl"
    if backend == "nccl" or local_device_ids is not None:
        check_device(torch.device("cuda"))
        torch.cuda.set_device(cuda_index(local, local_device_ids, torch.cuda.device_count()))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, timeout=TIMEOUT)


def cuda_index(local_rank: int, local_device_ids: Optional[Sequence[int]], n_cards: int) -> int:
    """The card a process drives: with ``local_device_ids`` (this process's
    cards) the one it names, or ``local_device_ids[local_rank]`` for a
    launched worker where it names several; else its local rank modulo
    the ``n_cards`` visible."""
    if local_device_ids is None:
        return local_rank % n_cards
    ids = [int(i) for i in local_device_ids]
    if len(ids) > 1 and not 0 <= local_rank < len(ids):
        raise ValueError(f"local rank {local_rank} has no card in local_device_ids={ids}")
    index = ids[0] if len(ids) == 1 else ids[local_rank]
    if not 0 <= index < n_cards:
        raise ValueError(f"local_device_ids={ids} names no card of the {n_cards} visible")
    return index


def destroy() -> None:
    """Tear the process group down, if there is one (the CLI's ``finally``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that writes checkpoints, history and logs: rank
    0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _owned_rows(mesh: pmesh.Mesh, n_rows: int) -> np.ndarray:
    """Sorted global row indices of an ``n_rows`` batch this rank holds."""
    rows = pmesh.data_rows(mesh, n_rows)
    return np.arange(rows.start, rows.stop, dtype=np.int64)


def local_sample_indices(n_samples: int, batch_size: int, mesh: pmesh.Mesh) -> np.ndarray:
    """Global sample indices this rank must feed, in feeding order, for a
    dataset iterated in global batches of ``batch_size`` (batch k = samples
    ``[k*b, (k+1)*b)``): its rows of every complete batch.  One process
    feeds ``arange(steps * batch_size)``.  ``mesh`` must be the trainer's."""
    batch_rows = _owned_rows(mesh, batch_size)
    steps = n_samples // batch_size
    return (np.arange(steps, dtype=np.int64)[:, None] * batch_size + batch_rows).reshape(-1)


def stage_local_dataset(trainer, images_local, labels_local) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-process :meth:`Trainer.stage_dataset`: each rank passes only
    the samples :func:`local_sample_indices` gave it (ascending order) and
    gets its ``(steps, batch / data, ...)`` part of the staged dataset on
    its device.  One process: equal to ``trainer.stage_dataset``.  The
    upload stands where the JAX package's ``global_from_local`` stands: a
    rank's part is its rows, and no process holds the global array."""
    images_local = np.asarray(images_local)
    labels_local = np.asarray(labels_local)
    b_local = len(_owned_rows(trainer.mesh, trainer.cfg.batch_size))
    if b_local == 0:
        raise ValueError("this process owns no rows of the data axis")
    steps = len(images_local) // b_local
    if steps == 0:
        raise ValueError(f"need at least one local batch of {b_local} samples")
    n = steps * b_local
    imgs = images_local[:n].reshape((steps, b_local) + images_local.shape[1:])
    labs = labels_local[:n].reshape((steps, b_local) + labels_local.shape[1:])
    return trainer._to_device(imgs), trainer._to_device(labs)
