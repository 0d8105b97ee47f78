"""A process per local device: the port's counterpart of ``jax.devices()``.

JAX drives every local device of a host from one process (one controller),
and several hosts join through ``jax.distributed``.  The port drives one
device a process (``parallel/distributed.py``), so a process that should use
its K local devices starts K workers, one a device, and those of every
process join one ``torch.distributed`` group:

* :func:`launch` starts ``local_devices`` workers on this process's devices
  through torch's elastic launcher (``torch.distributed.launcher.api``) with
  a static rendezvous: the node rank is ``process_id``, the world
  ``num_processes * local_devices``, so worker ``k`` of process ``p`` is
  rank ``p * K + k``, the place of JAX's device ``k`` of process ``p`` in
  its process-major global device list, and the port's data index ``rank //
  model`` gives each worker the rows JAX gives that device.  Each worker
  brings the process group up from the launcher's environment
  (:func:`parallel.distributed.init_distributed` with no address), runs
  ``fn(*args)`` and tears the group down; ``launch`` returns the value of
  this process's first worker, which on process 0 is rank 0's;
* the rendezvous is ``coordinator`` (``host:port``, process 0's store), or,
  with one process and no coordinator, ``127.0.0.1`` on a free port;
* there is no retry and no fallback to fewer devices: a worker that fails
  stops this process's other workers, and :func:`launch` raises
  :class:`WorkerFailed` naming its rank, its exit code and its error;
* under NCCL, more workers than cards raises before anything starts (two
  NCCL ranks cannot share a card); Gloo workers may share one (worker ``k``
  on card ``k % cards``).

``fn`` and ``args`` are pickled to spawned interpreters: ``fn`` must be a
module-level function of an importable module (the CLIs pass their own).

    python -m building_detection_tpu_torch.cli.train res34 ... --device cuda                  # every card
    python -m building_detection_tpu_torch.cli.train res34 ... --coordinator HOST:PORT \\
        --num-processes 2 --process-id I --local-devices 4                                    # 2 x 4 cards
"""
from __future__ import annotations

import glob
import json
import os
import tempfile
import uuid
from typing import Any, Dict, List, Optional

import torch

from building_detection_tpu_torch.core.device import check_device


class WorkerFailed(RuntimeError):
    """A launched worker failed; the message names each failed rank and its error."""


def _worker(fn, args, backend: str, local_device_ids) -> Any:
    """One launched worker: the process group from the launcher's
    environment, ``fn(*args)``, the group torn down.  An exception leaves
    the group up, so the worker's error file is written before its peers
    see it go (at its exit) and fail in their next collective."""
    from building_detection_tpu_torch.parallel import distributed as pdist

    pdist.init_distributed(backend=backend, local_device_ids=local_device_ids)
    value = fn(*args)
    pdist.destroy()
    return value


def _error(message) -> str:
    """A failed worker's error as its error file records it: the exception
    and its traceback."""
    if isinstance(message, dict):
        stack = message.get("extraInfo", {}).get("py_callstack", "")
        return f"{message.get('message', '')}\n{stack}".rstrip()
    return str(message)


def _recorded_errors(log_dir: str) -> Dict[int, str]:
    """{local rank: error} of every worker that wrote an error file under
    ``log_dir`` (``.../attempt_0/<local rank>/error.json``).  Elastic reports
    only the first failure it polls, which may be a peer that failed in a
    collective after the first one died; the files hold each one's own."""
    errors = {}
    for path in glob.glob(os.path.join(log_dir, "*", "attempt_*", "*", "error.json")):
        try:
            with open(path) as f:
                errors[int(os.path.basename(os.path.dirname(path)))] = _error(json.load(f).get("message", ""))
        except (OSError, ValueError):
            continue  # a file a killed worker left half written
    return errors


def worker_cards(local_devices: int, backend: str, device_type: str) -> Optional[List[int]]:
    """The card of each of ``local_devices`` workers (``None`` on the CPU):
    worker ``k`` on card ``k``, or on card ``k % cards`` under Gloo.  A
    card must be there (no fallback), and under NCCL each worker needs a
    card of its own."""
    if device_type != "cuda":
        return None
    check_device(torch.device("cuda"))
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_devices > cards:
        raise ValueError(
            f"{local_devices} NCCL workers need {local_devices} cards and torch sees {cards}: pass "
            f"--local-devices {cards} or fewer (two NCCL ranks cannot share a card; Gloo workers can)"
        )
    return [k % cards for k in range(local_devices)]


def launch(
    fn,
    *args,
    local_devices: int,
    coordinator: Optional[str] = None,
    num_processes: int = 1,
    process_id: int = 0,
    backend: str = "nccl",
    device_type: str = "cuda",
) -> Any:
    """Run ``fn(*args)`` on ``local_devices`` workers of this process, each
    one rank of a group of ``num_processes * local_devices`` (``backend``:
    ``'nccl'``, one card a worker, or ``'gloo'``); returns the value of
    this process's first worker.  ``device_type='cpu'`` runs Gloo workers
    on the CPU; on cards worker ``k`` drives card ``k`` (``k % cards``
    under Gloo, which may share them).  Every launcher process
    of a run passes the same ``coordinator``, ``num_processes`` and
    ``local_devices`` and its own ``process_id``."""
    from torch.distributed.elastic.multiprocessing import DefaultLogsSpecs
    from torch.distributed.elastic.multiprocessing.errors import ChildFailedError
    from torch.distributed.launcher.api import LaunchConfig, elastic_launch

    from building_detection_tpu_torch.parallel.dryrun import free_port

    if local_devices < 1 or num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"launch needs local_devices >= 1 and 0 <= process_id < num_processes, got local_devices="
            f"{local_devices}, num_processes={num_processes}, process_id={process_id}"
        )
    if device_type == "cpu" and backend != "gloo":
        raise ValueError(f"CPU workers run Gloo, not {backend}")
    ids = worker_cards(local_devices, backend, device_type)
    if coordinator is None:
        if num_processes > 1:
            raise ValueError(f"{num_processes} launcher processes need a coordinator address (host:port)")
        coordinator = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="bdt_launch_") as log_dir:
        # only fields that every torch since 2.3 has; the workers' output is not redirected
        config = LaunchConfig(
            min_nodes=num_processes,
            max_nodes=num_processes,
            nproc_per_node=local_devices,
            run_id=f"bdt-{uuid.uuid5(uuid.NAMESPACE_URL, coordinator).hex[:12]}",  # the same on every process
            rdzv_endpoint=coordinator,
            rdzv_backend="static",
            rdzv_configs={"rank": process_id},
            max_restarts=0,
            monitor_interval=0.1,
            start_method="spawn",
            logs_specs=DefaultLogsSpecs(log_dir=log_dir),
        )
        try:
            values = elastic_launch(config, _worker)(fn, args, backend, ids)
        except ChildFailedError as e:
            errors = {f.local_rank: _error(f.message) for f in e.failures.values()}
            errors.update(_recorded_errors(log_dir))
            ranks = [process_id * local_devices + k for k in sorted(errors)]
            lines = [f"worker rank {process_id * local_devices + k} (process {process_id} worker {k}) failed: "
                     f"{errors[k]}" for k in sorted(errors)]
            raise WorkerFailed(
                f"{len(ranks)} of this process's {local_devices} worker(s) failed, rank(s) {ranks}:\n"
                + "\n".join(lines)
            ) from None
    return values[process_id * local_devices]
