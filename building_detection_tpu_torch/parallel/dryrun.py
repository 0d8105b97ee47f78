"""One real data-parallel training step over several processes.

The port's counterpart of the JAX package's ``dryrun_multichip`` (in
``__graft_entry__.py``).  :func:`dryrun_multichip` starts ``n_devices``
processes of this module, each one rank of a ``torch.distributed`` group
(NCCL with one card a rank by default, Gloo on the CPU when asked), and
each trains res34 for one step at 32 px on a global batch of one sample a
rank.  Every rank prints its loss and a digest of its params and BN
state; the ranks must agree bit for bit.

    python -m building_detection_tpu_torch.parallel.dryrun 4                # four NCCL ranks, one card each
    python -m building_detection_tpu_torch.parallel.dryrun 2 --device cpu   # two Gloo CPU processes

:func:`free_port` and :func:`run_processes` are the launch helpers it uses:
explicit environments, each child in its own session, output to files, a
deadline, and every child still running stopped by its pid when one fails
or the deadline passes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from building_detection_tpu_torch.core.device import check_device

REPO = Path(__file__).resolve().parents[2]
SIZE = 32  # tiny tiles: the production program's structure at seconds a step
RESULT = "dryrun result "


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago (bind to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """A copy of this process's environment with the checkout on
    ``PYTHONPATH`` and ``extra`` on top; the caller's ``os.environ`` is not
    touched."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def run_processes(
    argvs: Sequence[Sequence[str]], env: Dict[str, str], timeout: float, cwd: Optional[str] = None
) -> List[Tuple[int, str]]:
    """Run one process per argv side by side; ``(returncode, output)`` each.

    Each child gets ``env``, its own session (``start_new_session``) and a
    file for its output.  When one exits non-zero, or ``timeout`` seconds
    pass, every child still running is stopped by its pid (SIGTERM, then
    SIGKILL after 10 s), so a rank that died cannot leave the others
    waiting in a collective."""
    with tempfile.TemporaryDirectory(prefix="bdt_ranks_") as logs:
        files = [open(os.path.join(logs, f"{i}.log"), "w+") for i in range(len(argvs))]
        procs = []
        try:
            for argv, f in zip(argvs, files):
                procs.append(subprocess.Popen(
                    list(argv), env=env, cwd=cwd, stdout=f, stderr=subprocess.STDOUT, start_new_session=True
                ))
            deadline = time.monotonic() + timeout
            timed_out = False
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=60)
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read() + (f"\n[killed after the {timeout:.0f} s deadline]" if timed_out else ""))
            f.close()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def digest(model) -> str:
    """sha256 of a model's params and buffers, in ``state_dict`` order."""
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _worker(rank: int, world: int, port: int, device: str) -> None:
    import numpy as np
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.parallel import distributed as pdist
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from building_detection_tpu_torch.train.trainer import Trainer

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    pdist.init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo" if device == "cpu" else "nccl")
    try:
        mesh = make_mesh(data=world)
        cfg = TrainConfig(batch_size=world, epochs=1, warmup_epochs=1, image_size=SIZE)
        trainer = Trainer("res34", cfg, steps_per_epoch=2, mesh=mesh, device=None if device == "cuda" else device)
        rng = np.random.RandomState(0)
        images = rng.randint(0, 256, (world, SIZE, SIZE, 3), np.uint8)
        labels = np.where(rng.rand(world, SIZE, SIZE) < 0.3, 255, 0).astype(np.uint8)
        metrics = trainer.train_on_batch(images, labels)
        if not np.isfinite(metrics["loss"]):
            raise RuntimeError(f"rank {rank}: non-finite loss {metrics}")
        out = {"rank": rank, "device": str(trainer.device), "loss": metrics["loss"], "PA": metrics["PA"],
               "digest": digest(trainer.model)}
        print(RESULT + json.dumps(out), flush=True)
    finally:
        pdist.destroy()


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> List[dict]:
    """One data-parallel res34 train step over ``n_devices`` processes
    (NCCL over ``n_devices`` cards, or Gloo on the CPU with
    ``device='cpu'``); raises unless every rank finishes with the same
    loss and the same params and BN state, bit for bit.  Returns the ranks'
    results.  Raises before it starts anything when ``device='cuda'`` and
    torch sees no card."""
    check_device(torch.device(device))
    port = free_port()
    argvs = [[sys.executable, "-m", "building_detection_tpu_torch.parallel.dryrun", str(n_devices), "--device",
              device, "--worker", str(rank), "--port", str(port)] for rank in range(n_devices)]
    runs = run_processes(argvs, port_env(), timeout, cwd=str(REPO))
    results = []
    for rank, (rc, out) in enumerate(runs):
        if rc != 0:
            raise RuntimeError(f"dryrun rank {rank} exited {rc}:\n{out[-4000:]}")
        results.append(json.loads(next(ln for ln in out.splitlines() if ln.startswith(RESULT))[len(RESULT):]))
    first = results[0]
    for r in results[1:]:
        if (r["loss"], r["digest"]) != (first["loss"], first["digest"]):
            raise RuntimeError(f"ranks disagree after the step: {results}")
    print(f"dryrun_multichip({n_devices}): dp train step ok over {n_devices} {device} process(es), "
          f"loss={first['loss']:.4f} PA={first['PA']:.4f}, every rank's params and BN state bit-identical",
          flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One data-parallel res34 train step over several processes.")
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    p.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker, args.n_devices, args.port, args.device)
    else:
        dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
