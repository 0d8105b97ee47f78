"""Training CLI of the port: ``bdt-train``, on one device or data-parallel over processes.

    python -m building_detection_tpu_torch.cli.train res34 \\
        --train-images data/train/img --train-labels data/train/lab \\
        --checkpoint-dir weights1 --device cuda

The flags are ``building_detection_tpu/cli/train.py``'s, with ``--device``
added.  A dataset that fits the host budget is decoded up front and handed
to :meth:`Trainer.fit_arrays` (staged on the device when it fits there);
a larger one streams from disk through :meth:`Trainer.fit`.

Data-parallel training runs one worker per device.  With no process flags
``bdt-train`` trains on every visible card, as the JAX package's takes every
local device: ``--local-devices K`` (default: the cards visible; 1 with
``--device cpu`` or a numbered card) workers, capped at ``gcd(batch size,
K)`` under ``--data-parallel -1`` as the JAX package caps its data axis, are
started by ``parallel/launch.py`` with the same arguments, one a card.  Over
several processes (machines) each runs the same arguments plus
``--coordinator HOST:PORT --num-processes N --process-id I``, with one
worker a process by default (the contract before the launcher), or
``--local-devices K`` workers each (the hybrid: worker ``k`` of process
``p`` is rank ``p * K + k``); under ``torchrun --nproc-per-node N`` pass
``--num-processes 0``.  The backend follows ``--device``: NCCL for cards
(a worker on the card of its local rank), Gloo for ``--device cpu``.  Each
worker decodes only its rows of every global batch and says so (``process
P worker k rank r: feeding N samples``; ``process r: ...`` where a process
runs one), the gradients and the BatchNorm statistics are reduced over all
workers, and rank 0 alone writes checkpoints and history.
"""
from __future__ import annotations

import argparse
import copy
import glob
import os
import re
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bdt-train", description="Train one zoo model with the reference recipe (PyTorch port)."
    )
    p.add_argument("model", choices=["res34", "hrnet", "v3plus", "scse", "bam"])
    p.add_argument("--train-images", required=True)
    p.add_argument("--train-labels", required=True)
    p.add_argument("--val-images")
    p.add_argument("--val-labels")
    p.add_argument("--checkpoint-dir", default="weights1")
    p.add_argument("--resume", help="checkpoint to resume from (exact, incl. optimizer)")
    p.add_argument(
        "--init-weights",
        help="weights-only init (.npz) for transfer learning; optimizer, schedule and step "
        "start fresh (use --resume for exact resume)",
    )
    p.add_argument(
        "--auto-resume", action="store_true",
        help="resume from the newest epoch_N_weights.npz in --checkpoint-dir",
    )
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--warmup-epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument(
        "--loss", choices=["edge_focal_loss", "focal_loss", "binary_crossentropy"], default="edge_focal_loss"
    )
    p.add_argument("--augment-seed", type=int, help="enable on-device augmentation")
    p.add_argument(
        "--shuffle", action="store_true",
        help="shuffle the dataset (opt-in; the reference cycles sorted file order)",
    )
    p.add_argument("--shuffle-seed", type=int, default=0)
    p.add_argument("--precision", choices=["bf16", "f32"], default="bf16", help="compute dtype of the step")
    p.add_argument("--device", default="cuda", help="torch device to train on (no fallback)")
    p.add_argument(
        "--data-parallel", type=int, default=-1,
        help="processes on the data axis (-1: all, capped at gcd(batch size, processes))",
    )
    add_process_flags(p, "training")
    return p


def add_process_flags(p: argparse.ArgumentParser, what: str) -> None:
    """``--coordinator``, ``--num-processes`` and ``--process-id``, read by
    :func:`start_processes`."""
    p.add_argument(
        "--coordinator",
        help=f"multi-process {what}: host:port of process 0's rendezvous; launch one process per device with "
        "identical arguments plus --num-processes/--process-id (--num-processes 0 reads the torchrun "
        "environment); each process handles only its rows of every batch, process 0 alone writes",
    )
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument(
        "--local-devices", type=int,
        help=f"{what} workers this process starts, one a device, through parallel/launch.py (default: every "
        "visible card without process flags, capped at gcd(batch size, cards) under --data-parallel -1; 1 with "
        "--device cpu, a numbered card, or --coordinator/--num-processes/--process-id)",
    )


def newest_checkpoint(checkpoint_dir: str):
    """The ``epoch_N_weights.npz`` with the largest N, or None."""
    candidates = glob.glob(os.path.join(checkpoint_dir, "epoch_*_weights.npz"))
    if not candidates:
        return None
    return max(candidates, key=lambda p: int(re.search(r"epoch_(\d+)_", p).group(1)))


def decode_all(pairs, image_size: int):
    import numpy as np

    from building_detection_tpu_torch.data.dataset import decode_pair

    decoded = [decode_pair(ip, lp, image_size) for ip, lp in pairs]
    return np.stack([d[0] for d in decoded]), np.stack([d[1] for d in decoded])


def start_processes(parser: argparse.ArgumentParser, args, what: str):
    """Bring up the process group a multi-process run's flags ask for
    (``--coordinator``, ``--num-processes``, ``--process-id``, or
    ``--num-processes 0`` under ``torchrun``): NCCL when ``--device`` is a
    card, Gloo otherwise.  Incomplete flags exit with a usage error naming
    them.  Returns :mod:`parallel.distributed`, whose ``destroy`` the
    caller runs in a ``finally``."""
    multi = args.coordinator is not None or args.num_processes is not None or args.process_id is not None
    if multi and args.num_processes != 0 and None in (args.coordinator, args.num_processes, args.process_id):
        parser.error(
            f"multi-process {what} takes --coordinator HOST:PORT, --num-processes N and --process-id I "
            "together (or --num-processes 0 under torchrun)"
        )

    import torch

    from building_detection_tpu_torch.parallel import distributed as pdist

    if multi:
        backend = "nccl" if torch.device(args.device).type == "cuda" else "gloo"
        if args.num_processes == 0:
            pdist.init_distributed(backend=backend)
        else:
            pdist.init_distributed(args.coordinator, args.num_processes, args.process_id, backend=backend)
    return pdist


def local_workers(parser: argparse.ArgumentParser, args, what: str) -> int:
    """The workers this process starts (``--local-devices``, or its
    default), after the JAX package's cap: with no process flags and
    ``--data-parallel -1``, ``gcd(batch size, K)``; an explicit
    ``--data-parallel D`` takes the first ``D`` of the ``K`` devices.  Over
    several processes every worker starts and the mesh checks the cover."""
    import torch

    from building_detection_tpu_torch.parallel.mesh import data_axis_size

    multi = args.coordinator is not None or args.num_processes is not None or args.process_id is not None
    device = torch.device(args.device)
    if args.local_devices is not None:
        if args.num_processes == 0:
            parser.error(
                f"--local-devices with --num-processes 0: torchrun already started the {what} workers, one a "
                "device; pass --nproc-per-node to torchrun instead"
            )
        if args.local_devices < 1:
            parser.error(f"--local-devices {args.local_devices}: at least one device")
        k = args.local_devices
    elif multi or device.type != "cuda" or device.index is not None:
        return 1
    else:
        k = max(torch.cuda.device_count(), 1)  # no card: one in-process worker, which raises
    if multi:
        return k
    if args.data_parallel > k:
        parser.error(f"--data-parallel {args.data_parallel} needs {args.data_parallel} devices and this process "
                     f"has {k} (--local-devices)")
    return data_axis_size(k, args.data_parallel, 1, args.batch_size)


def run(parser: argparse.ArgumentParser, args, body, what: str) -> int:
    """``body(args)`` in this process, or, where :func:`local_workers` asks
    for several, on that many workers started by ``parallel/launch.py``
    (each re-entering ``body`` with ``--num-processes 0`` and rank 0
    writing); a failed worker makes the run exit 1 with its rank and error."""
    workers = local_workers(parser, args, what)
    if workers == 1:
        pdist = start_processes(parser, args, what)
        try:
            return body(args)
        finally:
            pdist.destroy()

    import torch

    from building_detection_tpu_torch.parallel import launch

    cuda = torch.device(args.device).type == "cuda"
    procs, pid = args.num_processes or 1, args.process_id or 0
    print(f"process {pid}: starting {workers} {what} worker(s), ranks {pid * workers}..{(pid + 1) * workers - 1} "
          f"of {procs * workers}, {'NCCL, a card each' if cuda else 'Gloo, on the CPU'}"
          + (f" (--local-devices {args.local_devices})" if args.local_devices else ""), flush=True)
    inner = copy.copy(args)
    inner.coordinator, inner.num_processes, inner.process_id, inner.local_devices = None, 0, None, None
    try:
        launch.launch(body, inner, local_devices=workers, coordinator=args.coordinator, num_processes=procs,
                      process_id=pid, backend="nccl" if cuda else "gloo", device_type="cuda" if cuda else "cpu")
    except launch.WorkerFailed as e:
        print(f"{what} failed: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    return run(parser, parser.parse_args(argv), train, "training")


def local_pairs(pairs, batch_size: int, trainer, verb: str):
    """This rank's share of ``pairs`` under a multi-process mesh (its rows
    of every complete global batch), announced as ``process P worker k rank
    r: <verb> n samples`` (``process r: ...`` where a process runs one
    worker); all of ``pairs`` otherwise."""
    from building_detection_tpu_torch.parallel import distributed as pdist

    mesh = trainer.mesh
    if mesh.world_size == 1:
        return pairs
    idx = pdist.local_sample_indices(len(pairs), batch_size, mesh)
    if len(idx) == 0:
        raise SystemExit(
            f"multi-process training needs at least one complete global batch ({batch_size} samples; got "
            f"{len(pairs)}) and every process must own rows of the data axis"
        )
    who = f"process {mesh.process_index} worker {mesh.local_rank} rank {mesh.rank}" if mesh.local_size > 1 else (
        f"process {mesh.rank}")
    print(f"{who}: {verb} {len(idx)} samples", flush=True)
    return [pairs[i] for i in idx]


def train(args) -> int:
    import torch

    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.data.dataset import batch_iterator, list_pairs, prefetch
    from building_detection_tpu_torch.parallel import distributed as pdist
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from building_detection_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(
        batch_size=args.batch_size,
        epochs=args.epochs,
        warmup_epochs=args.warmup_epochs,
        lr_base=args.lr,
        loss=args.loss,
        image_size=args.image_size,
    )
    train_pairs = list_pairs(args.train_images, args.train_labels)
    print(f"training samples: {len(train_pairs)}")
    trainer = Trainer(
        args.model,
        cfg,
        steps_per_epoch=max(len(train_pairs) // cfg.batch_size, 1),
        mesh=make_mesh(data=args.data_parallel, batch_size=cfg.batch_size),
        compute_dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        augment=args.augment_seed is not None,
        augment_seed=args.augment_seed or 0,
        device=args.device,
    )
    resume_path = args.resume
    if args.auto_resume and not resume_path:
        resume_path = newest_checkpoint(args.checkpoint_dir)
    if resume_path and args.init_weights:
        raise SystemExit("--init-weights conflicts with --resume/--auto-resume: exact resume already restores the weights")
    if resume_path:
        trainer.restore(resume_path)
        print(f"resumed from {resume_path} at step {trainer.step}")
    elif args.init_weights:
        trainer.load_weights(args.init_weights)
        print(f"initialised weights from {args.init_weights} (fresh optimizer)")

    val_pairs = list_pairs(args.val_images, args.val_labels) if args.val_images and args.val_labels else []
    if val_pairs:
        print(f"validation samples: {len(val_pairs)}")
    # Host memory ceiling for decoding the whole dataset up front; past it,
    # stream from disk per step.  BDT_HOST_DECODE_BUDGET overrides (bytes).
    host_budget = int(os.environ.get("BDT_HOST_DECODE_BUDGET", 16 << 30))
    multi = trainer.mesh.world_size > 1
    if len(train_pairs) * (cfg.image_size ** 2) * 4 <= host_budget:
        images, labels = decode_all(local_pairs(train_pairs, cfg.batch_size, trainer, "feeding"), cfg.image_size)
        val_images, val_labels = decode_all(val_pairs, cfg.image_size) if val_pairs else (None, None)
        trainer.fit_arrays(
            images, labels, val_images, val_labels, checkpoint_dir=args.checkpoint_dir,
            shuffle=args.shuffle, shuffle_seed=args.shuffle_seed, from_process_local=multi,
        )
        return 0

    # streamed: each process reads only its rows of every global batch; the
    # per-pass shuffle stays aligned across processes (every local list has
    # the same length, so the seeded permutation is the same on all of them)
    stream_pairs = local_pairs(train_pairs, cfg.batch_size, trainer, "streaming")
    stream_batch = len(pdist._owned_rows(trainer.mesh, cfg.batch_size))
    train_iter = prefetch(batch_iterator(
        stream_pairs, stream_batch, cfg.image_size, shuffle=args.shuffle, seed=args.shuffle_seed
    ))
    val_iter, val_steps = None, 0
    if val_pairs:
        val_iter = batch_iterator(val_pairs, cfg.batch_size, cfg.image_size)
        val_steps = max(len(val_pairs) // cfg.batch_size, 1)
    trainer.fit(train_iter, val_iter, val_steps, checkpoint_dir=args.checkpoint_dir, from_process_local=multi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
