"""Training engine on one device: the counterpart of ``building_detection_tpu/train/trainer.py``.

The reference harness (batch 8, 30 epochs, 3 warmup epochs, lr 1e-3 from
1e-5, ``edge_focal_loss``, PA/IoU/MIoU/F1) with the JAX package's changes
kept:

* the training targets, the edge-weight bands included, are made from the
  raw uint8 labels inside every step on the step's device
  (:func:`make_targets`; on a card it launches the hand-written kernel of
  ``csrc/edge_weights.cu``);
* the warmup-cosine schedule is a function of the step, evaluated by Keras
  Adam at the update count before the increment (:mod:`train.optim`);
* augmentation runs on the step's device from decisions keyed on the
  global step (:mod:`data.augment`);
* checkpoints carry params, BN state, optimizer state and step in the JAX
  package's ``.npz`` format, so resume is exact and either package restores
  the other's.

Params stay f32; ``compute_dtype`` is what the layers compute in (each
param is cast where it is used, so gradients land on the f32 params).
:meth:`Trainer.train_on_batch` and :meth:`Trainer.train_epoch_staged` run
one step body, so on one device the two paths give the same bits.

``remat=True`` rematerialises the forward stage by stage
(:func:`nn.layers.stage`); the numbers do not change.

``mesh`` (:func:`parallel.mesh.make_mesh`) trains data-parallel over the
processes of a ``torch.distributed`` run, one device each, as the JAX
package's ``Trainer(mesh=...)`` does over a mesh's data axis:

* every rank builds the same weights from the same seed, checked equal by
  one broadcast at set-up (:func:`parallel.mesh.replicate`);
* host batches are the global batch on every rank, and each rank takes its
  rows; staged datasets and the prefetcher hold only those rows;
* augmentation draws its decisions for the global batch and takes the
  rank's rows, train-mode BatchNorm normalises with the global batch's
  statistics, the gradients are averaged over the ranks by one all-reduce
  before Keras Adam, and the metrics come from the global confusion counts;
* only the primary (rank 0) writes checkpoints and ``history.json``.

At ``data == 1`` (no process group, or world size 1) no collective runs and
the step is the single-device step bit for bit.  A mesh of several local
devices (the predictors' tile data parallelism) is refused with a
``ValueError``: training runs one process per device, and
``parallel/launch.py`` starts one worker for each of a process's devices,
where JAX's ``Trainer()`` takes every local device.

``tp=True`` on a mesh with ``model > 1`` (``make_mesh(data, model)`` over
``data * model`` processes) trains with channel tensor parallelism, as the
JAX package's ``Trainer(tp=True)`` does (``parallel/tp.py``): each rank
holds its model index's slice of every sharded parameter, of its Keras Adam
moments and of the BatchNorm statistics; the sharded layers gather their
channels over the model group, BatchNorm takes its statistics over the data
group, and the gradients, loss and metrics are reduced over the data group.
:meth:`save` gathers the slices (every rank calls it; the primary writes
the same ``.npz`` as a plain trainer), and :meth:`restore` and
:meth:`load_weights` cut a checkpoint into them.  Without a model axis
``tp`` changes nothing.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from building_detection_tpu_torch.core.config import AugmentConfig, TrainConfig
from building_detection_tpu_torch.core.device import check_device
from building_detection_tpu_torch.core.module import (
    init_layers,
    jax_params,
    jax_templates,
    jax_variables,
    load_jax_variables,
    set_compute_dtype,
    set_data_group,
    set_remat,
)
from building_detection_tpu_torch.data.augment import augment_batch
from building_detection_tpu_torch.data.prefetch import device_prefetch
from building_detection_tpu_torch.models.registry import build_model
from building_detection_tpu_torch.ops import tiling as T
from building_detection_tpu_torch.ops.morphology import edge_weight_maps
from building_detection_tpu_torch.parallel import collectives
from building_detection_tpu_torch.parallel import distributed as pdist
from building_detection_tpu_torch.parallel import mesh as pmesh
from building_detection_tpu_torch.parallel import tp as ptp
from building_detection_tpu_torch.train import checkpoint as ckpt
from building_detection_tpu_torch.train.losses import LOSSES
from building_detection_tpu_torch.train.metrics import all_metrics
from building_detection_tpu_torch.train.optim import KerasAdam
from building_detection_tpu_torch.train.schedule import warmup_cosine


def make_targets(
    labels_u8: torch.Tensor,
    cfg: TrainConfig = TrainConfig(),
    label_smooth: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """uint8 {0,255} labels ``(N, H, W)`` -> ``(N, H, W, 4)`` y_true on the
    labels' device: the one-hot class by an exact-1.0 test (``to_categorical``
    truncates), then the f_edge and p_edge bands from the 3x3 x5 erosion and
    dilation.  ``label_smooth=(pos, neg)`` maps one-hot 1 -> pos, 0 -> neg."""
    label = labels_u8.to(torch.float32) / 255.0
    is_building = (label == 1.0).to(torch.float32)
    one_hot = torch.stack([1.0 - is_building, is_building], dim=-1)
    if label_smooth is not None:
        pos, neg = label_smooth
        one_hot = torch.where(one_hot == 1.0, pos, neg)
    f_edge, p_edge = edge_weight_maps(label, cfg.edge_kernel, cfg.edge_iterations, cfg.edge_weight)
    return torch.cat([one_hot, f_edge[..., None], p_edge[..., None]], dim=-1)


Metrics = Dict[str, torch.Tensor]


def _resolve_device(device, mesh: pmesh.Mesh) -> torch.device:
    """The trainer's device: ``device`` if given, else the mesh's, else the
    card (the current CUDA device, the one ``init_distributed`` selected).
    A ``device`` the mesh contradicts (another device than the one it pins,
    or anything but a card under NCCL) raises, as a card torch cannot see
    does."""
    dev = torch.device(device) if device is not None else (mesh.device or torch.device("cuda"))
    check_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    pinned = mesh.device
    if pinned is not None and pinned.type == "cuda" and pinned.index is None and dev.type == "cuda":
        pinned = dev  # the mesh pins a card, not which one
    if pinned is not None and dev != pinned:
        raise ValueError(f"device {dev} contradicts the mesh's device {mesh.device}")
    if mesh.backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"device {dev} cannot train under the mesh's NCCL process group (cards only)")
    return dev


class Trainer:
    """One model trained on one ``device``: the mesh's, else the card, or
    ``'cpu'`` when asked; data-parallel over the ranks of ``mesh``.

    ``model_name`` is a registry name or a callable returning a model built
    from the port's layers (its weights are drawn with
    ``torch.Generator().manual_seed(seed)``).  There is no fallback: asking
    for a card that is not there raises, and so does a ``device`` the mesh
    contradicts.  ``augment`` is ``True`` or an ``AugmentConfig``.
    """

    def __init__(
        self,
        model_name: Union[str, Callable[[], torch.nn.Module]],
        cfg: TrainConfig = TrainConfig(),
        steps_per_epoch: int = 100,
        mesh=None,
        compute_dtype: torch.dtype = torch.float32,
        seed: int = 0,
        remat: bool = False,
        augment=None,
        augment_seed: int = 0,
        tp: bool = False,
        device: Union[None, str, torch.device] = None,
    ):
        if mesh is None:
            mesh = pmesh.Mesh(1, 1, 0, 1)  # this process alone, whatever process group exists
        elif not isinstance(mesh, pmesh.Mesh):
            raise TypeError(
                f"mesh must be a building_detection_tpu_torch.parallel.mesh.Mesh (from make_mesh), "
                f"got {type(mesh).__name__}"
            )
        if len(mesh.devices) > 1:
            raise ValueError(
                f"a mesh of {len(mesh.devices)} local devices is for inference: training runs one process per "
                "device. To train over this process's devices, start a worker a device with parallel/launch.py, "
                f"launch(fn, ..., local_devices={len(mesh.devices)}) where fn builds Trainer(name, cfg, "
                f"mesh=make_mesh()), or run bdt-train --local-devices {len(mesh.devices)}; over several processes "
                "add --coordinator HOST:PORT --num-processes N --process-id I (or run under torchrun "
                "--nproc-per-node N ... --num-processes 0)"
            )
        self.mesh = mesh
        self.tp = bool(tp) and mesh.model > 1
        self.device = _resolve_device(device, mesh)
        if isinstance(model_name, str):
            self.model_name, model = model_name, build_model(model_name)
        else:
            self.model_name, model = getattr(model_name, "__name__", "custom"), model_name()
        init_layers(model, torch.Generator().manual_seed(seed))
        model = set_remat(set_compute_dtype(model.to(self.device), compute_dtype), remat)
        self.model = set_data_group(model, mesh.group)
        if self.tp:
            ptp.tp_shard(self.model, mesh)
        self._check_replicas()
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.compute_dtype = compute_dtype
        self.schedule = warmup_cosine(
            learning_rate_base=cfg.lr_base,
            total_steps=cfg.epochs * steps_per_epoch,
            warmup_learning_rate=cfg.warmup_lr,
            warmup_steps=cfg.warmup_epochs * steps_per_epoch,
            min_learn_rate=cfg.min_lr,
        )
        self.optimizer = KerasAdam(jax_params(self.model), self.schedule, eps=1e-7)
        self.loss_fn = LOSSES[cfg.loss]
        self.augment_cfg = AugmentConfig() if augment is True else (augment or None)
        self.augment_seed = augment_seed
        self.step = 0
        self.history: list = []

    def _check_replicas(self) -> None:
        """Every rank's weights as the mesh says: a TP slice equal on the
        data ranks of its model index, the rest equal on every rank."""
        pmesh.check_tp_replicas(*ptp.tp_tensors(self.model), self.mesh)

    # -- the step -------------------------------------------------------------
    def _to_device(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return t.to(self.device)

    def _global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global batch's loss: the mean of the ranks' equal-sized
        local means."""
        if self.mesh.group is None:
            return loss
        return collectives.all_reduce_mean([loss.reshape(1)], self.mesh.group)[0].reshape(())

    def _train_step(self, images_u8: torch.Tensor, labels_u8: torch.Tensor, step: int) -> Metrics:
        """The one step body of both paths, on this rank's rows: augment,
        normalise, targets, forward in train mode, loss, gradients (averaged
        over the ranks), Keras Adam; the metrics are of the forward before
        the update, over the global batch."""
        cfg = self.cfg
        if self.augment_cfg is not None:
            images_u8, labels_u8 = augment_batch(
                images_u8, labels_u8, self.augment_seed, step, self.augment_cfg,
                shard=(self.mesh.data_index, self.mesh.data),
            )
        x = T.normalize(images_u8, dtype=self.compute_dtype)
        y_true = make_targets(labels_u8, cfg, cfg.label_smooth)
        self.model.train()
        probs = self.model(x).float()
        loss = self.loss_fn(y_true, probs)
        params = self.optimizer.params
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True, materialize_grads=True)
        if self.mesh.group is not None:
            grads = collectives.all_reduce_mean(grads, self.mesh.group)
        self.optimizer.step(dict(zip(params, grads)))
        with torch.no_grad():
            metrics = all_metrics(y_true, probs, self.mesh.group)
            metrics["loss"] = self._global_loss(loss.detach())
        return metrics

    def _step_on(self, images, labels, fetch_metrics: bool):
        metrics = self._train_step(self._to_device(images), self._to_device(labels), self.step)
        self.step += 1
        if fetch_metrics:
            return {k: float(v) for k, v in metrics.items()}
        return metrics

    def train_on_batch(self, images_u8, labels_u8, fetch_metrics: bool = True):
        """One optimizer step on one ``(B, H, W, 3)``/``(B, H, W)`` uint8
        batch (host arrays or tensors; a staged ``(1, B, ...)`` pair is
        taken too).  Under a mesh every rank passes the global batch and
        trains on its rows, as the JAX ``shard_batch`` places them.
        ``fetch_metrics=False`` returns the metrics as 0-d device tensors
        without waiting for the device."""
        if np.ndim(images_u8) == 5:
            if images_u8.shape[0] != 1:
                raise ValueError(
                    f"train_on_batch takes ONE batch (got a staged array of {images_u8.shape[0]} "
                    "steps — use train_epoch_staged)"
                )
            images_u8, labels_u8 = images_u8[0], labels_u8[0]
        images, labels = pmesh.shard_batch((images_u8, labels_u8), self.mesh)
        return self._step_on(images, labels, fetch_metrics)

    @torch.no_grad()
    def _eval_local(self, images_u8, labels_u8) -> Dict[str, float]:
        x = T.normalize(self._to_device(images_u8), dtype=self.compute_dtype)
        y_true = make_targets(self._to_device(labels_u8), self.cfg, self.cfg.label_smooth)
        self.model.eval()
        probs = self.model(x).float()
        metrics = all_metrics(y_true, probs, self.mesh.group)
        metrics["loss"] = self._global_loss(self.loss_fn(y_true, probs))
        return {k: float(v) for k, v in metrics.items()}

    def eval_on_batch(self, images_u8, labels_u8) -> Dict[str, float]:
        """Metrics and loss of the eval-mode model (moving BN statistics)
        on one global batch (each rank evaluates its rows)."""
        return self._eval_local(*pmesh.shard_batch((images_u8, labels_u8), self.mesh))

    def current_lr(self) -> float:
        return self.schedule(self.step)

    # -- staged (device-resident) epochs --------------------------------------
    def stage_dataset(self, images_u8, labels_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """Upload a dataset once as ``(steps, batch, ...)`` device tensors,
        dropping the tail that does not fill a batch.  Under a mesh the
        arrays are the global dataset and each rank uploads its rows of
        every batch, ``(steps, batch / data, ...)``."""
        b = self.cfg.batch_size
        steps = len(images_u8) // b
        if steps == 0:
            raise ValueError(f"need at least one batch of {b} images")
        n = steps * b
        imgs = np.asarray(images_u8[:n]).reshape((steps, b) + tuple(images_u8.shape[1:]))
        labs = np.asarray(labels_u8[:n]).reshape((steps, b) + tuple(labels_u8.shape[1:]))
        return self._to_device(pmesh.shard_staged(imgs, self.mesh)), self._to_device(pmesh.shard_staged(labs, self.mesh))

    def train_epoch_staged(self, images_dev, labels_dev, fetch_metrics: bool = True, order=None):
        """One epoch over staged batches (this rank's rows of them); ``order``
        (a permutation of ``range(steps)``, the same on every rank) is the
        batch visit order, while the step counter (schedule, augment key)
        advances in sequence.  Returns the per-step metrics stacked, as numpy
        arrays when ``fetch_metrics``."""
        n = int(images_dev.shape[0])
        if order is None:
            order = np.arange(n, dtype=np.int32)
        else:
            order = np.asarray(order, np.int32)
            if order.shape != (n,) or not np.array_equal(np.sort(order), np.arange(n, dtype=np.int32)):
                raise ValueError(f"order must be a permutation of range({n}), got shape {order.shape}")
        steps = [
            self._train_step(images_dev[int(idx)], labels_dev[int(idx)], self.step + i)
            for i, idx in enumerate(order)
        ]
        self.step += n
        metrics = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        if fetch_metrics:
            return {k: v.cpu().numpy() for k, v in metrics.items()}
        return metrics

    # -- fit loops --------------------------------------------------------------
    def _device_bytes_free(self) -> Optional[int]:
        """Free bytes on the card (``torch.cuda.mem_get_info``); ``None`` on
        the CPU, where the dataset is assumed to fit."""
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.mem_get_info(self.device)[0])

    def should_stage(
        self, images_u8, labels_u8, headroom: float = 0.6, extra_arrays=(), from_process_local: bool = False
    ) -> bool:
        """Does the dataset (with ``extra_arrays``, e.g. the validation set)
        fit ``headroom`` of the free device memory, leaving the rest to the
        step?  A rank stages ``1/data`` of a global array (the JAX
        ``total_bytes / data`` per device); ``from_process_local`` arrays
        are that share already."""
        data = self.mesh.data
        need = (np.asarray(images_u8).nbytes + np.asarray(labels_u8).nbytes) / (1 if from_process_local else data)
        need += sum(np.asarray(a).nbytes / data for a in extra_arrays if a is not None)
        free = self._device_bytes_free()
        return True if free is None else need <= headroom * free

    def _end_epoch(self, epoch: int, agg: Dict[str, float], t0: float, checkpoint_dir, log_fn, callbacks) -> bool:
        agg["lr"] = self.current_lr()
        agg["epoch_seconds"] = time.time() - t0
        self.history.append(agg)
        log_fn(f"epoch {epoch + 1}/{self.cfg.epochs} " + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
        if checkpoint_dir and (self.tp or pdist.is_primary()):  # one writer; under TP every rank gathers
            self.save(os.path.join(checkpoint_dir, f"epoch_{epoch + 1}_weights.npz"))
        if checkpoint_dir and pdist.is_primary():
            self._write_history(checkpoint_dir)
        return bool(callbacks) and any(cb(self, epoch, agg) for cb in list(callbacks))

    def fit_arrays(
        self,
        images_u8,
        labels_u8,
        val_images=None,
        val_labels=None,
        checkpoint_dir: Optional[str] = None,
        log_fn: Callable[[str], None] = print,
        callbacks: Optional[list] = None,
        stage: str = "auto",
        shuffle: bool = False,
        shuffle_seed: int = 0,
        from_process_local: bool = False,
    ) -> list:
        """Train on an in-memory uint8 dataset.  ``stage='auto'`` stages it
        on the device when it fits (:meth:`should_stage`) and streams it per
        step otherwise; both give the same numbers.  ``shuffle=True``
        permutes the samples once (seeded), then the batch order every epoch
        (staged) or the samples every pass (streamed), keyed by
        ``(shuffle_seed, epoch index)`` so a resumed run replays the orders;
        validation stays in order.

        ``from_process_local=True`` (multi-process feeding): the arrays hold
        only this rank's samples, those of
        :func:`parallel.distributed.local_sample_indices` in its order, and
        are staged by :func:`parallel.distributed.stage_local_dataset` or
        streamed in this rank's rows of each batch.  The one-time sample
        shuffle is skipped (no rank holds the global order), as for the JAX
        package's pre-staged arrays; the per-epoch orders stay, the same on
        every rank.  Validation arrays are always global."""
        cfg = self.cfg
        b_feed = len(pdist._owned_rows(self.mesh, cfg.batch_size)) if from_process_local else cfg.batch_size
        if shuffle and not from_process_local:
            perm = np.random.RandomState(shuffle_seed).permutation(len(images_u8))
            images_u8, labels_u8 = np.asarray(images_u8)[perm], np.asarray(labels_u8)[perm]
        self.steps_per_epoch = max(len(images_u8) // b_feed, 1)
        if stage == "auto":
            use_staged = self.should_stage(
                images_u8, labels_u8, extra_arrays=(val_images, val_labels), from_process_local=from_process_local
            )
            if self.mesh.world_size > 1:  # one path for all ranks: staged only where every rank fits it
                vote = torch.tensor([float(use_staged)], device=self.device)
                use_staged = float(collectives.all_reduce_mean([vote], dist.group.WORLD)[0]) == 1.0
        else:
            use_staged = {"staged": True, "stream": False}[stage]

        if not use_staged:
            def cycle(images, labels, b, do_shuffle=False):
                steps = max(len(images) // b, 1)
                n_pass = self.step // steps  # resume continues the sequence
                while True:
                    if do_shuffle:
                        p = np.random.RandomState(shuffle_seed + 1 + n_pass).permutation(len(images))
                        images_p, labels_p = np.asarray(images)[p], np.asarray(labels)[p]
                    else:
                        images_p, labels_p = images, labels
                    n_pass += 1
                    for i in range(steps):
                        yield images_p[i * b : (i + 1) * b], labels_p[i * b : (i + 1) * b]

            val_iter, val_steps = None, 0
            if val_images is not None:
                val_iter = cycle(val_images, val_labels, cfg.batch_size)
                val_steps = max(len(val_images) // cfg.batch_size, 1)
            log_fn("fit_arrays: dataset exceeds the device memory budget, streaming per step")
            return self.fit(
                cycle(images_u8, labels_u8, b_feed, do_shuffle=shuffle), val_iter, val_steps,
                checkpoint_dir=checkpoint_dir, log_fn=log_fn, callbacks=callbacks,
                from_process_local=from_process_local,
            )

        if from_process_local:
            imgs_dev, labs_dev = pdist.stage_local_dataset(self, images_u8, labels_u8)
        else:
            imgs_dev, labs_dev = self.stage_dataset(images_u8, labels_u8)
        steps = int(imgs_dev.shape[0])
        log_fn(f"fit_arrays: staged {steps} steps x batch {cfg.batch_size} on {self.device}")
        val_dev = []
        if val_images is not None:
            b = cfg.batch_size
            val_dev = [
                tuple(self._to_device(a) for a in pmesh.shard_batch(
                    (val_images[i * b : (i + 1) * b], val_labels[i * b : (i + 1) * b]), self.mesh))
                for i in range(max(len(val_images) // b, 1))
            ]
        for epoch in range(cfg.epochs):
            t0 = time.time()
            order = None
            if shuffle:
                epoch_idx = self.step // steps
                order = np.random.RandomState(shuffle_seed + 1 + epoch_idx).permutation(steps).astype(np.int32)
            metrics = self.train_epoch_staged(imgs_dev, labs_dev, order=order)
            # a sequential f64 sum, the streamed loop's arithmetic
            agg = {k: sum(float(x) for x in np.asarray(v).ravel()) / len(v) for k, v in metrics.items()}
            if val_dev:
                vagg: Dict[str, float] = {}
                for vb in val_dev:
                    for k, v in self._eval_local(*vb).items():
                        vagg[k] = vagg.get(k, 0.0) + v
                agg.update({f"val_{k}": v / len(val_dev) for k, v in vagg.items()})
            if self._end_epoch(epoch, agg, t0, checkpoint_dir, log_fn, callbacks):
                break
        return self.history

    def fit(
        self,
        train_iter: Iterator[Tuple[np.ndarray, np.ndarray]],
        val_iter: Optional[Iterator[Tuple[np.ndarray, np.ndarray]]] = None,
        val_steps: int = 0,
        checkpoint_dir: Optional[str] = None,
        log_fn: Callable[[str], None] = print,
        callbacks: Optional[list] = None,
        from_process_local: bool = False,
    ) -> list:
        """Epoch loop over a host batch iterator, ``steps_per_epoch`` steps
        an epoch, a checkpoint per epoch.  Uploads run ahead on a side
        stream (:func:`data.prefetch.device_prefetch`) and the step metrics
        stay on the device until the epoch ends.  ``callbacks`` are
        ``cb(trainer, epoch, metrics) -> stop``.

        Under a mesh ``train_iter`` yields the global batches and each rank
        uploads its rows; ``from_process_local=True`` (multi-process
        streaming): it yields only this rank's rows of each global batch.
        ``val_iter`` always yields global batches."""
        train_iter = device_prefetch(train_iter, self.device, mesh=self.mesh, from_process_local=from_process_local)
        for epoch in range(self.cfg.epochs):
            t0 = time.time()
            steps = [self._step_on(*next(train_iter), fetch_metrics=False) for _ in range(self.steps_per_epoch)]
            agg: Dict[str, float] = {}
            for k in steps[0]:
                for v in torch.stack([m[k] for m in steps]).tolist():  # one wait per epoch
                    agg[k] = agg.get(k, 0.0) + v
            agg = {k: v / self.steps_per_epoch for k, v in agg.items()}
            if val_iter is not None and val_steps:
                vagg: Dict[str, float] = {}
                for _ in range(val_steps):
                    for k, v in self.eval_on_batch(*next(val_iter)).items():
                        vagg[k] = vagg.get(k, 0.0) + v
                agg.update({f"val_{k}": v / val_steps for k, v in vagg.items()})
            if self._end_epoch(epoch, agg, t0, checkpoint_dir, log_fn, callbacks):
                break
        return self.history

    def _write_history(self, checkpoint_dir: str) -> None:
        """The fit history as ``history.json`` beside the checkpoints,
        written atomically."""
        tmp = os.path.join(checkpoint_dir, ".history.json.tmp")
        with open(tmp, "w") as f:
            json.dump(self.history, f, indent=1)
        os.replace(tmp, os.path.join(checkpoint_dir, "history.json"))

    # -- checkpoints -------------------------------------------------------------
    def save(self, path: str) -> None:
        """Write params, BN state, optimizer state and step as the JAX
        package's ``.npz``.  Under TP the slices are gathered over the model
        group first, so every rank must call it; only the primary writes,
        and every rank returns once the file is there."""
        if not self.tp:
            params, state = jax_variables(self.model)
            ckpt.save_variables(path, params, state, self.optimizer.jax_state(), self.step,
                                metadata={"model": self.model_name})
            return
        params, state, opt = ptp.gather_checkpoint(self.model, self.optimizer, self.mesh)
        if pdist.is_primary():
            ckpt.save_variables(path, params, state, opt, self.step, metadata={"model": self.model_name})
        dist.barrier()

    def _place_weights(self, path: str, params, state) -> None:
        """Load the weights (under TP, this rank's slices of them); under a
        mesh every rank loads them and they are checked against the mesh's
        layout."""
        ckpt.check_matches_model(path, params, state, *jax_templates(self.model), self.model_name)
        if self.tp:
            params, state = ptp.local_variables(self.model, self.mesh, params, state)
        load_jax_variables(self.model, params, state)
        self._check_replicas()

    def load_weights(self, path: str) -> None:
        """Weights-only initialisation (transfer learning): params and BN
        state from an ``.npz`` checkpoint or a reference Keras ``.h5``
        (imported strictly, :func:`train.checkpoint.import_h5_weights`);
        optimizer, schedule and step stay fresh.  Use :meth:`restore` for an
        exact resume."""
        if path.endswith((".h5", ".hdf5")):
            params, state, _ = ckpt.import_h5_weights(path, *jax_templates(self.model), strict=True)
        else:
            params, state, *_ = ckpt.load_variables(path)
        self._place_weights(path, params, state)

    def restore(self, path: str) -> None:
        """Exact resume: params, BN state, optimizer state and step, and the
        fit history of ``history.json`` beside the checkpoint, cut to the
        epochs the checkpoint had completed (its ``epoch_N`` file name, or
        ``step // steps_per_epoch``)."""
        params, state, opt, step, _ = ckpt.load_variables(path)
        self._place_weights(path, params, state)
        if opt:
            self.optimizer.load_jax_state(ptp.local_opt_state(self.model, self.mesh, opt) if self.tp else opt)
        self.step = step
        hist_path = os.path.join(os.path.dirname(path) or ".", "history.json")
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                hist = json.load(f)
            m = re.search(r"epoch_(\d+)_weights", os.path.basename(path))
            if m:
                done = int(m.group(1))
            elif self.steps_per_epoch:
                done = step // self.steps_per_epoch
            else:
                done = len(hist)
            self.history = hist[:done]
