"""Tiled scene inference, one model at a time.

The counterpart of ``building_detection_tpu/infer/engine.py``.  Per scene
and model: normalize, pad the canvas with 0.0 in normalized space, gather
tiles, forward them in chunks of ``min(batch_tiles, num_tiles)`` (the last
chunk padded by repeating the last origin, which the OR makes harmless),
set a bit where the argmax of the softmax is class 1, OR the bits into a
uint8 canvas, crop it on the device and scale it to {0, 255}.

The host sees two transfers per scene: the uint8 image up (once per scene
for the whole :class:`EnsemblePredictor`) and each mask down.  On a CUDA
device the image goes up from pinned memory on a side stream and the mask
comes back into pinned memory behind an event, so a caller that dispatches
several scenes or blocks before fetching the first (``infer/large_scene.py``)
overlaps uploads, compute and downloads.  Every host buffer a copy reads
or writes stays referenced by the handle until :meth:`TiledPredictor.fetch`
has waited for it.

``TiledPredictor(mesh=)`` shards each chunk of tiles over the data rows of a
mesh of local devices as the fused predictor does
(``fused_ensemble.shard_forward``), and with ``tp=True`` also shards the
model's channels over each row's model devices (``parallel/tp.py``).  Over
a mesh that spans processes (``make_mesh()`` on every rank of a
``torch.distributed`` group, as the JAX package's predictor runs over a
global mesh in every process) each rank forwards its data index's part of
each chunk and the bits are all-gathered over the data group
(``fused_ensemble.process_shard_forward``); with ``tp=True`` the rank keeps
its model index's channel slices and its sharded layers gather their
channels over the model group (``parallel/tp.py::tp_shard``).
``EnsemblePredictor(devices=)`` places the members round-robin on several
devices, uploads each scene once per distinct device and dispatches every
member before it fetches any.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from building_detection_tpu_torch.core.config import TilerConfig
from building_detection_tpu_torch.core.device import check_device
from building_detection_tpu_torch.core.module import cast_params, set_int8
from building_detection_tpu_torch.infer.fused_ensemble import (
    DEFAULT_BATCH_TILES,
    fetch_pinned,
    process_shard_forward,
    replicate_model,
    shard_forward,
    upload_pinned,
)
from building_detection_tpu_torch.ops import tiling as T
from building_detection_tpu_torch.parallel.mesh import check_tp_replicas, predictor_devices
from building_detection_tpu_torch.parallel.tp import tp_device_replicas, tp_shard, tp_tensors


class TiledPredictor:
    """Runs one model over scenes of any size through sliding-window tiles.

    ``model`` maps ``(B, tile, tile, 3)`` normalized tiles to ``(B, tile,
    tile, 2)`` softmax.  The predictor takes ownership: it moves the model
    to ``device`` (the card by default; a card that is not there raises,
    nothing falls back) and casts its parameters to ``compute_dtype``.
    ``int8_pointwise`` and ``int8_scales`` (``{site: amax}``) opt it into
    int8 pointwise convs (:func:`core.module.set_int8`): NOT mask-parity.
    ``mesh`` (a mesh of local devices) shards each chunk of tiles over its
    data axis, ``batch_tiles`` per data row, with a replica of the model on
    the first device of each row (see :class:`~building_detection_tpu_torch.
    infer.fused_ensemble.FusedEnsemblePredictor`).  ``tp=True`` on a mesh
    with ``model > 1`` is channel tensor parallelism, as in the JAX package:
    each row's replica keeps the out-channel slices of its sharded layers on
    the row's model devices and runs each slice there
    (:func:`parallel.tp.tp_device_replicas`).  Without a mesh, or at
    ``model == 1``, ``tp`` changes nothing; without ``tp`` a model axis only
    repeats each row's work, so it runs once.

    Over a mesh that spans processes (``make_mesh()`` on every rank) the
    model runs on this rank's device (the mesh's, else ``device``), a chunk
    is ``batch_tiles * mesh.data`` tiles, and each rank forwards its data
    index's part of it (:func:`~building_detection_tpu_torch.infer.
    fused_ensemble.process_shard_forward`).  With ``tp=True`` and ``model >
    1`` the rank keeps its model index's slices (:func:`parallel.tp.
    tp_shard`, after the cast, so they carry ``compute_dtype``), checks at
    construction that the ranks hold the slices and weights one model would
    give them (a rank built from other weights makes every rank raise), and
    its sharded layers gather their channels over the model group; a mesh
    with no model group raises.  Without ``tp`` a model axis repeats each
    row's work, as in the JAX package.  The ranks of a model group compute
    the layers they do not shard each on its own device, so each chunk's
    bits are model index 0's, broadcast over the model group: every rank
    returns the same mask, bit for bit.  Every rank runs every call with the
    same scenes, as each JAX process does: the ranks meet in each chunk's
    collectives, and a degenerate scene (a side not above the overlap)
    returns its blank mask on every rank without entering one.
    """

    def __init__(
        self,
        model: nn.Module,
        cfg: TilerConfig = TilerConfig(),
        batch_tiles: int = DEFAULT_BATCH_TILES,
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
        mesh=None,
        tp: bool = False,
        int8_pointwise: bool = False,
        int8_scales: Optional[dict] = None,
    ):
        self.devices = predictor_devices(mesh, device)
        self.device = self.devices[0]
        self.tp = bool(tp) and mesh is not None and mesh.model > 1
        self.model = set_int8(cast_params(model.to(self.device).eval(), compute_dtype), int8_pointwise, int8_scales)
        self._over_processes = mesh if mesh is not None and mesh.world_size > 1 else None
        self._stages = [self._bits]
        if self._over_processes is not None:
            if self.tp:
                tp_shard(self.model, mesh)
                check_tp_replicas(*tp_tensors(self.model), mesh)
            self.replicas = {self.device: self.model}
            if mesh.model_group is not None:
                self._model_root = dist.get_global_rank(mesh.model_group, 0)
                self._stages.append(self._model_root_bits)
        elif self.tp:
            self.replicas = tp_device_replicas(self.model, mesh)
        else:
            self.replicas = replicate_model(self.model, self.devices)
        self.cfg = cfg
        self.batch_tiles = batch_tiles * (mesh.data if self._over_processes is not None else len(self.devices))
        self.compute_dtype = compute_dtype
        self._cuda = self.device.type == "cuda"
        self._upload = torch.cuda.Stream(self.device) if self._cuda else None

    def _bits(self, tiles: torch.Tensor, _=None) -> torch.Tensor:
        """(B, tile, tile) uint8 class-1 argmax bits of the replica on the
        tiles' device: the first stage of :func:`shard_forward`."""
        return (torch.argmax(self.replicas[tiles.device](tiles), dim=-1) == 1).to(torch.uint8)

    def _model_root_bits(self, _, bits: torch.Tensor) -> torch.Tensor:
        """Model index 0's ``bits`` on every rank of this rank's model group."""
        dist.broadcast(bits, src=self._model_root, group=self._over_processes.model_group)
        return bits

    def _forward(self, tiles: torch.Tensor) -> torch.Tensor:
        """The chunk's bits on the home device: over the local shards, or
        over the ranks of a mesh that spans processes (every rank gets the
        whole chunk's)."""
        if self._over_processes is not None:
            return process_shard_forward(self._stages, tiles, self._over_processes)
        return shard_forward(self._stages, tiles, self.devices)

    # -- device work -------------------------------------------------------
    def _run(self, image: torch.Tensor, plan: T.TilePlan, h: int, w: int) -> torch.Tensor:
        """uint8 scene (``(h, w, 3)``, or the bucket canvas) -> ``(h, w)``
        uint8 {0, 255} mask on the device."""
        tile = self.cfg.tile
        norm = T.normalize(image, self.cfg, dtype=self.compute_dtype)
        # the pad region is 0.0 in normalized space (predict.py:102-104);
        # a bucketed scene arrives host-padded, so only its real extent is kept
        canvas = norm.new_zeros((plan.canvas_h, plan.canvas_w, 3))
        canvas[:h, :w] = norm[:h, :w]
        batch = min(self.batch_tiles, max(plan.num_tiles, 1))
        origins = list(plan.origins)
        origins += [origins[-1]] * (-len(origins) % batch)  # OR is idempotent
        mask = torch.zeros((plan.canvas_h, plan.canvas_w), dtype=torch.uint8, device=self.device)
        for start in range(0, len(origins), batch):
            chunk = origins[start : start + batch]
            tiles = torch.stack([canvas[r : r + tile, c : c + tile] for r, c in chunk])
            bits = self._forward(tiles)
            # per-tile OR == the reference's accumulate-then->=1 (predict.py:113-114)
            for bit, (r, c) in zip(bits, chunk):
                mask[r : r + tile, c : c + tile] |= bit
        return mask[:h, :w] * 255

    # -- staging, dispatch, fetch --------------------------------------------
    def plan_and_stage(self, image_rgb: np.ndarray):
        """Host-side prep: ``(plan | None, staged uint8 array, h, w)``.

        Apart from :meth:`dispatch_staged` so that :class:`EnsemblePredictor`
        uploads one staged scene and shares it across members."""
        h, w = image_rgb.shape[:2]
        plan = T.plan_tiles(h, w, self.cfg)
        if plan.num_tiles == 0:
            # dims <= overlap: the reference's loops never run, the mask is blank
            return None, None, h, w
        if self.cfg.bucket_sizes:
            plan = T.bucket_plan(plan, self.cfg)
            staged = np.zeros((plan.canvas_h, plan.canvas_w, 3), np.uint8)
            staged[:h, :w] = image_rgb
        else:
            staged = image_rgb
        return plan, staged, h, w

    def upload(self, staged: np.ndarray):
        """(scene on the device, its pinned host copy or None)."""
        host = torch.from_numpy(np.ascontiguousarray(staged))
        if not self._cuda:
            return host.to(self.device), None
        return upload_pinned(host, self.device, self._upload)

    @torch.inference_mode()
    def dispatch_staged(self, uploaded, plan: T.TilePlan, h: int, w: int):
        """Enqueue the scene's work on an :meth:`upload`-ed scene; returns
        the handle :meth:`fetch` takes."""
        mask = self._run(uploaded[0], plan, h, w)
        if not self._cuda:
            return mask, None, uploaded, h, w
        out, done = fetch_pinned(mask, self.device)
        return out, done, uploaded, h, w  # `uploaded` keeps the pinned upload alive

    def dispatch(self, image_rgb: np.ndarray):
        """Enqueue one scene: upload, then :meth:`dispatch_staged`.  Nothing
        waits for the device until :meth:`fetch`."""
        plan, staged, h, w = self.plan_and_stage(image_rgb)
        if plan is None:
            return None, None, None, h, w
        return self.dispatch_staged(self.upload(staged), plan, h, w)

    @staticmethod
    def fetch(dispatched) -> np.ndarray:
        out, done, _, h, w = dispatched
        if out is None:
            return np.zeros((h, w), np.uint8)
        if done is not None:
            done.synchronize()
        return out.numpy()

    def predict_mask(self, image_rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB -> (H, W) uint8 {0, 255} building mask."""
        return self.fetch(self.dispatch(image_rgb))


class EnsemblePredictor:
    """The five members of the reference (`predict.py:75-87`), each a
    :class:`TiledPredictor`; per-model masks in the members' order.  Each
    member module is owned (moved and cast) by its predictor;
    ``int8_scales`` is ``{member: {site: amax}}``.

    The members run on ``device``, or with ``devices`` round-robin on those
    devices (ensemble model parallelism: member ``i`` on ``devices[i %
    len(devices)]``), as in the JAX package.
    """

    def __init__(
        self,
        members: Dict[str, nn.Module],
        cfg: TilerConfig = TilerConfig(),
        batch_tiles: int = DEFAULT_BATCH_TILES,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        devices: Optional[list] = None,
        int8_pointwise: bool = False,
        int8_scales: Optional[Dict[str, dict]] = None,
    ):
        if devices is not None and not devices:
            raise ValueError("EnsemblePredictor(devices=[]) names no device")
        placed = [torch.device(d) for d in devices] if devices is not None else [torch.device(device)]
        for d in dict.fromkeys(placed):
            check_device(d)
        self.predictors = {
            name: TiledPredictor(model, cfg, batch_tiles, compute_dtype, placed[i % len(placed)])
            for i, (name, model) in enumerate(members.items())
        }
        self.set_int8(int8_pointwise, int8_scales)
        self.names = list(self.predictors)
        self.cfg = cfg

    def set_int8(self, int8_pointwise, int8_scales: Optional[Dict[str, dict]]) -> None:
        """The int8 options (:func:`core.module.set_int8`) on every member."""
        for name, p in self.predictors.items():
            set_int8(p.model, int8_pointwise, (int8_scales or {}).get(name))

    def predict_masks(self, image_rgb: np.ndarray) -> Dict[str, np.ndarray]:
        """Stage the scene once and upload it once per distinct device,
        dispatch every member, then fetch."""
        preds = list(self.predictors.values())
        plan, staged, h, w = preds[0].plan_and_stage(image_rgb)
        if plan is None:
            return {name: np.zeros((h, w), np.uint8) for name in self.names}
        uploads = {}
        for p in preds:
            if p.device not in uploads:
                uploads[p.device] = p.upload(staged)
        dispatched = {name: p.dispatch_staged(uploads[p.device], plan, h, w) for name, p in self.predictors.items()}
        return {name: TiledPredictor.fetch(d) for name, d in dispatched.items()}
