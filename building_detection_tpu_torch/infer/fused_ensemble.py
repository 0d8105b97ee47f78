"""Fused ensemble: the tiles of a scene group are gathered and normalized
once and run through all five members; each member's argmax bit is ORed
into one uint8 canvas and the canvas leaves the device as bitplanes.

The counterpart of ``building_detection_tpu/infer/fused_ensemble.py``.
Same-shape scenes are grouped so that a group's tiles fill ``batch_tiles``;
the groups are dispatched ahead of the fetch point within a bounded window.
On a CUDA device each group's scenes go up from pinned host memory on a
separate upload stream, the compute waits for them on the current stream,
and the bitplanes come back into pinned memory behind an event, so later
groups' uploads and launches overlap earlier groups' compute and the host's
post-processing.  :meth:`FusedEnsemblePredictor.predict_vote` is the plain
vote of ``bdt-predict --fast-vote``.

Below f32 (the bf16 serving default) each member's BatchNorms that take a
convolution's output are folded into that convolution when the predictor
takes the member (:func:`nn.fold.fold_batchnorm`): computed in f32 from the
f32 weights, then rounded to the compute dtype once, which removes three
elementwise passes a BN site from every forward.  The fold reorders the
roundings, not the mathematics, so an f32 predictor stays unfolded: the
parity tests hold it to the JAX package bit for bit.

Tile data parallelism (``mesh=``, a mesh of local devices from
:func:`parallel.mesh.make_mesh`) is :func:`shard_forward`: each chunk of
tiles is cut into one contiguous part per shard, in the row order JAX's
sharding over the data axis gives its devices, every part is sent to its
device and run there on that device's replicas, member by member across
the shards, and the results come back to the home device (the mesh's
first), which keeps the upload, the canvas, the OR, the packing and the
fetch.  PyTorch copies between two cards on the source card's current
stream behind a two-way barrier with the destination's current stream,
so neither buffer is reused before its copy is done and no
``record_stream`` is needed.

Over a mesh that spans processes (``make_mesh()`` in every rank of a
``torch.distributed`` group, as the JAX package's predictor runs over a
global mesh in every process) each rank plans, uploads and tiles every
scene itself, forwards only its data index's part of each chunk
(:func:`process_shard_forward`), and all-gathers the parts' uint8 member
bits over the data group, so every rank ORs the whole chunk into its canvas
and returns every mask, as each JAX process does.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from building_detection_tpu_torch.core.config import TilerConfig
from building_detection_tpu_torch.core.module import cast_params, set_int8
from building_detection_tpu_torch.nn.fold import bn_sites, fold_batchnorm
from building_detection_tpu_torch.parallel.mesh import predictor_devices
from building_detection_tpu_torch.ops import tiling as T
from building_detection_tpu_torch.utils import profiling

# Tiles per dispatch.  Chosen from the batch sweep of ``chip_smoke.py`` on
# an H100 (PERF.md); the TPU's 128 does not carry over.
DEFAULT_BATCH_TILES = 32


def _pack_bitplanes(canvas: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(S, H, W) uint8 with one mask bit per member -> (n_bits, S, H,
    ceil(W/8)) uint8 bitplanes, MSB-first within each byte (``np.unpackbits``
    order)."""
    s, h, w = canvas.shape
    w8 = -(-w // 8) * 8
    if w8 != w:
        canvas = torch.nn.functional.pad(canvas, (0, w8 - w))
    grouped = canvas.reshape(s, h, w8 // 8, 8)
    planes = []
    for bit in range(n_bits):
        plane = (grouped >> bit) & 1
        packed = torch.zeros(grouped.shape[:-1], dtype=torch.uint8, device=canvas.device)
        for k in range(8):
            packed |= plane[..., k] << (7 - k)
        planes.append(packed)
    return torch.stack(planes)


def _unpack_bitplanes(planes: np.ndarray, width: int) -> np.ndarray:
    """(n_bits, S, H, W8/8) uint8 -> (n_bits, S, H, width) {0,1} uint8."""
    return np.unpackbits(planes, axis=-1)[..., :width]


def upload_pinned(host: torch.Tensor, device: torch.device, stream,
                  span: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``host`` on the CUDA ``device``, copied from pinned memory on the side
    ``stream``; the current stream waits for the copy, and ``record_stream``
    keeps the allocator from reusing the device buffer before the current
    stream's work on it is done.  Returns (device tensor, pinned host
    tensor): the caller keeps the latter alive until its copy has run.
    ``span`` names the copy's device span (:func:`utils.profiling.device_span`)."""
    host = host.pin_memory()
    with torch.cuda.stream(stream), profiling.device_span(span, stream=stream):
        on_device = host.to(device, non_blocking=True)
    compute = torch.cuda.current_stream(device)
    compute.wait_stream(stream)
    on_device.record_stream(compute)
    return on_device, host


def fetch_pinned(t: torch.Tensor, device: torch.device) -> Tuple[torch.Tensor, "torch.cuda.Event"]:
    """Start copying ``t`` into pinned host memory on the current stream;
    returns (host tensor, event): read the host tensor after
    ``event.synchronize()``."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return out, done


Stage = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def shard_forward(stages: Sequence[Stage], tiles: torch.Tensor, devices: Sequence[torch.device]) -> torch.Tensor:
    """``stages`` over ``tiles`` split across ``devices``.  Part ``i`` of
    ``len(devices)`` equal contiguous parts goes to ``devices[i]``; each
    stage maps ``(part, result so far)`` to the new result (``None`` before
    the first stage), and the results, in order, come back to ``tiles``'
    device.  A batch that the shards do not divide is padded by repeating
    its last tile and the pad's results are dropped, so every shard runs
    the same batch shape.  Nothing waits for a device.

    One thread launches a stage on every shard before the next stage.  A
    card's launch queue holds about a thousand kernels and a member's
    forward launches more, so launching one shard's whole work before the
    next shard's makes the host wait on each card in turn, and the cards
    run one after another; stage by stage, every card's queue is filled
    before the host waits on any.  (A launch thread per card measured
    slower: the interpreter lock passes between the threads at every op.)"""
    n, home = tiles.shape[0], tiles.device
    if len(devices) == 1:
        parts = [tiles]
    else:
        pad = -n % len(devices)
        if pad:
            tiles = torch.cat([tiles, tiles[-1:].expand(pad, *tiles.shape[1:])])
        parts = [part.to(d, non_blocking=True) for part, d in zip(tiles.chunk(len(devices)), devices)]
    results: List[Optional[torch.Tensor]] = [None] * len(parts)
    for stage in stages:
        for i, part in enumerate(parts):
            results[i] = stage(part, results[i])
    if len(parts) == 1:
        return results[0]
    return torch.cat([r.to(home, non_blocking=True) for r in results])[:n]


def process_shard_forward(stages: Sequence[Stage], tiles: torch.Tensor, mesh) -> torch.Tensor:
    """``stages`` over ``tiles`` split across the data axis of a mesh that
    spans processes: this rank forwards its data index's part (of
    ``mesh.data`` equal contiguous parts, the batch padded by repeating its
    last tile, as in :func:`shard_forward`) on the tiles' device, and the
    parts' results are all-gathered over the data group, so every rank
    holds the whole chunk's results, in order.  At ``data == 1`` there is
    nothing to gather."""
    if mesh.data == 1:
        return shard_forward(stages, tiles, [tiles.device])
    n = tiles.shape[0]
    pad = -n % mesh.data
    if pad:
        tiles = torch.cat([tiles, tiles[-1:].expand(pad, *tiles.shape[1:])])
    mine = shard_forward(stages, tiles.chunk(mesh.data)[mesh.data_index], [tiles.device]).contiguous()
    parts = [torch.empty_like(mine) for _ in range(mesh.data)]
    dist.all_gather(parts, mine, group=mesh.group)
    return torch.cat(parts)[:n]


def check_data_only(mesh) -> None:
    """The JAX package's refusal of a mesh with a model axis on the fused
    path: tiles shard over the data axis only.  The members' channel
    structures differ (728-channel Xception, 1024-channel U-Net, 32-256
    channel HRNet branches), so one model axis cannot partition them
    evenly; channel TP runs one member at a time
    (``TiledPredictor(tp=True)``)."""
    if mesh is not None and getattr(mesh, "model", 1) > 1:
        raise ValueError(
            "FusedEnsemblePredictor supports data-axis sharding only; got a mesh with model axis > 1. Use a "
            "data-only mesh, or per-member TiledPredictor(tp=True) for channel TP."
        )


def replicate_model(model: nn.Module, devices: Sequence[torch.device]) -> Dict[torch.device, nn.Module]:
    """``{device: replica}`` over the distinct ``devices``: ``model`` itself
    (already on ``devices[0]``) and a deep copy on each other device."""
    return {d: model if d == devices[0] else copy.deepcopy(model).to(d) for d in dict.fromkeys(devices)}


class FusedEnsemblePredictor:
    """All members over shared tiles, one dispatch per scene group.

    ``members`` maps name -> model (``(B, H, W, 3)`` -> ``(B, H, W, 2)``
    softmax).  The predictor takes ownership: it moves each model to
    ``device`` (the card by default; a card that is not there raises) and
    casts its parameters to ``compute_dtype``; below f32 it first folds the
    BatchNorms fed by a convolution into it, in place (:mod:`nn.fold`).
    ``int8_pointwise`` and ``int8_scales`` (``{member: {site: amax}}``) opt
    the members into int8 pointwise convs (:func:`core.module.set_int8`):
    NOT mask-parity.

    ``mesh`` (a mesh of local devices, :func:`parallel.mesh.make_mesh`)
    shards every chunk of tiles over its data axis (:func:`shard_forward`):
    ``batch_tiles`` counts tiles per shard, as in the JAX package, so a
    chunk holds ``batch_tiles * len(mesh.devices)`` tiles and every shard
    forwards ``batch_tiles`` of them, the last chunk's shards the same
    smaller count.  Each member has one replica per distinct device, with
    the same int8 options; the mesh names the devices, so ``device`` stays
    ``None``.  A mesh with a ``model`` axis raises ``ValueError``, as in the
    JAX package (:func:`check_data_only`).  A mesh that spans processes
    (``make_mesh()`` on every rank) runs each chunk over the ranks of its
    data axis (:func:`process_shard_forward`), ``batch_tiles`` a rank, on
    this rank's device (the mesh's, else ``device``); every rank runs every
    call with the same scenes and returns every mask.

    While recording is on (:mod:`utils.profiling`) a call records host spans
    ``fused.call`` (the whole call, one id), ``fused.plan`` (planning and
    grouping), ``fused.stage``, ``fused.upload`` (pin and enqueue of the
    upload), ``fused.launch`` (the device half's enqueue),
    ``fused.fetch_wait`` and ``fused.unpack``; on a card, device spans
    ``fused.dispatch`` (a group, from the wait for its upload to its fetch
    copy), ``fused.forward`` (a chunk's member stages), ``fused.member.<name>``
    and ``fused.h2d`` (the upload stream's copy), resolved when the group is
    fetched; and counters ``fused.dispatches``, ``fused.chunks``,
    ``fused.tiles`` (tiles forwarded), ``fused.tile_slots`` (``batch_tiles``
    a chunk), ``fused.bn_folded`` and ``fused.bn_eager`` (the BN sites a
    chunk's member forwards run folded and as BatchNorm) and
    ``fused.scenes``.  Over a mesh the device spans time the home device
    only.
    """

    # Scene-group sizes: quantizing bounds the shapes a serving batcher
    # produces (the JAX package compiles one program per size).
    _GROUP_SIZES = (32, 24, 16, 12, 8, 6, 4, 3, 2, 1)

    def __init__(
        self,
        members: Dict[str, nn.Module],
        cfg: TilerConfig = TilerConfig(),
        batch_tiles: int = DEFAULT_BATCH_TILES,
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
        int8_pointwise=False,
        int8_scales: Optional[Dict[str, Dict[str, float]]] = None,
        mesh=None,
    ):
        check_data_only(mesh)
        self.devices = predictor_devices(mesh, device)
        self.device = self.devices[0]
        self._over_processes = mesh if mesh is not None and mesh.world_size > 1 else None
        self.names = list(members)
        fold = torch.finfo(compute_dtype).bits < 32
        self.models = {}
        for n, m in members.items():
            m = m.to(self.device).eval()
            self.models[n] = cast_params(fold_batchnorm(m) if fold else m, compute_dtype)
        sites = [bn_sites(m) for m in self.models.values()]  # a chunk's BN sites, summed over the members
        self._bn_folded, self._bn_eager = sum(f for f, _ in sites), sum(e for _, e in sites)
        self.replicas = {d: {} for d in dict.fromkeys(self.devices)}
        for n, m in self.models.items():
            for d, replica in replicate_model(m, self.devices).items():
                self.replicas[d][n] = replica
        self.set_int8(int8_pointwise, int8_scales)
        self._stages = [self._member_stage(bit, name) for bit, name in enumerate(self.names)]
        self.cfg = cfg
        shards = len(self.devices) if self._over_processes is None else self._over_processes.data
        self.batch_tiles = batch_tiles * shards
        self.compute_dtype = compute_dtype
        self._cuda = self.device.type == "cuda"
        self._upload = torch.cuda.Stream(self.device) if self._cuda else None

    def set_int8(self, int8_pointwise, int8_scales: Optional[Dict[str, Dict[str, float]]]) -> None:
        """The int8 options (:func:`core.module.set_int8`) on every replica
        of every member."""
        for models in self.replicas.values():
            for n, m in models.items():
                set_int8(m, int8_pointwise, (int8_scales or {}).get(n))

    # -- device work -------------------------------------------------------
    def _member_stage(self, bit: int, name: str) -> Stage:
        """The :func:`shard_forward` stage of member ``name``: its class-1
        argmax bit (taken after the softmax: ties resolve to class 0), from
        the replica on the tiles' device, ORed in at ``bit``; on the home
        device, in the device span ``fused.member.<name>``."""
        label = f"fused.member.{name}"

        def stage(tiles: torch.Tensor, packed: Optional[torch.Tensor]) -> torch.Tensor:
            with profiling.device_span(label, tiles.device if tiles.device == self.device else None):
                probs = self.replicas[tiles.device][name](tiles)
                bits = (torch.argmax(probs, dim=-1) == 1).to(torch.uint8) << bit
                return bits if packed is None else packed.bitwise_or_(bits)
        return stage

    def member_bits(self, tiles: torch.Tensor) -> torch.Tensor:
        """(B, tile, tile, 3) normalized tiles -> (B, tile, tile) uint8 with
        bit ``i`` set where member ``i``'s argmax is class 1, on the tiles'
        device."""
        return shard_forward(self._stages, tiles, [tiles.device])

    def sharded_bits(self, tiles: torch.Tensor) -> torch.Tensor:
        """:meth:`member_bits` of tiles on the home device, run over the
        mesh's shards; the bits come back to the home device (over
        processes: every rank gets every tile's bits)."""
        if self._over_processes is not None:
            return process_shard_forward(self._stages, tiles, self._over_processes)
        return shard_forward(self._stages, tiles, self.devices)

    def _run_group(self, imgs: torch.Tensor, hw: np.ndarray, plan: T.TilePlan) -> torch.Tensor:
        """Device half of one dispatch: uint8 scenes -> packed bitplanes."""
        cfg, tile = self.cfg, self.cfg.tile
        n = imgs.shape[0]
        norm = T.normalize(imgs, cfg, dtype=self.compute_dtype)
        # the pad region is 0.0 in normalized space (predict.py:102-104)
        canvas = norm.new_zeros((n, plan.canvas_h, plan.canvas_w, 3))
        if cfg.bucket_sizes:  # scenes arrive host-padded: zero past each extent
            rows = torch.arange(plan.canvas_h, device=self.device)
            cols = torch.arange(plan.canvas_w, device=self.device)
            hw_t = self._upload_array(hw)
            keep = (rows[None, :, None] < hw_t[:, 0, None, None]) & (cols[None, None, :] < hw_t[:, 1, None, None])
            canvas = torch.where(keep[..., None], norm, canvas)
        else:
            canvas[:, : norm.shape[1], : norm.shape[2]] = norm
        # (scene, row, col) of every tile, scene-major
        origins = [(s, r, c) for s in range(n) for r, c in plan.origins]
        idx = self._upload_array(np.array(origins, np.int64))
        ar = torch.arange(tile, device=self.device)
        mask_canvas = torch.zeros((n, plan.canvas_h, plan.canvas_w), dtype=torch.uint8, device=self.device)
        for start in range(0, len(origins), self.batch_tiles):
            chunk = idx[start : start + self.batch_tiles]
            tiles = canvas[
                chunk[:, 0, None, None],
                (chunk[:, 1, None] + ar)[:, :, None],
                (chunk[:, 2, None] + ar)[:, None, :],
            ]
            profiling.count("fused.chunks")
            profiling.count("fused.tiles", tiles.shape[0])
            profiling.count("fused.tile_slots", self.batch_tiles)
            profiling.count("fused.bn_folded", self._bn_folded)
            profiling.count("fused.bn_eager", self._bn_eager)
            with profiling.device_span("fused.forward", self.device):
                packed = self.sharded_bits(tiles)
            # per-bit OR over overlapping tiles == the reference's
            # accumulate-then->=1 per model (predict.py:113-114)
            for i, (s, r, c) in enumerate(origins[start : start + self.batch_tiles]):
                mask_canvas[s, r : r + tile, c : c + tile] |= packed[i]
        if not cfg.bucket_sizes:
            mask_canvas = mask_canvas[:, : imgs.shape[1], : imgs.shape[2]]
        return _pack_bitplanes(mask_canvas, len(self.names))

    # -- staging -----------------------------------------------------------
    def _upload_array(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the device without a stream sync: a copy
        from pageable memory would wait for all work queued before it."""
        t = torch.from_numpy(a)
        if not self._cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, images: List[np.ndarray], plan: T.TilePlan) -> Tuple[np.ndarray, np.ndarray]:
        """Host arrays of one group: the stacked uint8 scenes and their
        (h, w); with bucketing each scene is padded into the bucket canvas."""
        n = len(images)
        hw = np.array([img.shape[:2] for img in images], np.int64)
        if self.cfg.bucket_sizes:
            staged = np.zeros((n, plan.canvas_h, plan.canvas_w, 3), np.uint8)
            for i, img in enumerate(images):
                staged[i, : img.shape[0], : img.shape[1]] = img
        else:
            staged = np.stack(images)
        return staged, hw

    @torch.inference_mode()
    def _dispatch(self, images: List[np.ndarray], plan: T.TilePlan):
        """Enqueue one group; returns what ``_fetch`` needs."""
        profiling.count("fused.dispatches")
        profiling.count("fused.scenes", len(images))
        with profiling.span("fused.stage"):
            staged, hw = self._stage(images, plan)
        host = torch.from_numpy(staged)
        if not self._cuda:
            with profiling.span("fused.launch"):
                return self._run_group(host, hw, plan), None, host
        with profiling.span("fused.upload"):
            imgs, host = upload_pinned(host, self.device, self._upload, span="fused.h2d")
        with profiling.span("fused.launch"), profiling.device_span("fused.dispatch", self.device):
            out, done = fetch_pinned(self._run_group(imgs, hw, plan), self.device)
        return out, done, host  # `host` stays alive until its upload is done

    @staticmethod
    def _fetch(pending) -> np.ndarray:
        out, done, _ = pending
        if done is not None:
            with profiling.span("fused.fetch_wait"):
                done.synchronize()
            profiling.resolve()
        return out.numpy()

    # -- host side ---------------------------------------------------------
    def _group_size(self, num_tiles: int) -> int:
        """Scenes per dispatch: fill the tile budget with same-shape scenes."""
        return max(1, self.batch_tiles // max(num_tiles, 1))

    def _split_group(self, count: int, cap: int) -> List[int]:
        """Split ``count`` same-shape scenes into allowed group sizes <= cap."""
        out: List[int] = []
        while count > 0:
            c = next(g for g in self._GROUP_SIZES if g <= min(count, cap))
            out.append(c)
            count -= c
        return out

    def _plan(self, image_rgb: np.ndarray) -> T.TilePlan:
        h, w = image_rgb.shape[:2]
        plan = T.plan_tiles(h, w, self.cfg)
        if plan.num_tiles and self.cfg.bucket_sizes:
            plan = T.bucket_plan(plan, self.cfg)
        return plan

    def _group(self, images) -> Tuple[list, list]:
        """The dispatches of a call, ``(scene indices, plan)`` each, and its
        scenes with no tile, ``(index, (h, w))`` each."""
        groups: Dict[tuple, list] = {}
        plans = []
        for idx, img in enumerate(images):
            plan = self._plan(img)
            plans.append(plan)
            if plan.num_tiles == 0:
                continue
            # plan.origins must be in the key: bucketing pads different real
            # tile grids to one count, and a group runs ONE origin list.
            key = (plan.canvas_h, plan.canvas_w, plan.origins,
                   img.shape[:2] if not self.cfg.bucket_sizes else None)
            groups.setdefault(key, []).append(idx)

        parts = []  # (scene indices, plan) per dispatch
        for idxs in groups.values():
            plan = plans[idxs[0]]
            start = 0
            for size in self._split_group(len(idxs), self._group_size(plan.num_tiles)):
                parts.append((idxs[start : start + size], plan))
                start += size
        degenerate = [(i, img.shape[:2]) for i, img in enumerate(images) if plans[i].num_tiles == 0]
        return parts, degenerate

    def _masks_from_planes(self, planes: np.ndarray, sizes) -> list:
        """Unpack fetched bitplanes into per-scene {0,255} mask dicts."""
        width = max(w for _, w in sizes)
        bits = _unpack_bitplanes(planes, min(width, planes.shape[-1] * 8))
        return [
            {name: bits[bit, i, :h, :w] * np.uint8(255) for bit, name in enumerate(self.names)}
            for i, (h, w) in enumerate(sizes)
        ]

    # -- public API ---------------------------------------------------------
    def predict_masks(self, image_rgb: np.ndarray) -> Dict[str, np.ndarray]:
        return self.predict_masks_many([image_rgb])[0]

    def predict_masks_iter(
        self, images, max_in_flight: int = 8
    ) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """Dispatch ahead, yield ``(index, masks)`` as fetched.

        Up to ``max_in_flight`` groups are enqueued ahead of the fetch point;
        the bound keeps the queued scenes and outputs from exhausting device
        memory on large batches.  Yield order is dispatch order, not input
        order: use the index.  Scenes with no tile come last, blank.
        """
        call = profiling.span("fused.call", root=True)
        call.__enter__()
        try:
            with profiling.span("fused.plan"):
                parts, degenerate = self._group(images)
        except BaseException:
            call.__exit__(None, None, None)
            raise

        def dispatch(part, plan):
            imgs = [images[i] for i in part]
            return part, self._dispatch(imgs, plan), [im.shape[:2] for im in imgs]

        max_in_flight = max(1, max_in_flight)

        def run():
            try:
                pending = [dispatch(*p) for p in parts[:max_in_flight]]
                next_up = max_in_flight
                while pending:
                    part, handle, sizes = pending.pop(0)
                    if next_up < len(parts):  # keep the window full
                        pending.append(dispatch(*parts[next_up]))
                        next_up += 1
                    planes = self._fetch(handle)
                    with profiling.span("fused.unpack"):
                        masks = self._masks_from_planes(planes, sizes)
                    yield from zip(part, masks)
                for idx, (h, w) in degenerate:
                    zero = np.zeros((h, w), np.uint8)
                    yield idx, {name: zero.copy() for name in self.names}
            finally:
                call.__exit__(None, None, None)

        return run()

    def predict_masks_many(self, images, max_in_flight: int = 8) -> list:
        """Pipelined, scene-grouped batch prediction; results in input order."""
        results: list = [None] * len(images)
        for idx, masks in self.predict_masks_iter(images, max_in_flight):
            results[idx] = masks
        return results

    def predict_vote(self, image_rgb: np.ndarray, threshold: int = 3) -> np.ndarray:
        """Fast path: a plain ``threshold``-of-members vote without the
        reference's per-model morphological cleanup (`model_fuse.py:285-313`),
        so NOT mask-parity with the reference; the Pipeline's fusion is."""
        masks = self.predict_masks(image_rgb)
        votes = sum((masks[name] > 0).astype(np.int32) for name in self.names)
        return np.where(votes >= threshold, 255, 0).astype(np.uint8)
