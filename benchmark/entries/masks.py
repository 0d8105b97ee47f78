"""Entry ``masks``: scene lists through ``FusedEnsemblePredictor.predict_masks_many``.

Set-up makes each member's weights from the seed (calibrating the BN
moving statistics on a batch of generated tiles), builds the program's members and
its fused predictor through its public API, makes the mix's pool of scenes
on the device and brings them to the host (the predictor takes host
arrays), and runs one list through the predictor so every shape of the
window is warm.  A unit of work is one ``predict_masks_many`` call over the
next ``per_call`` scenes of the pool, which returns every member's mask of
every scene.

A reservoir of ``sample_scenes`` finished requests, drawn from the seed,
keeps their masks.  The check runs the reference members in float32 with
TF32 off over those scenes, tile by tile, and compares every pixel of every
member (:func:`benchmark.harness.compare.mask_numbers`).

``variant`` is for the controls and the tests, never for a benchmark run:
``int8`` switches on the program's int8 pointwise convs (the control),
``fault:alter`` flips one member's bits over the first tile of every
chunk, ``fault:half`` forwards only the first half of every chunk's tiles.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import compare, program, traffic, weights as W
from benchmark.harness.spec import Phases
from benchmark.reference import layers as RL, models as RM, tiler as RT


class Session:
    requests = "scenes"  # what ``attempted`` counts

    def __init__(self, cell: Dict, seed: int, device, variant: Optional[str] = None):
        from building_detection_tpu_torch.core.config import TilerConfig
        from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor

        self.cell, self.device = cell, torch.device(device)
        self.phases = Phases(self.device)
        cfg, mix = cell["config"], cell["traffic"]
        self.members: List[str] = list(cfg["members"])
        self.tile, self.stride = int(cfg["tile"]), int(cfg["stride"])
        size = int(mix["scene_px"])

        # the benchmark's inputs: weights (kept on the host for the check) and scenes
        calib, _ = traffic.scenes(mix["scene"], traffic.sub_seed(seed, "calibration"), int(cfg["calibration_tiles"]),
                                  self.tile, self.device)
        calib = RT.normalize(calib)
        self.weights, built = {}, {}
        for name in self.members:
            ref = RM.build(name, self.device)
            w = W.make(ref, traffic.sub_seed(seed, "weights", name), self.device)
            w = W.calibrate_bn(ref, w, calib)
            del ref
            built[name] = program.fill(program.build_member(name, self.device), w)
            self.weights[name] = W.to_host(w)
            del w
        self.phases.mark("weights")
        images, _ = traffic.scenes(mix["scene"], seed, int(mix["pool"]), size, self.device)
        self.pool = list(images.cpu().numpy())
        del images, calib
        self.phases.mark("scenes")
        if self.device.type == "cuda":  # the program's peak starts here
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

        tiler = TilerConfig(tile=self.tile, stride=self.stride, overlap=self.tile - self.stride)
        self.predictor = FusedEnsemblePredictor(
            built, cfg=tiler, batch_tiles=int(cfg["batch_tiles"]), compute_dtype=program.DTYPES[cfg["compute_dtype"]],
            device=self.device, int8_pointwise=(variant == "int8"),
        )
        del built
        self.phases.mark("predictor")
        if variant and variant.startswith("fault:"):
            self._plant(variant[len("fault:"):])
        self.per_call = int(mix["per_call"])
        self.tiles_per_scene = RT.num_tiles(size, size, self.tile, self.stride)
        self.k = int(cell["check"]["sample_scenes"])
        self.rng = np.random.default_rng(traffic.sub_seed(seed, "sample"))
        self.next_scene, self.finished, self.sampling = 0, 0, False
        self.sample: List[tuple] = []  # (pool index, masks)

        self.unit()  # warm-up: the window's one list shape
        self.phases.mark("warm-up")

    def _plant(self, fault: str) -> None:
        stages = self.predictor._stages
        if fault == "alter":
            first = stages[0]

            def altered(tiles, packed):
                out = first(tiles, packed)
                out[0] ^= 1
                return out

            stages[0] = altered
        elif fault == "half":
            def halved(stage):
                def run(tiles, packed):
                    k = (tiles.shape[0] + 1) // 2
                    out = stage(tiles[:k], None if packed is None else packed[:k])
                    full = torch.zeros((tiles.shape[0],) + tuple(out.shape[1:]), dtype=out.dtype, device=out.device)
                    full[:k] = out
                    return full
                return run

            stages[:] = [halved(s) for s in stages]
        else:
            raise ValueError(f"unknown fault {fault!r}")

    def begin_window(self) -> None:
        self.sampling, self.finished, self.sample = True, 0, []

    def end_window(self) -> None:
        self.sampling = False

    def unit(self) -> Dict[str, int]:
        """One call over the next ``per_call`` scenes of the pool."""
        idx = [(self.next_scene + i) % len(self.pool) for i in range(self.per_call)]
        self.next_scene = (self.next_scene + self.per_call) % len(self.pool)
        results = self.predictor.predict_masks_many([self.pool[i] for i in idx])
        if self.sampling:
            for i, masks in zip(idx, results):
                if len(masks) != len(self.members):
                    raise RuntimeError(f"scene {i}: {len(masks)} masks for {len(self.members)} members")
                if len(self.sample) < self.k:
                    self.sample.append((i, masks))
                else:
                    j = int(self.rng.integers(0, self.finished + 1))
                    if j < self.k:
                        self.sample[j] = (i, masks)
                self.finished += 1
        return {"tiles": self.tiles_per_scene * len(idx), "scenes": len(idx)}

    trace_unit = host_trace_unit = unit

    @staticmethod
    def end_to_end(done: Dict[str, int], seconds: float) -> Dict[str, float]:
        return {"tiles_per_s": done["tiles"] / seconds}

    def release(self) -> None:
        del self.predictor
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    @torch.no_grad()
    def margins(self, fp8: bool = False) -> List[Dict[str, torch.Tensor]]:
        """The reference's margins over the sampled scenes, member by member
        (``fp8``: on float8 e4m3 products, the reference's control)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        batch = int(self.cell["check"]["reference_batch"])
        out: List[Dict[str, torch.Tensor]] = [{} for _ in self.sample]
        for name in self.members:
            ref = RL.set_fp8(RL.set_logits(RM.build(name, self.device)), fp8)
            RL.load_keras(ref, W.to_device(self.weights[name], self.device))
            for slot, (i, _) in enumerate(self.sample):
                scene = torch.from_numpy(self.pool[i]).to(self.device)
                out[slot][name] = RT.margins(ref, scene, self.tile, self.stride, batch).cpu()
            del ref
        return out

    def check(self, margins: Optional[List[Dict[str, torch.Tensor]]] = None) -> Dict[str, float]:
        return compare.mask_numbers([m for _, m in self.sample], margins or self.margins())
