"""Entry ``train``: one member trained with ``Trainer.train_epoch_staged`` on a staged split.

Set-up makes the member's weights from the seed, builds the program's
``Trainer`` (the recipe's batch, loss, Keras Adam and warmup-cosine
schedule, bf16 compute over f32 master parameters) and gives it those
weights, and makes the mix's train split on the device in the layout
``Trainer.stage_dataset`` gives it, ``(steps, batch, H, W, ...)`` uint8.
It then drives the trainer through its first three steps with the window's
own call, ``train_epoch_staged``, on the split's first three batches: after
the first it reads the gradient from Keras Adam's first moment
(``m = 0.1 g``), after the third the change of every tensor.  Those steps
also build and warm every kernel of the step.  A unit of work is one
``train_epoch_staged`` call over the next ``chunk_steps`` batches, which
fetches the chunk's metrics.

The check runs the reference member (float32, TF32 off) through the same
three steps from the same weights on the same batches and compares the
losses, the first gradient and the change
(:func:`benchmark.harness.compare.train_numbers`).

``variant`` is for the controls and the tests, never for a benchmark run:
``fault:half`` trains on the first half of every batch, ``fault:alter``
doubles the gradient of the largest tensor before Keras Adam gets it, and
``fault:frozen`` makes Keras Adam leave the parameters as they are.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness import compare, program, traffic, weights as W
from benchmark.harness.spec import Phases
from benchmark.reference import layers as RL, models as RM, train as RTR
from benchmark.reference.layers import TO_TORCH

FIRST = 3  # steps the check follows


def _torch_layout(w: torch.Tensor) -> torch.Tensor:
    return w.permute(TO_TORCH[w.dim()]) if w.dim() in TO_TORCH else w


class Session:
    requests = "steps"  # what ``attempted`` counts

    def __init__(self, cell: Dict, seed: int, device, variant: Optional[str] = None, steps: Optional[int] = None):
        from building_detection_tpu_torch.core.config import TrainConfig
        from building_detection_tpu_torch.train.trainer import Trainer

        self.cell, self.device = cell, torch.device(device)
        self.phases = Phases(self.device)
        cfg, mix = cell["config"], cell["traffic"]
        self.member = cfg["member"]
        self.batch, size = int(mix["batch"]), int(mix["tile_px"])
        self.steps_per_epoch = int(mix["tiles"]) // self.batch
        n_steps = steps or self.steps_per_epoch
        self.chunk, self.trace_steps = int(mix["chunk_steps"]), int(mix["trace_steps"])
        self.host_trace_steps = int(mix["host_trace_steps"])

        ref = RM.build(self.member, self.device)
        w = W.make(ref, traffic.sub_seed(seed, "weights", self.member), self.device)
        del ref
        self.init = W.to_host(w)
        self.trainer = Trainer(
            lambda: program.build_member(self.member, self.device), TrainConfig(batch_size=self.batch),
            steps_per_epoch=self.steps_per_epoch, compute_dtype=program.DTYPES[cfg["compute_dtype"]], device=self.device,
        )
        program.fill(self.trainer.model, w)
        del w
        self.phases.mark("trainer")
        images, labels = traffic.scenes(mix["scene"], seed, n_steps * self.batch, size, self.device)
        self.images = images.view(n_steps, self.batch, size, size, 3)
        self.labels = labels.view(n_steps, self.batch, size, size)
        del images, labels
        self.phases.mark("split")
        if self.device.type == "cuda":  # the program's peak starts here
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        if variant:
            self._plant(variant)
        self.first_batches = (self.images[:FIRST].cpu(), self.labels[:FIRST].cpu())
        self.readings = self._first_steps()
        self.cursor = FIRST
        self.phases.mark("first steps")

    def _plant(self, variant: str) -> None:
        t, opt = self.trainer, self.trainer.optimizer
        if variant == "fault:half":
            step, half = t._train_step, self.batch // 2
            t._train_step = lambda images, labels, i: step(images[:half], labels[:half], i)
        elif variant == "fault:alter":
            update, largest = opt.step, max(opt.params, key=lambda k: opt.params[k].numel())
            opt.step = lambda grads: update({k: g * 2 if k == largest else g for k, g in grads.items()})
        elif variant == "fault:frozen":
            opt.step = lambda grads: None
        else:
            raise ValueError(f"unknown variant {variant!r}")

    def _first_steps(self) -> Dict:
        """The first three steps through ``train_epoch_staged``; the
        gradient after the first (from Adam's first moment) and the change
        of every tensor after the third, as norms by leaf."""
        t, opt = self.trainer, self.trainer.optimizer
        losses = [t.train_epoch_staged(self.images[0:1], self.labels[0:1])["loss"]]
        grad_norms = {k: float(m.norm()) / (1.0 - opt.b1) for k, m in opt.mu.items()}
        losses.append(t.train_epoch_staged(self.images[1:FIRST], self.labels[1:FIRST])["loss"])
        change = {}
        with torch.no_grad():
            for key, tensor in program.program_tensors(t.model).items():
                start = _torch_layout(self.init[key]).to(self.device)
                change[key] = float((tensor.float() - start).norm())
        return {"loss": np.concatenate(losses).astype(np.float64), "grad_norms": grad_norms, "change_norms": change}

    def begin_window(self) -> None:
        pass

    def end_window(self) -> None:
        pass

    def _steps(self, n: int) -> Dict[str, int]:
        start = self.cursor if self.cursor + n <= self.images.shape[0] else 0
        self.trainer.train_epoch_staged(self.images[start : start + n], self.labels[start : start + n])
        self.cursor = start + n
        return {"images": n * self.batch, "steps": n}

    def unit(self) -> Dict[str, int]:
        return self._steps(self.chunk)

    def trace_unit(self) -> Dict[str, int]:
        return self._steps(self.trace_steps)

    def host_trace_unit(self) -> Dict[str, int]:
        return self._steps(self.host_trace_steps)

    @staticmethod
    def end_to_end(done: Dict[str, int], seconds: float) -> Dict[str, float]:
        return {"train_images_per_s": done["images"] / seconds}

    def release(self) -> None:
        del self.trainer, self.images, self.labels
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference(self, fp8: bool = False) -> Dict:
        """The reference's three steps from the same weights on the same
        batches (``fp8``: every conv and dense product on float8 e4m3
        inputs, the lower-precision control)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = RL.set_fp8(RM.build(self.member, self.device), fp8)
        RL.load_keras(ref, W.to_device(self.init, self.device))
        images, labels = (list(x.to(self.device)) for x in self.first_batches)
        out = RTR.steps(ref, images, labels, self.steps_per_epoch)
        change = {k: float((t - _torch_layout(self.init[k]).to(self.device)).norm()) for k, t in out["tensors"].items()}
        state = {k for k in change if k.endswith(("/moving_mean", "/moving_variance"))}
        return {"loss": out["loss"], "grad_norms": out["grad_norms"], "change_norms": change, "state": state}

    def check(self, reference: Optional[Dict] = None, worst: Optional[Dict] = None) -> Dict[str, float]:
        ref = reference or self.reference()
        p = self.readings
        return compare.train_numbers(p["loss"], p["grad_norms"], p["change_norms"],
                                     ref["loss"], ref["grad_norms"], ref["change_norms"], ref["state"], worst)
