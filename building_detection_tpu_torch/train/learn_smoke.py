"""Learning smoke test of the five members on synthetic rectangle buildings.

The counterpart of the JAX package's ``scripts/learn_smoke.py``.  Per
member: train on bright rectangles over dark noise with the production
recipe (the edge maps made in every step, the edge focal loss, Keras Adam
with warmup-cosine, BN moving statistics, staged epochs), then evaluate the
eval-mode model on a held-out batch and require IoU > 0.5.  A bad gradient
in any branch of any member fails it.

Run, on the card by default::

    python -m building_detection_tpu_torch.train.learn_smoke [--device cpu] [member ...]

(all five members when none is named; exit 1 unless every one passes).
``RECIPES`` and :func:`make_dataset` are copies of the JAX script's: the
same steps, sizes and learning rates, and the same bytes from the same
``np.random.RandomState``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from building_detection_tpu_torch.core.config import TrainConfig
from building_detection_tpu_torch.train.trainer import Trainer

# (steps, image hw, lr) per model: the deep Xception pair learns the toy
# task in fewer steps at 128px but each step is ~6x res34's cost
RECIPES = {
    "res34": (300, 128, 5e-4),
    "scse": (300, 128, 5e-4),
    "hrnet": (300, 128, 5e-4),
    "v3plus": (150, 128, 5e-4),
    "bam": (150, 128, 5e-4),
}
BATCH = 8
CHUNK = 50          # steps staged on the device at a time
HELD_OUT_SEED = 999
IOU_GATE = 0.5


def make_dataset(rng, n, hw):
    """``n`` dark noisy ``hw`` x ``hw`` images with 2-4 bright rectangles,
    and their {0, 255} labels.  Needs ``hw > 40``."""
    imgs = rng.randint(0, 60, (n, hw, hw, 3)).astype(np.uint8)  # dark bg
    labs = np.zeros((n, hw, hw), np.uint8)
    for i in range(n):
        for _ in range(rng.randint(2, 5)):
            x, y = rng.randint(0, hw - 40, 2)
            w, h = rng.randint(12, 40, 2)
            imgs[i, y : y + h, x : x + w] = rng.randint(150, 255, 3)
            labs[i, y : y + h, x : x + w] = 255
    return imgs, labs


def learn_config(hw: int, lr: float) -> TrainConfig:
    """The recipe's trainer config: one epoch, no warmup."""
    return TrainConfig(batch_size=BATCH, epochs=1, warmup_epochs=0, image_size=hw, lr_base=lr)


def train_staged(trainer, steps: int, hw: int, log=print, name: str = "") -> list:
    """``steps`` steps in staged chunks of ``CHUNK``, each chunk's data drawn
    in turn from one ``RandomState(0)``; returns each chunk's metrics (numpy
    arrays, one entry a step) and host seconds, the fetch of its metrics
    included.  Takes the JAX package's ``Trainer`` too, which has the same
    staged interface."""
    rng = np.random.RandomState(0)
    chunks = []
    done = 0
    while done < steps:
        k = min(CHUNK, steps - done)
        imgs, labs = make_dataset(rng, k * BATCH, hw)
        t0 = time.perf_counter()
        m = trainer.train_epoch_staged(*trainer.stage_dataset(imgs, labs))
        m = {key: np.asarray(v) for key, v in m.items()}
        chunks.append((m, time.perf_counter() - t0))
        done += k
        log(f"  {name} step {done:3d} loss={float(m['loss'][-1]):.4f} IoU={float(m['IoU'][-1]):.3f}")
    return chunks


def held_out(hw: int):
    return make_dataset(np.random.RandomState(HELD_OUT_SEED), BATCH, hw)


def run_one(
    name: str,
    device=None,
    recipe: Optional[Tuple[int, int, float]] = None,
    log=print,
) -> Dict[str, float]:
    """Train ``name`` in bf16 on ``device`` (the card by default) by
    ``recipe`` (``RECIPES[name]`` by default) and evaluate it on the
    held-out batch.  Returns the held-out metrics and loss, ``train_loss``
    (the last step's), ``seconds`` (training and evaluation, the trainer's
    set-up excluded), ``steps``, ``step_ms`` (the mean host milliseconds of
    a step over the chunks after the first, which warms up; over the one
    chunk where there is only one) and ``passed`` (held-out IoU > 0.5)."""
    steps, hw, lr = recipe or RECIPES[name]
    tr = Trainer(name, learn_config(hw, lr), steps_per_epoch=steps, compute_dtype=torch.bfloat16, device=device)
    t0 = time.perf_counter()
    chunks = train_staged(tr, steps, hw, log=log, name=name)
    timed = chunks[1:] or chunks
    step_ms = 1e3 * sum(secs for _, secs in timed) / sum(len(m["loss"]) for m, _ in timed)
    ev = tr.eval_on_batch(*held_out(hw))
    seconds = time.perf_counter() - t0
    passed = ev["IoU"] > IOU_GATE
    log(
        f"{name}: {'PASS' if passed else 'FAIL'} held-out IoU={ev['IoU']:.3f} "
        f"PA={ev['PA']:.3f} F1={ev['F1_score']:.3f} "
        f"({steps} steps, {seconds:.0f}s, {step_ms:.1f} ms/step)"
    )
    return {**ev, "train_loss": float(chunks[-1][0]["loss"][-1]), "seconds": seconds, "steps": steps,
            "step_ms": step_ms, "passed": passed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m building_detection_tpu_torch.train.learn_smoke",
        description="Train each member on synthetic rectangles and require held-out IoU > 0.5.",
    )
    ap.add_argument("members", nargs="*", help=f"members to train, of {', '.join(RECIPES)} (default: all five)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    names = args.members or list(RECIPES)
    unknown = [n for n in names if n not in RECIPES]
    if unknown:
        ap.error(f"unknown members {unknown}; choose from {list(RECIPES)}")
    log = lambda s: print(s, flush=True)  # noqa: E731
    results = {n: run_one(n, device=args.device, log=log)["passed"] for n in names}
    print("; ".join(f"{n}={'PASS' if ok else 'FAIL'}" for n, ok in results.items()))
    if not all(results.values()):
        return 1
    print("LEARNING OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
