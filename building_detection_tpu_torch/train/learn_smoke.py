"""Learning smoke test of the five members on synthetic rectangle buildings.

The counterpart of the JAX package's ``scripts/learn_smoke.py``.  Per
member: train on bright rectangles over dark noise with the production
recipe (the edge maps made in every step, the edge focal loss, Keras Adam
with warmup-cosine, BN moving statistics, staged epochs), then evaluate the
eval-mode model on a held-out batch and require IoU > 0.5.  A bad gradient
in any branch of any member fails it.

Run, on the card by default::

    python -m building_detection_tpu_torch.train.learn_smoke [--device cpu] [--seed N] [--dtype bf16|f32]
        [--init CHECKPOINT.npz member | member ...]

(all five members when none is named; exit 1 unless every one passes).
``RECIPES`` and :func:`make_dataset` are copies of the JAX script's: the
same steps, sizes and learning rates, and the same bytes from the same
``np.random.RandomState``.  ``--seed`` draws the initial weights
(``Trainer(seed=)``, as in the JAX package) and ``--dtype`` is the compute
dtype (the bf16 and f32 legs of the JAX package's
``scripts/tf_convergence_floor.py``).  ``--init`` starts the one member
named from the params and BN state of an ``.npz`` checkpoint of either
package instead, such as the JAX trainer's initial draw.

Two held-out figures are printed.  The gated one is the eval-mode model's,
whose BatchNorms use the moving statistics (Keras momentum 0.99); the other
(:func:`eval_batch_stats`) normalises with the held-out batch's own
statistics and leaves the moving ones alone.  A member that learned scores
high on the second even while its moving statistics still lag behind
weights that are moving, which is what lowers the first on the BN members.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from building_detection_tpu_torch.core.config import TrainConfig
from building_detection_tpu_torch.core.module import load_jax_variables
from building_detection_tpu_torch.nn.layers import _moving_stats_frozen
from building_detection_tpu_torch.ops import tiling as T
from building_detection_tpu_torch.train.checkpoint import load_variables
from building_detection_tpu_torch.train.metrics import all_metrics
from building_detection_tpu_torch.train.trainer import Trainer, make_targets

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
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# Members whose output is constant on k x k tiles: bam upsamples its last
# features x4 (nearest) before its 1x1 softmax conv, as the reference's
# bam.py does, so no mask of its can score above block_ceiling_iou.
OUTPUT_BLOCK = {"bam": 4}


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


def block_ceiling_iou(labels_u8: np.ndarray, block: int) -> float:
    """The highest IoU (the metrics' building IoU, over the whole batch) that
    any mask constant on ``block`` x ``block`` tiles scores against the
    {0, 255} labels ``(N, H, W)``.  For each number of tiles the best set
    takes the tiles with the most building pixels, so the ceiling is the
    best prefix of the tiles sorted by that count."""
    g = np.asarray(labels_u8) == 255
    n, h, w = g.shape
    per_tile = np.sort(g.reshape(n, h // block, block, w // block, block).sum(axis=(2, 4)).ravel())[::-1]
    tp = np.cumsum(per_tile)
    predicted = block * block * np.arange(1, per_tile.size + 1)
    return float(np.max(tp / (predicted + g.sum() - tp)))


@torch.no_grad()
def eval_batch_stats(trainer: Trainer, images_u8, labels_u8) -> Dict[str, float]:
    """Metrics and loss of ``trainer``'s model on one batch with every
    BatchNorm normalising by that batch's own statistics (train mode), the
    moving statistics and the step count left as they are."""
    model = trainer.model
    x = T.normalize(torch.as_tensor(images_u8).to(trainer.device), dtype=trainer.compute_dtype)
    y_true = make_targets(torch.as_tensor(labels_u8).to(trainer.device), trainer.cfg, trainer.cfg.label_smooth)
    model.train()
    with _moving_stats_frozen(model):
        probs = model(x).float()
    metrics = all_metrics(y_true, probs)
    metrics["loss"] = trainer.loss_fn(y_true, probs)
    return {k: float(v) for k, v in metrics.items()}


def run_one(
    name: str,
    device=None,
    recipe: Optional[Tuple[int, int, float]] = None,
    log=print,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    init: Optional[Tuple[Mapping[str, np.ndarray], Mapping[str, np.ndarray]]] = None,
) -> Dict[str, float]:
    """Train ``name`` in ``dtype`` on ``device`` (the card by default) by
    ``recipe`` (``RECIPES[name]`` by default) from the weights that ``seed``
    draws, or from ``init``, a ``(params, state)`` pair of numpy dicts in
    the JAX package's layout, and evaluate it on the held-out batch.
    Returns the held-out metrics and loss of the eval-mode model, the same
    with the batch's own BN statistics under ``batch_stats_`` names
    (:func:`eval_batch_stats`), ``ceiling_IoU`` (the best IoU any mask the
    member can output scores on the held-out batch: 1 unless
    ``OUTPUT_BLOCK`` names it), ``train_loss`` and ``train_IoU`` (the last
    step's), ``seconds`` (training and evaluation, the trainer's set-up
    excluded), ``steps``, ``step_ms`` (the mean host milliseconds of a step
    over the chunks after the first, which warms up; over the one chunk
    where there is only one), ``seed``, ``dtype`` (its ``DTYPES`` name) and
    ``passed`` (eval-mode held-out IoU > 0.5)."""
    steps, hw, lr = recipe or RECIPES[name]
    dtype_name = {v: k for k, v in DTYPES.items()}[dtype]
    tr = Trainer(name, learn_config(hw, lr), steps_per_epoch=steps, compute_dtype=dtype, seed=seed, device=device)
    if init is not None:
        load_jax_variables(tr.model, *init)
    t0 = time.perf_counter()
    chunks = train_staged(tr, steps, hw, log=log, name=name)
    timed = chunks[1:] or chunks
    step_ms = 1e3 * sum(secs for _, secs in timed) / sum(len(m["loss"]) for m, _ in timed)
    batch = held_out(hw)
    ev = tr.eval_on_batch(*batch)
    bs = eval_batch_stats(tr, *batch)
    seconds = time.perf_counter() - t0
    passed = ev["IoU"] > IOU_GATE
    last = chunks[-1][0]
    log(
        f"{name}: {'PASS' if passed else 'FAIL'} held-out IoU={ev['IoU']:.3f} "
        f"PA={ev['PA']:.3f} F1={ev['F1_score']:.3f} "
        f"({steps} steps, {seconds:.0f}s, {step_ms:.1f} ms/step)"
    )
    start = "the given weights" if init is not None else f"seed {seed}"
    log(
        f"{name}: {start}, {dtype_name}: held-out IoU {ev['IoU']:.4f} eval mode (moving BN statistics), "
        f"{bs['IoU']:.4f} with the batch's own BN statistics; last training batch IoU {float(last['IoU'][-1]):.4f}"
    )
    block = OUTPUT_BLOCK.get(name, 1)
    ceiling = block_ceiling_iou(batch[1], block)
    if block > 1:
        log(f"{name}: its output is constant on {block}x{block} tiles; the best such mask scores held-out IoU "
            f"{ceiling:.4f}")
    return {**ev, **{f"batch_stats_{k}": v for k, v in bs.items()}, "train_loss": float(last["loss"][-1]),
            "train_IoU": float(last["IoU"][-1]), "seconds": seconds, "steps": steps, "step_ms": step_ms,
            "ceiling_IoU": ceiling, "seed": seed, "dtype": dtype_name, "passed": passed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m building_detection_tpu_torch.train.learn_smoke",
        description="Train each member on synthetic rectangles and require held-out IoU > 0.5.",
    )
    ap.add_argument("members", nargs="*", help=f"members to train, of {', '.join(RECIPES)} (default: all five)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the initial weights (default: 0)")
    ap.add_argument("--dtype", choices=list(DTYPES), default="bf16", help="compute dtype (default: bf16)")
    ap.add_argument("--init", metavar="CHECKPOINT.npz", default=None,
                    help="start the one member named from this checkpoint's params and BN state")
    args = ap.parse_args(argv)
    names = args.members or list(RECIPES)
    unknown = [n for n in names if n not in RECIPES]
    if unknown:
        ap.error(f"unknown members {unknown}; choose from {list(RECIPES)}")
    if args.init and len(names) != 1:
        ap.error(f"--init takes one member, got {names}")
    init = load_variables(args.init)[:2] if args.init else None
    log = lambda s: print(s, flush=True)  # noqa: E731
    results = {n: run_one(n, device=args.device, log=log, seed=args.seed, dtype=DTYPES[args.dtype],
                          init=init)["passed"] for n in names}
    print("; ".join(f"{n}={'PASS' if ok else 'FAIL'}" for n, ok in results.items()))
    if not all(results.values()):
        return 1
    print("LEARNING OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
