"""PyTorch port, one train step and a 3-step trajectory of each of the five
members against the JAX ``Trainer``, on the CPU.

Both trainers start from the JAX package's weights (carried over with
``load_jax_variables``) and take the same three numpy-seeded batches of
two 32 px tiles, f32, with the default recipe cut to one warmup epoch of
three steps (lr 1e-5, 3.4e-4, 6.7e-4).  The gradient is read from the Adam
first moment after step 1, ``mu = (1 - b1) * g``, in both packages.

Tolerances, per tensor, from the spread measured between the two packages
on this setup (the JAX package's own tf_keras probe,
``scripts/tf_model_grad_parity.py``, found the same behaviour against
tf_keras).  Train-mode BN over a few samples (2 x 2 x 2 at the deepest
level) amplifies float rounding in the backward, so gradients of the BN
members agree to about 1e-2 of the gradient scale while scse, which has no
BN, agrees to 1e-6; a semantic fault (a BN statistic, the lr index, the
Adam epsilon) shows up at 0.1-1 relative.

* Step 1 (same weights going in, no compounding): loss 1e-5; metrics 1e-3
  (two pixels of 2048); gradients 2e-2 of the largest gradient, element
  by element, and 3e-2 in L2 over all tensors (measured at most 6.5e-3 and
  8.7e-3); params 3e-5, since at lr 1e-5 Keras Adam moves a weight by at
  most about lr whatever its gradient (measured 2.0e-5), with the update
  direction's cosine >= 0.995; BN moving statistics 1e-4 of each tensor's
  scale + 1e-5 (measured at most 3 % of that).
* Steps 2-3, where Adam turns near-zero gradients of either sign into
  steps of about lr and so compounds the step-1 rounding: losses 5e-4 and
  2e-2 (measured over two seeds at most 6.9e-5 and 5.6e-3); metrics 2e-2;
  the parameter update since step 0 with cosine >= 0.98 after step 2 and
  >= 0.7 after step 3 (measured at least 0.990 and 0.856), its norm within
  5 % (measured 2.2 %), and no element further apart than 2 x the summed
  lr; the change of the BN moving statistics within 5e-2 in L2 (measured
  at most 1.1e-2).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from building_detection_tpu.core.config import TrainConfig
from building_detection_tpu.parallel.mesh import make_mesh
from building_detection_tpu.train.trainer import Trainer as JaxTrainer
from building_detection_tpu_torch.core.module import jax_variables, load_jax_variables
from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER
from building_detection_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

CFG = TrainConfig(batch_size=2, image_size=32, epochs=1, warmup_epochs=1)
STEPS = 3
B1 = 0.9


def f64(tree):
    return {k: np.asarray(v, np.float64) for k, v in tree.items()}


def flat(d, keys):
    return np.concatenate([d[k].ravel() for k in keys])


@functools.lru_cache(maxsize=None)
def run(name):
    """Both trainers over STEPS steps: per step the metrics, the Adam first
    moment, the params and the BN state of each, and the lr used."""
    rng = np.random.RandomState(ENSEMBLE_ORDER.index(name))
    imgs = rng.randint(0, 256, (STEPS, 2, 32, 32, 3)).astype(np.uint8)
    labs = np.where(rng.rand(STEPS, 2, 32, 32) < 0.4, 255, 0).astype(np.uint8)
    jt = JaxTrainer(name, CFG, steps_per_epoch=STEPS, mesh=make_mesh(data=1))
    p0 = {k: np.asarray(v) for k, v in jax.device_get(jt.params).items()}
    s0 = {k: np.asarray(v) for k, v in jax.device_get(jt.state).items()}
    pt = Trainer(name, CFG, steps_per_epoch=STEPS, device="cpu")
    load_jax_variables(pt.model, p0, s0)
    steps = []
    for i in range(STEPS):
        lr = pt.current_lr()
        mj, mp = jt.train_on_batch(imgs[i], labs[i]), pt.train_on_batch(imgs[i], labs[i])
        opt = pt.optimizer.jax_state()
        pp, sp = jax_variables(pt.model)
        steps.append({
            "lr": lr,
            "metrics": (mj, mp),
            "mu": (f64(jax.device_get(jt.opt_state).mu), {k: opt[f".mu['{k}']"].astype(np.float64) for k in p0}),
            "params": (f64(jax.device_get(jt.params)), f64(pp)),
            "state": (f64(jax.device_get(jt.state)), f64(sp)),
        })
    return f64(p0), f64(s0), steps


def check_metrics(step, loss_atol, metric_atol):
    mj, mp = step["metrics"]
    assert sorted(mp) == sorted(mj)
    assert abs(mp["loss"] - mj["loss"]) <= loss_atol, (mp["loss"], mj["loss"])
    for k in mj:
        assert abs(mp[k] - mj[k]) <= max(metric_atol, loss_atol), k


def update_agreement(p0, step):
    pj, pp = step["params"]
    keys = sorted(p0)
    uj, up = flat(pj, keys) - flat(p0, keys), flat(pp, keys) - flat(p0, keys)
    cos = float(uj @ up / (np.linalg.norm(uj) * np.linalg.norm(up)))
    return cos, float(np.linalg.norm(up) / np.linalg.norm(uj)), float(np.abs(uj - up).max())


@pytest.mark.parametrize("name", ENSEMBLE_ORDER)
def test_step1_matches_jax_trainer(name):
    p0, s0, steps = run(name)
    first = steps[0]
    check_metrics(first, 1e-5, 1e-3)
    gj, gp = (1.0 / (1.0 - B1) * np.concatenate([m[k].ravel() for k in sorted(m)]) for m in first["mu"])
    scale = float(np.abs(gj).max())
    assert scale > 0
    for k in sorted(p0):
        d = float(np.abs(first["mu"][0][k] - first["mu"][1][k]).max()) / (1.0 - B1)
        assert d <= 2e-2 * scale, (k, d, scale)
    assert np.linalg.norm(gp - gj) <= 3e-2 * np.linalg.norm(gj)
    pj, pp = first["params"]
    for k in p0:
        assert float(np.abs(pj[k] - pp[k]).max()) <= 3e-5, k
    cos, _, _ = update_agreement(p0, first)
    assert cos >= 0.995
    sj, sp = first["state"]
    for k in s0:
        assert float(np.abs(sj[k] - sp[k]).max()) <= 1e-4 * float(np.abs(sj[k]).max()) + 1e-5, k


@pytest.mark.parametrize("name", ENSEMBLE_ORDER)
def test_trajectory_matches_jax_trainer(name):
    p0, s0, steps = run(name)
    for step, loss_atol, min_cos in ((steps[1], 5e-4, 0.98), (steps[2], 2e-2, 0.7)):
        check_metrics(step, loss_atol, 2e-2)
        cos, ratio, worst = update_agreement(p0, step)
        assert cos >= min_cos and abs(ratio - 1.0) <= 5e-2, (cos, ratio)
    assert worst <= 2.0 * sum(s["lr"] for s in steps), worst
    if s0:
        sj, sp = steps[-1]["state"]
        for suffix in ("moving_mean", "moving_variance"):
            keys = sorted(k for k in s0 if k.endswith(suffix))
            dj, dp = flat(sj, keys) - flat(s0, keys), flat(sp, keys) - flat(s0, keys)
            assert np.linalg.norm(dp - dj) <= 5e-2 * np.linalg.norm(dj), suffix
