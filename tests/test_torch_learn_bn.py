"""PyTorch port, the learning smoke's BN members (hrnet, v3plus, bam) held
against the JAX ``Trainer`` after staged training, on the CPU.

Both trainers start from the JAX trainer's initial weights
(``load_jax_variables``) and train in f32 by the learning smoke's recipe
config (``learn_smoke.learn_config``: one epoch, no warmup, lr 5e-4 on the
cosine over the run) at 64 px, batch 2, through ``learn_smoke.train_staged``
in two staged chunks of one step each (one scan compile on the JAX side).
Then each evaluates the held-out batch (``HELD_OUT_SEED``) in eval mode,
with the moving BN statistics: the quantity the learning smoke gates on.

Train-mode BN over two images amplifies float rounding, and Keras Adam's
first step moves every weight by about lr times the sign of its gradient,
so a gradient element near zero whose sign rounds the other way moves its
weight by 2 lr.  From step 2 on, the weights going in differ, and the two
packages part by what rounding alone produces: the port started from the
JAX weights nudged by a relative 1e-7 parts from the JAX trainer about as
far as the port started from the JAX weights themselves.  So step 1 is held
tightly, and what follows it to that spread, member by member (hrnet parts
10-100 times further than v3plus).  The eval-mode forward itself is held
tightly on the JAX trainer's trained variables, where no trajectory parts
the two.

Each gate in ``GATES`` stands beside the largest value measured over five
port runs: from the JAX weights and from ``NUDGES`` nudges of them (the
signs drawn from ``RandomState(1..4)``).  ``PYTHONPATH=. python
tests/test_torch_learn_bn.py [member ...]``, from the root of the
repository, prints those values.  The tests run only the first; it gave
the same bits alone and beside five busy pytest workers.  The file takes
about 3.5 minutes on one worker with a cold XLA cache, most of it the JAX
trainer's set-up and its compiles.
"""
import contextlib
import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_detection_tpu.core import module as JM
from building_detection_tpu.core.config import TrainConfig as JaxTrainConfig
from building_detection_tpu.ops import tiling as JT
from building_detection_tpu.parallel.mesh import make_mesh
from building_detection_tpu.train.trainer import Trainer as JaxTrainer
from building_detection_tpu_torch.core.module import jax_variables, load_jax_variables
from building_detection_tpu_torch.models.registry import build_model
from building_detection_tpu_torch.ops import tiling as PT
from building_detection_tpu_torch.train import learn_smoke
from building_detection_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

MEMBERS = ["hrnet", "v3plus", "bam"]
HW, LR, STEPS, CHUNK, BATCH = 64, 5e-4, 2, 1, 2
NUDGES = 4

# Step 1, the same weights going in: loss within rel 5e-5 (measured at most
# 1.4e-5), each metric within 1e-3 (measured at most 1.2e-4, one pixel).
STEP1_LOSS_RTOL, STEP1_METRIC_ATOL = 5e-5, 1e-3
# The port's eval-mode forward on the JAX trainer's trained variables, element
# by element (measured at most 7.2e-7).
SAME_VARIABLES_ATOL = 1e-5
# Per member, each gate with the largest value measured: step 2's loss (rel)
# and metrics; every moving mean and variance after the chunks, its
# difference over the tensor's change from its initial value in L2, per
# tensor and over all together; the held-out eval_on_batch loss (rel) and
# metrics; the held-out eval-mode softmax, element by element.
GATES = {
    "hrnet": {
        "loss": 3e-2,           # 1.08e-2
        "metrics": 2e-2,        # 8.0e-3
        "state_tensor": 0.25,   # 0.092
        "state_all": 0.05,      # 0.0132
        "eval_loss": 3e-2,      # 9.2e-3
        "eval_metrics": 2e-2,   # 5.5e-3
        "softmax": 6e-2,        # 2.41e-2
    },
    "v3plus": {
        "loss": 1e-3,           # 2.0e-4
        "metrics": 3e-3,        # 9.3e-4
        "state_tensor": 3e-2,   # 9.3e-3
        "state_all": 2e-3,      # 4.2e-4
        "eval_loss": 3e-4,      # 5.0e-5
        "eval_metrics": 3e-3,   # 6.1e-4
        "softmax": 1e-3,        # 1.3e-4
    },
    "bam": {
        "loss": 1e-2,           # 3.5e-3
        "metrics": 1e-2,        # 3.0e-3
        "state_tensor": 0.15,   # 0.056
        "state_all": 1e-2,      # 3.3e-3
        "eval_loss": 2e-3,      # 4.3e-4
        "eval_metrics": 2e-3,   # 0 (the same pixels)
        "softmax": 3e-3,        # 6.9e-4
    },
}


def numpy_tree(tree):
    """Copies: the JAX trainer donates its variables' buffers to its steps."""
    return {k: np.array(v) for k, v in jax.device_get(tree).items()}


@contextlib.contextmanager
def small_recipe():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(learn_smoke, "BATCH", BATCH)
        mp.setattr(learn_smoke, "CHUNK", CHUNK)
        yield learn_smoke.learn_config(HW, LR), learn_smoke.held_out(HW)


def trained(tr):
    """``tr`` through the staged chunks, then its held-out ``eval_on_batch``."""
    with small_recipe() as (_, (images, labels)):
        chunks = learn_smoke.train_staged(tr, STEPS, HW, log=lambda s: None)
        assert [len(m["loss"]) for m, _ in chunks] == [CHUNK] * (STEPS // CHUNK) and tr.step == STEPS
        steps = {k: np.concatenate([m[k] for m, _ in chunks]) for k in chunks[0][0]}
        return {"steps": steps, "eval": tr.eval_on_batch(images, labels)}


def port_softmax(model, images_u8):
    model.eval()
    with torch.no_grad():
        return model(PT.normalize(torch.from_numpy(images_u8))).numpy()


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """The JAX trainer's initial variables, its staged run, the BN state it
    reached and the held-out eval-mode softmax on its trained variables
    (its own and the port's forward)."""
    with small_recipe() as (cfg, (images, _)):
        jt = JaxTrainer(name, JaxTrainConfig(**dataclasses.asdict(cfg)), steps_per_epoch=STEPS,
                        mesh=make_mesh(data=1))
    out = {"init": (numpy_tree(jt.params), numpy_tree(jt.state)), **trained(jt)}
    forward = jax.jit(functools.partial(JM.apply, jt.model_fn, compute_dtype=jnp.float32))
    out["softmax"] = np.asarray(forward(jt.params, jt.state, JT.normalize(jnp.asarray(images)))[0])
    out["state"] = numpy_tree(jt.state)
    on_jax = build_model(name)
    load_jax_variables(on_jax, numpy_tree(jt.params), out["state"])
    out["port_on_jax_variables"] = port_softmax(on_jax, images)
    return out


@functools.lru_cache(maxsize=None)
def port_run(name, nudge=0):
    """The port's trainer through the same run from the JAX trainer's initial
    weights, each times ``1 +- 1e-7`` (signs from ``RandomState(nudge)``)
    when ``nudge`` is not 0."""
    params, state = jax_run(name)["init"]
    if nudge:
        rs = np.random.RandomState(nudge)
        params = {k: (v * (1 + 1e-7 * rs.choice([-1, 1], v.shape))).astype(v.dtype) for k, v in params.items()}
    with small_recipe() as (cfg, (images, _)):
        pt = Trainer(name, cfg, steps_per_epoch=STEPS, device="cpu")
    load_jax_variables(pt.model, params, state)
    out = trained(pt)
    out["state"] = jax_variables(pt.model)[1]
    out["softmax"] = port_softmax(pt.model, images)
    return out


def spread(name, nudge=0):
    """What each gate holds: the port's run (from nudged weights when
    ``nudge``) against the JAX trainer's."""
    j, p = jax_run(name), port_run(name, nudge)
    (mj, mp), (ej, ep), (sj, sp) = ((j[k], p[k]) for k in ("steps", "eval", "state"))
    s0 = j["init"][1]
    keys = sorted(sj)
    flat = lambda d: np.concatenate([d[k].ravel() for k in keys])  # noqa: E731
    return {
        "loss": np.abs(mp["loss"] - mj["loss"]) / np.abs(mj["loss"]),
        "metrics": np.max([np.abs(mp[k] - mj[k]) for k in mj if k != "loss"], axis=0),
        "state_tensor": {k: float(np.linalg.norm(sp[k] - sj[k]) / np.linalg.norm(sj[k] - s0[k])) for k in keys},
        "state_all": float(np.linalg.norm(flat(sp) - flat(sj)) / np.linalg.norm(flat(sj) - flat(s0))),
        "eval_loss": abs(ep["loss"] - ej["loss"]) / abs(ej["loss"]),
        "eval_metrics": max(abs(ep[k] - ej[k]) for k in ej if k != "loss"),
        "softmax": float(np.abs(p["softmax"] - j["softmax"]).max()),
    }


@pytest.mark.parametrize("name", MEMBERS)
def test_staged_steps_match_the_jax_trainer(name):
    mj, mp = jax_run(name)["steps"], port_run(name)["steps"]
    assert sorted(mp) == sorted(mj) and len(mj["loss"]) == STEPS
    s, gate = spread(name), GATES[name]
    assert s["loss"][0] <= STEP1_LOSS_RTOL and s["metrics"][0] <= STEP1_METRIC_ATOL, (s["loss"], s["metrics"])
    assert s["loss"][1] <= gate["loss"] and s["metrics"][1] <= gate["metrics"], (s["loss"], s["metrics"])
    assert mj["loss"][-1] < mj["loss"][0]  # the steps did train


@pytest.mark.parametrize("name", MEMBERS)
def test_moving_statistics_match_the_jax_trainer(name):
    sj, s0 = jax_run(name)["state"], jax_run(name)["init"][1]
    assert sorted(port_run(name)["state"]) == sorted(sj) and sj
    assert {k.rsplit("/", 1)[1] for k in sj} == {"moving_mean", "moving_variance"}
    s, gate = spread(name), GATES[name]
    for k in sj:
        assert np.abs(sj[k] - s0[k]).max() > 0, k  # every statistic moved
        assert s["state_tensor"][k] <= gate["state_tensor"], (k, s["state_tensor"][k])
    assert s["state_all"] <= gate["state_all"], s["state_all"]


@pytest.mark.parametrize("name", MEMBERS)
def test_held_out_eval_matches_the_jax_trainer(name):
    ej, ep = jax_run(name)["eval"], port_run(name)["eval"]
    assert sorted(ep) == sorted(ej)
    s, gate = spread(name), GATES[name]
    assert s["eval_loss"] <= gate["eval_loss"] and s["eval_metrics"] <= gate["eval_metrics"], (ep, ej)


@pytest.mark.parametrize("name", MEMBERS)
def test_held_out_softmax_matches_the_jax_trainer(name):
    pj, pp = jax_run(name)["softmax"], port_run(name)["softmax"]
    assert pj.shape == pp.shape == (BATCH, HW, HW, 2)
    assert spread(name)["softmax"] <= GATES[name]["softmax"]


@pytest.mark.parametrize("name", MEMBERS)
def test_eval_mode_on_the_jax_trained_variables(name):
    """The eval-mode forward (the moving statistics, the SKNet and BAM gates
    and their 2-D BN) on the very variables the JAX trainer reached."""
    j = jax_run(name)
    assert float(np.abs(j["port_on_jax_variables"] - j["softmax"]).max()) <= SAME_VARIABLES_ATOL


def print_spread(names) -> None:
    """Each gate's largest value over the port's run from the JAX weights
    and from ``NUDGES`` nudges of them, as JSON lines."""
    for name in names:
        runs = [spread(name, nudge) for nudge in range(NUDGES + 1)]
        worst = {
            "step1_loss": max(float(s["loss"][0]) for s in runs),
            "step1_metrics": max(float(s["metrics"][0]) for s in runs),
            "loss": max(float(s["loss"][1]) for s in runs),
            "metrics": max(float(s["metrics"][1]) for s in runs),
            "state_tensor": max(max(s["state_tensor"].values()) for s in runs),
            **{k: max(float(s[k]) for s in runs) for k in ("state_all", "eval_loss", "eval_metrics", "softmax")},
        }
        j = jax_run(name)
        worst["same_variables"] = float(np.abs(j["port_on_jax_variables"] - j["softmax"]).max())
        print(json.dumps({"member": name, **worst}), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print_spread(sys.argv[1:] or MEMBERS)
