"""PyTorch port, the learning smoke (``train/learn_smoke.py``) and
``utils/profiling.py::device_trace``, held against the JAX package on the CPU.

* ``RECIPES`` equals the JAX script's (``scripts/learn_smoke.py``), and
  ``make_dataset`` gives the same bytes from the same ``RandomState``.
* The recipe's trainer config, for scse at 64 px in f32, 4 steps in staged
  chunks of 3 (so a remainder chunk of 1 runs and the schedule is read at
  steps 0-3 across two chunks): the port's ``Trainer`` against the JAX
  ``Trainer`` from the same weights (``load_jax_variables``).  scse has no
  BN, so the two agree closely: per step the loss within rel 1e-4 and each
  metric within 1e-3, and the held-out ``eval_on_batch`` the same
  (measured: loss rel at most 8.1e-7 in training and 4.5e-7 held out,
  the metrics equal; the JAX side's two scan compiles take most of the
  file's ~2 min).
* ``run_one`` returns its metrics and prints the ``PASS``/``FAIL`` line, and
  ``main`` exits 0 with ``LEARNING OK`` when every member passes and 1
  otherwise, as the JAX script does.
* ``run_one``'s ``seed``, ``dtype`` and ``init`` (``--seed``, ``--dtype``):
  the weights before the first step are the default ``Trainer``'s, another
  seed's, or exactly the given JAX package's (``init``, or ``--init`` with
  the JAX package's ``.npz``); ``f32`` makes every layer compute in f32;
  ``main`` refuses an unknown dtype and ``--init`` with several members.  ``eval_batch_stats``
  gives the metrics of the train-mode forward (the training step's, before
  its update) and moves no moving statistic and not the step count.
* ``block_ceiling_iou`` is the best IoU of any mask constant on tiles
  (against all 256 such masks of a small case); bam's output is constant
  on 4x4 tiles, and its held-out IoUs stay under that ceiling.
* ``device_trace`` writes a trace of a CPU op and is a no-op for ``None``
  and ``""``.
"""
import dataclasses
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from building_detection_tpu.core.config import TrainConfig as JaxTrainConfig
from building_detection_tpu.models.registry import init_model
from building_detection_tpu.parallel.mesh import make_mesh
from building_detection_tpu.train import checkpoint as jax_checkpoint
from building_detection_tpu.train.trainer import Trainer as JaxTrainer
from building_detection_tpu_torch.core.module import init_layers, jax_variables, load_jax_variables
from building_detection_tpu_torch.models.registry import build_model
from building_detection_tpu_torch.nn.layers import KerasLayer
from building_detection_tpu_torch.train import learn_smoke
from building_detection_tpu_torch.train.trainer import Trainer
from building_detection_tpu_torch.utils.profiling import device_trace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))

import learn_smoke as jax_learn_smoke  # noqa: E402

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
METRIC_ATOL = 1e-3
SMALL = (3, 64, 5e-4)  # steps, px, lr: a CPU-sized recipe
ONE_STEP = (1, 64, 5e-4)


def test_recipes_equal_the_jax_script():
    assert learn_smoke.RECIPES == jax_learn_smoke.RECIPES


@pytest.mark.parametrize("seed,n,hw", [(0, 8, 64), (999, 8, 64), (3, 5, 128), (7, 2, 97)])
def test_make_dataset_gives_the_jax_bytes(seed, n, hw):
    got = learn_smoke.make_dataset(np.random.RandomState(seed), n, hw)
    want = jax_learn_smoke.make_dataset(np.random.RandomState(seed), n, hw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[1].any() and set(np.unique(got[1])) == {0, 255}


def test_learn_config_is_the_jax_scripts():
    steps, hw, lr = learn_smoke.RECIPES["res34"]
    want = JaxTrainConfig(batch_size=8, epochs=1, warmup_epochs=0, image_size=hw, lr_base=lr)
    assert dataclasses.asdict(learn_smoke.learn_config(hw, lr)) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def scse_runs():
    """scse by the recipe's config at 64 px, f32, 4 steps in chunks of 3, in
    both packages from the JAX trainer's initial weights."""
    steps, hw, lr = 4, 64, 5e-4
    cfg = learn_smoke.learn_config(hw, lr)
    jt = JaxTrainer("scse", JaxTrainConfig(**dataclasses.asdict(cfg)), steps_per_epoch=steps, mesh=make_mesh(data=1))
    pt = Trainer("scse", cfg, steps_per_epoch=steps, device="cpu")
    load_jax_variables(pt.model, *({k: np.asarray(v) for k, v in jax.device_get(t).items()}
                                   for t in (jt.params, jt.state)))
    runs = {}
    for label, tr in (("jax", jt), ("port", pt)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(learn_smoke, "CHUNK", 3)
            chunks = learn_smoke.train_staged(tr, steps, hw, log=lambda s: None)
        assert [len(m["loss"]) for m, _ in chunks] == [3, 1] and tr.step == steps
        per_step = {k: np.concatenate([m[k] for m, _ in chunks]) for k in chunks[0][0]}
        runs[label] = per_step, tr.eval_on_batch(*learn_smoke.held_out(hw))
    return runs


def test_staged_chunks_match_the_jax_trainer(scse_runs):
    (mj, _), (mp, _) = scse_runs["jax"], scse_runs["port"]
    assert sorted(mp) == sorted(mj)
    np.testing.assert_allclose(mp["loss"], mj["loss"], rtol=LOSS_RTOL, atol=0)
    for k in mj:
        if k != "loss":
            np.testing.assert_allclose(mp[k], mj[k], rtol=0, atol=METRIC_ATOL, err_msg=k)
    assert mj["loss"][-1] < mj["loss"][0]  # the steps did train


def test_held_out_eval_matches_the_jax_trainer(scse_runs):
    (_, ej), (_, ep) = scse_runs["jax"], scse_runs["port"]
    assert sorted(ep) == sorted(ej)
    assert abs(ep["loss"] - ej["loss"]) <= LOSS_RTOL * abs(ej["loss"])
    for k in ej:
        if k != "loss":
            assert abs(ep[k] - ej[k]) <= METRIC_ATOL, (k, ep[k], ej[k])


LINE = re.compile(r"^scse: (PASS|FAIL) held-out IoU=[\d.]+ PA=[\d.]+ F1=[\d.]+ \(3 steps, \d+s, [\d.]+ ms/step\)$",
                  re.M)


def test_run_one_returns_metrics_and_prints_the_verdict(capsys):
    out = learn_smoke.run_one("scse", device="cpu", recipe=SMALL)
    assert {"IoU", "PA", "F1_score", "MIoU", "loss", "train_loss", "seconds", "steps", "step_ms", "passed"} <= set(out)
    assert {"batch_stats_IoU", "batch_stats_loss", "train_IoU", "ceiling_IoU", "seed", "dtype"} <= set(out)
    assert out["seed"] == 0 and out["dtype"] == "bf16" and out["ceiling_IoU"] == 1.0
    assert out["steps"] == 3 and out["seconds"] > 0 and out["step_ms"] > 0
    assert out["passed"] == (out["IoU"] > 0.5)
    assert all(np.isfinite(out[k]) for k in ("IoU", "PA", "F1_score", "loss", "train_loss"))
    text = capsys.readouterr().out
    assert LINE.search(text), text
    assert "  scse step   3 loss=" in text


@pytest.mark.parametrize("gate,code", [(-1.0, 0), (2.0, 1)], ids=["all_pass", "one_fails"])
def test_main_exits_as_the_jax_script(monkeypatch, capsys, gate, code):
    monkeypatch.setattr(learn_smoke, "RECIPES", {"scse": SMALL})
    monkeypatch.setattr(learn_smoke, "IOU_GATE", gate)
    assert learn_smoke.main(["--device", "cpu"]) == code
    text = capsys.readouterr().out
    assert ("scse=PASS" if code == 0 else "scse=FAIL") in text
    assert ("LEARNING OK" in text) == (code == 0)


def test_main_refuses_an_unknown_member(capsys):
    with pytest.raises(SystemExit) as e:
        learn_smoke.main(["--device", "cpu", "nosuch"])
    assert e.value.code == 2 and "nosuch" in capsys.readouterr().err


@pytest.fixture
def first_steps(monkeypatch):
    """Each ``train_staged`` call's trainer as it enters: its variables (JAX
    layout), its layers' compute dtypes and its step count."""
    seen = []
    real = learn_smoke.train_staged

    def spy(tr, *args, **kwargs):
        dtypes = {m.compute_dtype for m in tr.model.modules() if isinstance(m, KerasLayer)}
        variables = tuple({k: v.copy() for k, v in tree.items()} for tree in jax_variables(tr.model))
        seen.append((variables, dtypes, tr.step))
        return real(tr, *args, **kwargs)

    monkeypatch.setattr(learn_smoke, "train_staged", spy)
    return seen


def assert_variables_equal(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_run_one_seeds_draw_the_trainers_weights(first_steps):
    steps, hw, lr = ONE_STEP
    default = Trainer("scse", learn_smoke.learn_config(hw, lr), steps_per_epoch=steps, device="cpu")
    default = jax_variables(default.model)
    outs = [learn_smoke.run_one("scse", device="cpu", recipe=ONE_STEP, log=lambda s: None, **kw)
            for kw in ({}, {"seed": 1})]
    (v0, _, step0), (v1, _, _) = first_steps
    assert step0 == 0 and [o["seed"] for o in outs] == [0, 1]
    assert_variables_equal(v0, default)
    assert any(not np.array_equal(v0[0][k], v1[0][k]) for k in v0[0])


def test_run_one_starts_from_the_given_jax_weights(first_steps):
    steps, hw, lr = ONE_STEP
    params, state = init_model("scse", jax.random.key(7), (1, hw, hw, 3))
    init = tuple({k: np.asarray(v) for k, v in jax.device_get(t).items()} for t in (params, state))
    learn_smoke.run_one("scse", device="cpu", recipe=ONE_STEP, log=lambda s: None, init=init)
    (got, _, step), = first_steps
    assert step == 0
    assert_variables_equal(got, init)


def test_main_init_starts_from_a_checkpoint(monkeypatch, capsys, first_steps, tmp_path):
    steps, hw, lr = ONE_STEP
    params, state = init_model("scse", jax.random.key(11), (1, hw, hw, 3))
    init = tuple({k: np.asarray(v) for k, v in jax.device_get(t).items()} for t in (params, state))
    path = str(tmp_path / "scse_init.npz")
    jax_checkpoint.save_variables(path, *init)
    monkeypatch.setattr(learn_smoke, "RECIPES", {"scse": ONE_STEP})
    monkeypatch.setattr(learn_smoke, "IOU_GATE", -1.0)
    assert learn_smoke.main(["--device", "cpu", "--init", path, "scse"]) == 0
    (got, _, _), = first_steps
    assert_variables_equal(got, init)
    assert "scse: the given weights, bf16: held-out IoU " in capsys.readouterr().out


def test_main_init_takes_one_member(capsys, tmp_path):
    with pytest.raises(SystemExit) as e:
        learn_smoke.main(["--device", "cpu", "--init", str(tmp_path / "x.npz"), "scse", "res34"])
    assert e.value.code == 2 and "--init takes one member" in capsys.readouterr().err


@pytest.mark.parametrize("flag,dtype", [([], torch.bfloat16), (["--dtype", "f32"], torch.float32)],
                         ids=["default_bf16", "f32"])
def test_main_dtype_sets_the_compute_dtype(monkeypatch, capsys, first_steps, flag, dtype):
    monkeypatch.setattr(learn_smoke, "RECIPES", {"scse": ONE_STEP})
    monkeypatch.setattr(learn_smoke, "IOU_GATE", -1.0)
    assert learn_smoke.main(["--device", "cpu", "--seed", "3"] + flag) == 0
    (_, dtypes, _), = first_steps
    assert dtypes == {dtype}
    name = next(k for k, v in learn_smoke.DTYPES.items() if v == dtype)
    assert f"scse: seed 3, {name}: held-out IoU " in capsys.readouterr().out


def test_main_refuses_an_unknown_dtype(capsys):
    with pytest.raises(SystemExit) as e:
        learn_smoke.main(["--device", "cpu", "--dtype", "f16", "scse"])
    assert e.value.code == 2 and "f16" in capsys.readouterr().err


def test_batch_stats_readout_moves_no_state():
    """res34 (BN throughout), f32, after one step so the moving statistics
    are no longer their initial values: the readout equals the metrics of
    the next training step's forward on the same batch (train mode, taken
    before that step's update) and leaves the state and step alone."""
    steps, hw, lr = 2, 64, 5e-4
    tr = Trainer("res34", learn_smoke.learn_config(hw, lr), steps_per_epoch=steps, device="cpu")
    imgs, labs = learn_smoke.make_dataset(np.random.RandomState(5), 2 * learn_smoke.BATCH, hw)
    tr.train_on_batch(imgs[: learn_smoke.BATCH], labs[: learn_smoke.BATCH])
    before, step = jax_variables(tr.model), tr.step
    got = learn_smoke.eval_batch_stats(tr, imgs[learn_smoke.BATCH :], labs[learn_smoke.BATCH :])
    assert_variables_equal(jax_variables(tr.model), before)
    assert tr.step == step == 1
    eval_mode = tr.eval_on_batch(imgs[learn_smoke.BATCH :], labs[learn_smoke.BATCH :])
    assert got["loss"] != eval_mode["loss"]
    want = tr.train_on_batch(imgs[learn_smoke.BATCH :], labs[learn_smoke.BATCH :])
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), (k, got[k], want[k])


def test_block_ceiling_iou_is_the_best_tiled_mask():
    """Against every mask constant on 4x4 tiles of two 8x8 labels (2**8)."""
    labels = np.where(np.random.RandomState(3).rand(2, 8, 8) < 0.45, 255, 0).astype(np.uint8)
    g = labels == 255
    best = 0.0
    for bits in range(1, 2 ** 8):
        tiles = np.array([(bits >> i) & 1 for i in range(8)], bool).reshape(2, 2, 2)
        mask = tiles.repeat(4, axis=1).repeat(4, axis=2)
        tp = np.sum(mask & g)
        best = max(best, tp / (mask.sum() + g.sum() - tp))
    assert learn_smoke.block_ceiling_iou(labels, 4) == pytest.approx(best, rel=1e-12)
    assert learn_smoke.block_ceiling_iou(labels, 1) == 1.0


def test_bam_output_is_constant_on_its_block_and_under_the_ceiling(capsys):
    (block,) = set(learn_smoke.OUTPUT_BLOCK.values())
    model = init_layers(build_model("bam"), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        probs = model(x).numpy()
    tiles = probs.reshape(1, 64 // block, block, 64 // block, block, 2)
    np.testing.assert_array_equal(tiles, np.broadcast_to(tiles[:, :, :1, :, :1], tiles.shape))
    out = learn_smoke.run_one("bam", device="cpu", recipe=ONE_STEP, dtype=torch.float32)
    assert out["ceiling_IoU"] == learn_smoke.block_ceiling_iou(learn_smoke.held_out(64)[1], block) < 0.95
    assert out["IoU"] <= out["ceiling_IoU"] and out["batch_stats_IoU"] <= out["ceiling_IoU"]
    assert f"bam: its output is constant on {block}x{block} tiles; the best such mask scores held-out IoU " in \
        capsys.readouterr().out


def test_device_trace_writes_a_trace(tmp_path):
    a = torch.ones(64, 64)
    with device_trace(str(tmp_path)) as prof:
        a @ a
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
    assert (tmp_path / files[0]).stat().st_size > 0
    assert any(e.key == "aten::mm" for e in prof.key_averages())


@pytest.mark.parametrize("log_dir", [None, ""])
def test_device_trace_is_a_no_op_without_a_dir(tmp_path, monkeypatch, log_dir):
    monkeypatch.chdir(tmp_path)
    with device_trace(log_dir) as prof:
        torch.ones(4) + 1
    assert prof is None and os.listdir(tmp_path) == []
