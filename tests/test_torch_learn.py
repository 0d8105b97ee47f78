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
from building_detection_tpu.parallel.mesh import make_mesh
from building_detection_tpu.train.trainer import Trainer as JaxTrainer
from building_detection_tpu_torch.core.module import load_jax_variables
from building_detection_tpu_torch.train import learn_smoke
from building_detection_tpu_torch.train.trainer import Trainer
from building_detection_tpu_torch.utils.profiling import device_trace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))

import learn_smoke as jax_learn_smoke  # noqa: E402

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
METRIC_ATOL = 1e-3
SMALL = (3, 64, 5e-4)  # steps, px, lr: a CPU-sized recipe


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
