"""PyTorch port, the ``Trainer`` and its entry points on the CPU.

* a tiny conv-BN-conv model trained by the port and by the JAX ``Trainer``
  from the same weights: the loss and metric trajectory, the eval metrics,
  the learning rate and the final params agree;
* inside the port, the staged epoch equals the per-step path bit for bit
  (with a visit order, and with on-device augmentation), ``fit_arrays``
  staged equals streamed, and ``fit_arrays`` plus ``restore`` resumes the
  fit history;
* weights-only loading (``.npz`` and Keras ``.h5``), ``remat=True``, the
  refusals (a mesh that is not a ``parallel.mesh.Mesh``, ``tp``, a missing
  card, the train CLI's incomplete multi-process flags and a data axis
  wider than the run), the prefetcher, the epoch visualiser and the two
  CLIs on a tiny on-disk dataset.

The JAX comparison runs at 16 px over a few steps, where f32 noise stays
far below the 1e-5 relative tolerance.
"""
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from building_detection_tpu.core.config import TrainConfig
from building_detection_tpu.parallel.mesh import make_mesh
from building_detection_tpu.train.trainer import Trainer as JaxTrainer
from building_detection_tpu_torch.cli import evaluate as eval_cli
from building_detection_tpu_torch.cli import train as train_cli
from building_detection_tpu_torch.core.module import jax_variables, load_jax_variables
from building_detection_tpu_torch.data.prefetch import device_prefetch
from building_detection_tpu_torch.train.callbacks import EarlyStopping, EpochVisualizer
from building_detection_tpu_torch.train.trainer import Trainer, make_targets
from test_torch_train import TorchTiny, jax_tiny, tiny_data

torch.set_num_threads(2)

CFG = TrainConfig(batch_size=4, image_size=16, epochs=2, warmup_epochs=1)


def trainer(**kw):
    kw.setdefault("device", "cpu")
    return Trainer(TorchTiny, kw.pop("cfg", CFG), steps_per_epoch=kw.pop("steps_per_epoch", 3), **kw)


def quiet(_):
    pass


def assert_same_model(a, b):
    for da, db in zip(jax_variables(a.model), jax_variables(b.model)):
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_tiny_trajectory_matches_jax_trainer():
    imgs, labs = tiny_data(3, n=12)
    jt = JaxTrainer(jax_tiny, CFG, steps_per_epoch=3, mesh=make_mesh(data=1))
    pt = trainer()
    params = {k: np.asarray(v) for k, v in jax.device_get(jt.params).items()}
    state = {k: np.asarray(v) for k, v in jax.device_get(jt.state).items()}
    load_jax_variables(pt.model, params, state)
    for i in range(5):
        b = slice(4 * (i % 3), 4 * (i % 3) + 4)
        assert pt.current_lr() == pytest.approx(jt.current_lr(), rel=1e-6)
        mj, mp = jt.train_on_batch(imgs[b], labs[b]), pt.train_on_batch(imgs[b], labs[b])
        assert sorted(mp) == sorted(mj)
        for k in mj:
            assert mp[k] == pytest.approx(mj[k], rel=1e-5, abs=1e-7), (i, k)
    ej, ep = jt.eval_on_batch(imgs[:4], labs[:4]), pt.eval_on_batch(imgs[:4], labs[:4])
    for k in ej:
        assert ep[k] == pytest.approx(ej[k], rel=1e-5, abs=1e-7), k
    got_p, got_s = jax_variables(pt.model)
    for k, v in jax.device_get(jt.params).items():
        np.testing.assert_allclose(got_p[k], np.asarray(v), atol=1e-5, err_msg=k)
    for k, v in jax.device_get(jt.state).items():
        np.testing.assert_allclose(got_s[k], np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("order", [None, [2, 0, 1]], ids=["sequential", "shuffled"])
def test_staged_epoch_equals_per_step(order):
    imgs, labs = tiny_data(4, n=12)
    loop = trainer()
    visit = order or [0, 1, 2]
    losses = [loop.train_on_batch(imgs[4 * i:4 * i + 4], labs[4 * i:4 * i + 4])["loss"] for i in visit]
    staged = trainer()
    metrics = staged.train_epoch_staged(*staged.stage_dataset(imgs, labs), order=order)
    assert metrics["loss"].shape == (3,)
    np.testing.assert_array_equal(metrics["loss"].astype(np.float64), np.asarray(losses))
    assert staged.step == loop.step == 3
    assert_same_model(loop, staged)


def test_staged_equals_per_step_with_augmentation():
    """Augmentation decisions key on the global step, so both paths see the
    same batches; and augmentation does change the batch."""
    imgs, labs = tiny_data(5, n=8)
    loop = trainer(augment=True, augment_seed=5)
    losses = [loop.train_on_batch(imgs[i * 4:(i + 1) * 4], labs[i * 4:(i + 1) * 4])["loss"] for i in range(2)]
    staged = trainer(augment=True, augment_seed=5)
    metrics = staged.train_epoch_staged(*staged.stage_dataset(imgs, labs))
    np.testing.assert_array_equal(metrics["loss"].astype(np.float64), np.asarray(losses))
    assert_same_model(loop, staged)
    assert trainer().train_on_batch(imgs[:4], labs[:4])["loss"] != losses[0]


def test_staged_input_checks():
    imgs, labs = tiny_data(6, n=9)
    tr = trainer()
    imgs5, labs4 = tr.stage_dataset(imgs, labs)
    assert tuple(imgs5.shape[:2]) == (2, 4) and tuple(labs4.shape[:2]) == (2, 4)  # tail dropped
    with pytest.raises(ValueError, match="train_epoch_staged"):
        tr.train_on_batch(imgs5, labs4)
    with pytest.raises(ValueError, match="permutation"):
        tr.train_epoch_staged(imgs5, labs4, order=[0, 0])
    m = tr.train_on_batch(imgs5[:1], labs4[:1], fetch_metrics=False)
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in m.values())


def test_fit_arrays_staged_equals_streamed(tmp_path):
    imgs, labs = tiny_data(7, n=8)
    vimgs, vlabs = tiny_data(8, n=4)
    hist = {}
    for mode in ("staged", "stream"):
        tr = trainer()
        hist[mode] = tr.fit_arrays(imgs, labs, vimgs, vlabs, checkpoint_dir=str(tmp_path / mode),
                                   log_fn=quiet, stage=mode)
        with open(tmp_path / mode / "history.json") as f:
            assert json.load(f) == json.loads(json.dumps(hist[mode]))
        assert sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / mode / "*.npz"))) == [
            "epoch_1_weights.npz", "epoch_2_weights.npz"]
    for a, b in zip(hist["staged"], hist["stream"]):
        for k in a:
            if k != "epoch_seconds":
                assert a[k] == b[k], k
    assert "val_PA" in hist["stream"][0] and "lr" in hist["stream"][0]


def test_fit_arrays_shuffle_is_seeded():
    imgs, labs = tiny_data(9, n=16)

    def run(seed):
        return [h["loss"] for h in trainer().fit_arrays(imgs, labs, shuffle=True, shuffle_seed=seed, log_fn=quiet)]

    assert run(0) == run(0) != run(1)


def test_restore_resumes_history(tmp_path):
    imgs, labs = tiny_data(10, n=8)
    ckdir = str(tmp_path / "w")
    hist = trainer().fit_arrays(imgs, labs, checkpoint_dir=ckdir, log_fn=quiet)
    tr2 = trainer()
    tr2.restore(os.path.join(ckdir, "epoch_2_weights.npz"))
    assert tr2.step == 4 and [h["loss"] for h in tr2.history] == [h["loss"] for h in hist]
    tr2.fit_arrays(imgs, labs, checkpoint_dir=ckdir, log_fn=quiet)
    with open(os.path.join(ckdir, "history.json")) as f:
        persisted = json.load(f)
    assert len(persisted) == 4 and [h["loss"] for h in persisted[:2]] == [h["loss"] for h in hist]
    tr3 = trainer()
    tr3.restore(os.path.join(ckdir, "epoch_1_weights.npz"))
    assert len(tr3.history) == 1


def test_should_stage_budget(monkeypatch):
    imgs, labs = tiny_data()
    tr = trainer()
    assert tr.should_stage(imgs, labs)  # the CPU reports no budget
    need = imgs.nbytes + labs.nbytes
    monkeypatch.setattr(tr, "_device_bytes_free", lambda: int(need / 0.6) + 1)
    assert tr.should_stage(imgs, labs) and not tr.should_stage(imgs, labs, extra_arrays=(imgs, None))
    monkeypatch.setattr(tr, "_device_bytes_free", lambda: 1)
    assert not tr.should_stage(imgs, labs)


def test_load_weights_keeps_optimizer_fresh(tmp_path):
    imgs, labs = tiny_data(11)
    src = trainer()
    for _ in range(2):
        src.train_on_batch(imgs, labs)
    path = str(tmp_path / "w.npz")
    src.save(path)
    dst = trainer(seed=3)
    dst.load_weights(path)
    assert_same_model(src, dst)
    assert dst.step == 0 and dst.optimizer.count == 0
    assert all(float(v.abs().max()) == 0.0 for v in dst.optimizer.mu.values())
    # a Keras .h5 of the same weights, imported strictly
    from building_detection_tpu_torch.train.checkpoint import export_h5_weights

    export_h5_weights(str(tmp_path / "w.h5"), *jax_variables(src.model))
    from_h5 = trainer(seed=4)
    from_h5.load_weights(str(tmp_path / "w.h5"))
    assert_same_model(src, from_h5)
    assert from_h5.step == 0 and from_h5.optimizer.count == 0
    with pytest.raises(ValueError, match="strict .h5 import failed"):
        Trainer("scse", CFG, device="cpu").load_weights(str(tmp_path / "w.h5"))


def test_bf16_compute_keeps_f32_masters():
    imgs, labs = tiny_data(12)
    tr = trainer(compute_dtype=torch.bfloat16)
    m = tr.train_on_batch(imgs, labs)
    assert np.isfinite(m["loss"])
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert all(v.dtype == torch.float32 for v in tr.optimizer.mu.values())


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"tp": True}, {"remat": True}], ids=["mesh", "tp", "remat"])
def test_unported_options_raise(kw):
    """A mesh that is not a ``parallel.mesh.Mesh`` is refused with a
    ``TypeError`` naming it (data-parallel training is ported:
    ``test_torch_parallel.py``, ``test_torch_distributed.py``); ``tp=True``
    without a model axis is the plain trainer, as in the JAX package
    (``test_torch_distributed.py`` holds TP over processes); ``remat=True``
    is ported and a step with it equals a plain step
    (``test_torch_remat.py`` holds the five members)."""
    if "mesh" in kw:
        with pytest.raises(TypeError, match=r"parallel\.mesh\.Mesh"):
            trainer(**kw)
        return
    imgs, labs = tiny_data(13)
    tr, plain = trainer(**kw), trainer()
    if "tp" in kw:
        assert tr.tp is False and all(m.tp is None for m in tr.model.modules() if hasattr(m, "tp"))
    else:
        assert tr.model.remat is True and plain.model.remat is False
    assert tr.train_on_batch(imgs, labs) == plain.train_on_batch(imgs, labs)
    assert_same_model(tr, plain)


def test_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        trainer(device="cuda")


def test_make_targets_takes_strided_labels():
    """A transposed label batch is handed to the edge kernel contiguous."""
    _, labs = tiny_data(13)
    strided = torch.from_numpy(labs).transpose(1, 2)
    assert not strided.is_contiguous()
    np.testing.assert_array_equal(make_targets(strided).numpy(), make_targets(strided.contiguous()).numpy())


def test_device_prefetch_on_cpu():
    batches = [tiny_data(s) for s in range(3)]
    got = list(device_prefetch(iter(batches), "cpu"))
    assert len(got) == 3
    for (gi, gl), (wi, wl) in zip(got, batches):
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gl.numpy(), wl)

    def broken():
        yield batches[0]
        raise OSError("bad file")

    it = device_prefetch(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="bad file"):
        next(it)


# The streamed fit's pipes (bdt-train's prefetch feeding the trainer's
# device_prefetch) stopped early over an endless stream, the process ending
# at once while the upstream worker runs GIL-releasing torch ops.
EXIT_WITH_PIPES_RUNNING = """
import numpy as np, torch
from building_detection_tpu_torch.data.dataset import prefetch
from building_detection_tpu_torch.data.prefetch import device_prefetch

torch.set_num_threads(1)
a = torch.randn(300, 300)

def endless():
    while True:
        for _ in range(20):
            torch.mm(a, a)
        yield np.zeros((2, 4, 4, 3), np.uint8), np.zeros((2, 4, 4), np.uint8)

def fit():
    batches = device_prefetch(prefetch(endless()), "cpu")
    for _ in range(3):
        next(batches)

fit()
"""


def test_a_stopped_pipe_joins_its_workers_before_exit():
    """A worker thread left running at interpreter exit inside a torch op
    that released the interpreter lock aborts the process ("terminate called
    without an active exception", SIGABRT): a rank of the streamed
    ``bdt-train`` did so after its last epoch.  Closing a pipe joins its
    worker, so the process exits 0."""
    import subprocess
    import sys

    from building_detection_tpu_torch.parallel import dryrun

    for _ in range(3):
        run = subprocess.run([sys.executable, "-c", EXIT_WITH_PIPES_RUNNING], capture_output=True, text=True,
                             env=dryrun.port_env({"OMP_NUM_THREADS": "1"}), timeout=120)
        assert run.returncode == 0 and "terminate called" not in run.stderr, (run.returncode, run.stderr[-2000:])


def test_callbacks(tmp_path):
    pytest.importorskip("PIL")
    imgs, labs = tiny_data(14, n=8)
    vis = EpochVisualizer(imgs[0], labs[0], str(tmp_path / "vis"))
    stop = EarlyStopping(monitor="loss", patience=1, mode="min")
    stop.best = -1.0  # no epoch can improve on it
    hist = trainer().fit_arrays(imgs, labs, log_fn=quiet, callbacks=[vis, stop])
    assert len(hist) == 1 and stop.stopped_epoch == 1
    assert os.path.exists(tmp_path / "vis" / "epoch_1_display.png")


# -- the CLIs on a tiny on-disk dataset ------------------------------------------
@pytest.fixture
def dataset(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(0)
    for split, n in (("train", 8), ("val", 4)):
        for sub in ("img", "lab"):
            os.makedirs(tmp_path / split / sub)
        for i in range(n):
            lab = np.zeros((16, 16), np.uint8)
            lab[rng.randint(0, 8):rng.randint(9, 16), rng.randint(0, 8):rng.randint(9, 16)] = 255
            img = rng.randint(0, 90, (16, 16, 3)).astype(np.uint8)
            img[lab > 0] += 120
            Image.fromarray(img).save(tmp_path / split / "img" / f"{i}.png")
            Image.fromarray(lab).save(tmp_path / split / "lab" / f"{i}.png")
    return tmp_path


def train_args(root, *extra):
    return ["scse", "--train-images", str(root / "train" / "img"), "--train-labels", str(root / "train" / "lab"),
            "--val-images", str(root / "val" / "img"), "--val-labels", str(root / "val" / "lab"),
            "--checkpoint-dir", str(root / "ck"), "--batch-size", "4", "--epochs", "1", "--warmup-epochs", "0",
            "--image-size", "16", "--precision", "f32", "--device", "cpu", *extra]


@pytest.mark.parametrize("budget", [None, "0"], ids=["staged", "streamed"])
def test_train_cli_resume_and_evaluate(dataset, monkeypatch, capsys, budget):
    if budget is not None:
        monkeypatch.setenv("BDT_HOST_DECODE_BUDGET", budget)
    assert train_cli.main(train_args(dataset, "--shuffle")) == 0
    assert os.path.exists(dataset / "ck" / "epoch_1_weights.npz")
    assert train_cli.main(train_args(dataset, "--auto-resume", "--epochs", "2")) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 2" in out
    with open(dataset / "ck" / "history.json") as f:
        assert len(json.load(f)) == 3  # epoch 1, then the resumed run's 2
    assert eval_cli.main(["scse", "--checkpoint", str(dataset / "ck" / "epoch_2_weights.npz"),
                          "--images", str(dataset / "val" / "img"), "--labels", str(dataset / "val" / "lab"),
                          "--batch-size", "4", "--image-size", "16", "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["samples"] == 4 and 0.0 <= result["PA"] <= 1.0 and np.isfinite(result["loss"])


@pytest.mark.parametrize("extra", [["--num-processes", "2"], ["--data-parallel", "2"]], ids=["multiprocess", "dp"])
def test_train_cli_refuses_multi_device(dataset, extra, capsys):
    """``--num-processes`` without ``--coordinator``/``--process-id`` exits
    with a usage error naming them; ``--data-parallel 2`` in a process with
    no process group raises, naming the launch flags.  Neither starts a
    process group (the two-process runs are in ``test_torch_distributed.py``)."""
    if "--num-processes" in extra:
        with pytest.raises(SystemExit) as stop:
            train_cli.main(train_args(dataset, *extra))
        assert stop.value.code == 2
        err = capsys.readouterr().err
        assert "--coordinator" in err and "--process-id" in err
    else:
        with pytest.raises(ValueError, match="--num-processes"):
            train_cli.main(train_args(dataset, *extra))
    assert not torch.distributed.is_initialized()
