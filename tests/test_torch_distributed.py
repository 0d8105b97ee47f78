"""PyTorch port, data-parallel training in two real processes over Gloo on the CPU.

* The library: a tiny conv-BN-conv model (``test_torch_train.py``'s
  ``TorchTiny``) trained by two ranks of a Gloo group, global batch 8
  (4 a rank), from the JAX ``Trainer``'s initial weights, against the JAX
  ``Trainer`` on a ``data=2`` mesh of the suite's virtual CPU devices: the
  metric trajectory, the eval metrics, the params and the BN state agree at
  the tolerances of ``test_tiny_trajectory_matches_jax_trainer`` (metrics
  rel 1e-5 / abs 1e-7, params atol 1e-5, BN state rtol 1e-5 / atol 1e-6),
  and the two ranks hold the same bits.
* The shipped CLI: two ``bdt-train --device cpu --coordinator ...
  --num-processes 2 --process-id i`` processes, staged and streamed
  (``BDT_HOST_DECODE_BUDGET=0``), give bit-equal final checkpoints, print
  their per-process feeding lines, and only process 0 writes; a dataset
  smaller than one global batch fails with the "complete global batch"
  message on both paths.
* The CLI under ``torchrun --nproc-per-node 2`` with ``--num-processes 0``.
* ``parallel.dryrun.dryrun_multichip(2, device="cpu")``.
* ``bdt-eval --data-parallel 2`` over two processes: one JSON line, from
  rank 0, equal to the one-process port and to the JAX ``bdt-eval
  --data-parallel 2``; a batch the processes do not split fails with
  ``check_covers_ranks``'s message.
* Channel tensor parallelism, ``Trainer(tp=True)`` over four Gloo
  processes at ``data=2 x model=2`` and ``data=1 x model=4``: one step of
  ``TorchTiny`` from the JAX TP ``Trainer``'s initial weights against that
  trainer on the same mesh shape and against the port's one-process step
  (loss rel 2e-4, params rtol 1e-3 / atol 1e-4, the JAX package's TP
  tolerances), and the Adam moments after the step, which hold the
  gradients, within 1e-4 of each tensor's largest (``assert_moments_close``:
  a sharded gradient scaled by ``model`` fails it, and so does one missing
  the model group's sum wherever that sum changes it); ``load_weights`` leaves each rank its slices, ``save`` writes
  one ``.npz`` that restores into a TP trainer bit for bit (slices and Adam
  moments) and into a plain ``Trainer``, and a staged epoch runs.
  ``LayerZoo`` (every layer class the rule shards, a 2-D BatchNorm, a
  1-channel gate, a layer sharded at ``model=2`` only) over ``1 x 2`` and
  ``2 x 2`` processes against one process (the moments too), and with
  ``remat=True`` equal to the plain TP step bit for bit.

No process group is ever started in the pytest process.  The children are
started by :func:`parallel.dryrun.run_processes` (``Popen`` with an explicit
environment, a session each, a deadline, killed by pid), each run on a
fresh port; a child that fails fails the test with its output.  Run as a
script, this file is the library run's worker:

    python tests/test_torch_distributed.py worker RANK PORT OUTDIR
    python tests/test_torch_distributed.py tp-worker RANK PORT OUTDIR DATA MODEL {tiny|zoo} {cpu|cuda}
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu_torch.core.config import TrainConfig
from building_detection_tpu_torch.core.module import Namer, jax_variables, load_jax_variables
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.parallel import dryrun
from building_detection_tpu_torch.train.checkpoint import load_variables

torch.set_num_threads(2)

CFG = TrainConfig(batch_size=8, image_size=16, epochs=2, warmup_epochs=1)
STEPS = 3
TIMEOUT = 300  # seconds a group of children may take
MOMENT_RTOL, MOMENT_FLOOR = 1e-4, 1e-6  # TP's Adam moments after one step against one process and JAX
CHILD_ENV = {"OMP_NUM_THREADS": "2"}


class TorchTiny(nn.Module):
    """``test_torch_train.TorchTiny`` (that module imports JAX; the workers do not)."""

    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 8, 3, activation="relu")
        self.bn = L.BatchNorm(n, 8)
        self.conv2 = L.Conv2d(n, 8, 2, 1, activation="softmax")

    def forward(self, x):
        return self.conv2(self.bn(self.conv1(x)))


class LayerZoo(nn.Module):
    """Each layer class the TP rule shards, in two remat stages: a conv, a
    4-D and a 2-D BatchNorm, a separable conv (depthwise 8, pointwise 12
    channels), an SE gate of two Dense layers, a 1-channel sSE gate (never
    sharded), a strided conv, a 6-channel conv (sharded at ``model=2``, not
    at 4), a transposed conv and the 2-class head (sharded at 2 only)."""

    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv = L.Conv2d(n, 3, 8, 3, activation="relu")
        self.bn = L.BatchNorm(n, 8)
        self.sep = L.SeparableConv2d(n, 8, 12, 3, activation="relu")
        self.se_down = L.Dense(n, 12, 4, activation="relu")
        self.se_bn = L.BatchNorm(n, 4)
        self.se_up = L.Dense(n, 4, 12, activation="sigmoid")
        self.gate = L.Conv2d(n, 12, 1, 1, activation="sigmoid")
        self.down = L.Conv2d(n, 12, 16, 3, strides=2, activation="relu")
        self.odd = L.Conv2d(n, 16, 6, 1, activation="relu")
        self.up = L.Conv2dTranspose(n, 6, 8, 3, strides=2, activation="relu")
        self.head = L.Conv2d(n, 8, 2, 1, activation="softmax")

    def _encode(self, x):
        x = self.sep(self.bn(self.conv(x)))
        x = x * self.se_up(self.se_bn(self.se_down(L.global_avg_pool(x))))[:, None, None, :]
        return x * self.gate(x)

    def _decode(self, x):
        return self.head(self.up(self.odd(self.down(x))))

    def forward(self, x):
        return L.stage(self, self._decode, L.stage(self, self._encode, x))


def batches(seed=0, n=3 * 8, hw=16):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    labs = np.where(rng.rand(n, hw, hw) < 0.4, 255, 0).astype(np.uint8)
    return imgs, labs


def worker(rank: int, port: int, outdir: str) -> None:
    """One rank of the library run: the JAX initial weights from
    ``outdir/init.npz``, STEPS global batches, one eval batch; writes its
    metrics and final variables."""
    from building_detection_tpu_torch.parallel import distributed as pdist
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from building_detection_tpu_torch.train.trainer import Trainer

    pdist.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        mesh = make_mesh(data=2)
        assert (mesh.data, mesh.rank, mesh.world_size) == (2, rank, 2), mesh
        tr = Trainer(TorchTiny, CFG, steps_per_epoch=3, mesh=mesh, device="cpu")
        with np.load(os.path.join(outdir, "init.npz")) as z:
            params = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
            state = {k[2:]: z[k] for k in z.files if k.startswith("s/")}
        load_jax_variables(tr.model, params, state)
        imgs, labs = batches()
        steps = [tr.train_on_batch(imgs[8 * i : 8 * i + 8], labs[8 * i : 8 * i + 8]) for i in range(STEPS)]
        ev = tr.eval_on_batch(imgs[:8], labs[:8])
        got_p, got_s = jax_variables(tr.model)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **{f"p/{k}": v for k, v in got_p.items()},
                 **{f"s/{k}": v for k, v in got_s.items()})
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump({"steps": steps, "eval": ev, "lr": tr.current_lr(), "primary": pdist.is_primary()}, f)
    finally:
        pdist.destroy()


def tp_worker(rank: int, port: int, outdir: str, data: int, model: int, kind: str, device: str = "cpu") -> None:
    """One rank of a TP run on ``device`` (``cuda``: every rank on the
    current card, f32 with TF32 off and deterministic cuDNN): the weights of
    ``outdir/init.npz``, one step on the first global batch, ``save`` to
    ``outdir/step1.npz``, a restore into a second TP trainer, a
    ``remat=True`` step (``zoo``) and a staged epoch; checks its slices and
    writes ``outdir/tp_rank{rank}.json``.  One intra-op thread: a CPU
    reduction splits its work over the threads the OpenMP runtime grants,
    which a loaded machine may cut, so two runs of one step are bit-equal
    only on one thread."""
    import torch

    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    from building_detection_tpu_torch.parallel import distributed as pdist
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from building_detection_tpu_torch.train.trainer import Trainer

    build = {"tiny": TorchTiny, "zoo": LayerZoo}[kind]
    pdist.init_distributed(f"127.0.0.1:{port}", data * model, rank, backend="gloo")
    try:
        mesh = make_mesh(data=data, model=model)
        assert (mesh.data_index, mesh.model_index) == (rank // model, rank % model), mesh

        def trainer(**kw):
            tr = Trainer(build, CFG, steps_per_epoch=3, mesh=mesh, device=device, tp=True, **kw)
            tr.load_weights(os.path.join(outdir, "init.npz"))
            return tr

        tr = trainer()
        first = tr.model.conv if kind == "zoo" else tr.model.conv1
        assert tr.tp and tuple(first.kernel.shape) == (8 // model, 3, 3, 3), first.kernel.shape
        with np.load(os.path.join(outdir, "init.npz")) as z:
            full = z["params||" + first.jax_name + "/kernel"]
        k = 8 // model
        want = np.ascontiguousarray(full[..., mesh.model_index * k : (mesh.model_index + 1) * k].transpose(3, 2, 0, 1))
        assert np.array_equal(first.kernel.detach().cpu().numpy(), want), "load_weights did not leave this rank its slice"
        imgs, labs = batches()
        step = tr.train_on_batch(imgs[:8], labs[:8])
        tr.save(os.path.join(outdir, "step1.npz"))
        back = Trainer(build, CFG, steps_per_epoch=3, mesh=mesh, device=device, tp=True)
        back.restore(os.path.join(outdir, "step1.npz"))
        assert back.step == 1 and back.optimizer.count == 1
        for (name, a), b in zip(tr.model.state_dict().items(), back.model.state_dict().values()):
            assert torch.equal(a, b), f"restore changed {name}"
        for attr in ("mu", "nu"):
            for key, t in getattr(tr.optimizer, attr).items():
                assert torch.equal(t, getattr(back.optimizer, attr)[key]), (attr, key)
        if kind == "zoo":
            remat = trainer(remat=True)
            assert remat.train_on_batch(imgs[:8], labs[:8]) == step
            for (name, a), b in zip(tr.model.state_dict().items(), remat.model.state_dict().values()):
                assert torch.equal(a, b), f"the remat step differs at {name}"
        staged = tr.train_epoch_staged(*tr.stage_dataset(imgs, labs))
        tr._check_replicas()
        with open(os.path.join(outdir, f"tp_rank{rank}.json"), "w") as f:
            json.dump({"step": step, "staged_loss": [float(v) for v in staged["loss"]]}, f)
    finally:
        pdist.destroy()


def run_ranks(argv_for, cwd, extra_env=None, n=2):
    env = dryrun.port_env({**CHILD_ENV, **(extra_env or {})})
    return dryrun.run_processes([argv_for(i) for i in range(n)], env, TIMEOUT, cwd=str(cwd))


def assert_all_ok(results, what):
    for i, (rc, out) in enumerate(results):
        assert rc == 0, f"{what}: rank {i} exited {rc}:\n{out[-6000:]}"


def test_two_process_dp_matches_jax_data_parallel_trainer(tmp_path):
    import jax

    from building_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from building_detection_tpu.train.trainer import Trainer as JaxTrainer
    from test_torch_train import jax_tiny

    assert "MASTER_ADDR" not in os.environ and "RANK" not in os.environ
    jt = JaxTrainer(jax_tiny, CFG, steps_per_epoch=3, mesh=jax_make_mesh(data=2, devices=jax.devices()[:2]))
    assert jt.mesh.shape["data"] == 2
    init_p = {k: np.asarray(v) for k, v in jax.device_get(jt.params).items()}
    init_s = {k: np.asarray(v) for k, v in jax.device_get(jt.state).items()}
    np.savez(tmp_path / "init.npz", **{f"p/{k}": v for k, v in init_p.items()},
             **{f"s/{k}": v for k, v in init_s.items()})
    port = dryrun.free_port()
    results = run_ranks(lambda i: [sys.executable, os.path.abspath(__file__), "worker", str(i), str(port),
                                   str(tmp_path)], tmp_path)
    assert_all_ok(results, "library run")

    imgs, labs = batches()
    want_steps = [jt.train_on_batch(imgs[8 * i : 8 * i + 8], labs[8 * i : 8 * i + 8]) for i in range(STEPS)]
    want_eval = jt.eval_on_batch(imgs[:8], labs[:8])
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    assert [r["primary"] for r in ranks] == [True, False]
    for i, want in enumerate(want_steps):
        got = ranks[0]["steps"][i]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), (i, k)
    for k in want_eval:
        assert ranks[0]["eval"][k] == pytest.approx(want_eval[k], rel=1e-5, abs=1e-7), k
    assert ranks[0]["lr"] == pytest.approx(jt.current_lr(), rel=1e-6)
    assert ranks[0]["steps"] == ranks[1]["steps"] and ranks[0]["eval"] == ranks[1]["eval"]

    with np.load(tmp_path / "rank0.npz") as z0, np.load(tmp_path / "rank1.npz") as z1:
        assert sorted(z0.files) == sorted(z1.files)
        for k in z0.files:
            np.testing.assert_array_equal(z0[k], z1[k], err_msg=f"ranks differ at {k}")
        for k, v in jax.device_get(jt.params).items():
            np.testing.assert_allclose(z0[f"p/{k}"], np.asarray(v), atol=1e-5, err_msg=k)
        for k, v in jax.device_get(jt.state).items():
            np.testing.assert_allclose(z0[f"s/{k}"], np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


# -- the shipped CLI (hrnet: the smallest member, so the checkpoints stay small) -----------
def write_pairs(root, n, size=16):
    from building_detection_tpu_torch.utils import io as uio

    rng = np.random.RandomState(0)
    for i in range(n):
        uio.imwrite(str(root / "imgs" / f"{i:03d}.png"), rng.randint(0, 256, (size, size, 3)).astype(np.uint8))
        uio.imwrite(str(root / "labs" / f"{i:03d}.png"),
                    np.where(rng.rand(size, size) < 0.3, 255, 0).astype(np.uint8))
    return str(root / "imgs"), str(root / "labs")


def cli_args(img_dir, lab_dir, port, ckpt_root):
    def argv_for(i):
        return [sys.executable, "-m", "building_detection_tpu_torch.cli.train", "hrnet",
                "--train-images", img_dir, "--train-labels", lab_dir,
                "--checkpoint-dir", os.path.join(ckpt_root, f"p{i}"), "--batch-size", "8", "--epochs", "2",
                "--warmup-epochs", "1", "--image-size", "16", "--precision", "f32", "--device", "cpu",
                "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i)]
    return argv_for


def test_cli_staged_and_streamed_match_bitwise(tmp_path):
    img_dir, lab_dir = write_pairs(tmp_path, 32)
    ckpts = {}
    for kind, env in (("staged", None), ("streamed", {"BDT_HOST_DECODE_BUDGET": "0"})):
        root = str(tmp_path / kind)
        results = run_ranks(cli_args(img_dir, lab_dir, dryrun.free_port(), root), tmp_path, env)
        assert_all_ok(results, f"{kind} bdt-train")
        verb = "feeding" if kind == "staged" else "streaming"
        for i, (_, out) in enumerate(results):
            assert f"process {i}: {verb} 16 samples" in out, out
        ckpts[kind] = os.path.join(root, "p0", "epoch_2_weights.npz")
        assert os.path.exists(ckpts[kind]) and os.path.exists(os.path.join(root, "p0", "history.json"))
        p1 = os.path.join(root, "p1")
        assert not os.path.exists(p1) or os.listdir(p1) == [], "process 1 wrote"
    assert load_variables(ckpts["staged"])[3] == 8  # 2 epochs x 4 global batches
    with np.load(ckpts["staged"]) as a, np.load(ckpts["streamed"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("budget", [None, "0"], ids=["staged", "streamed"])
def test_cli_too_small_dataset_fails_actionably(tmp_path, budget):
    img_dir, lab_dir = write_pairs(tmp_path, 4)
    env = None if budget is None else {"BDT_HOST_DECODE_BUDGET": budget}
    results = run_ranks(cli_args(img_dir, lab_dir, dryrun.free_port(), str(tmp_path / "ck")), tmp_path, env)
    assert any(rc != 0 for rc, _ in results), results
    assert any("at least one complete global batch" in out for _, out in results), results
    assert not os.path.exists(tmp_path / "ck" / "p0" / "epoch_1_weights.npz")


def test_cli_under_torchrun(tmp_path):
    """``--num-processes 0`` reads the ``torchrun`` environment (``env://``,
    joining the store torchrun's agent serves)."""
    img_dir, lab_dir = write_pairs(tmp_path, 16)
    argv = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--master-port",
            str(dryrun.free_port()), "-m", "building_detection_tpu_torch.cli.train", "hrnet", "--train-images",
            img_dir, "--train-labels", lab_dir, "--checkpoint-dir", str(tmp_path / "ck"), "--batch-size", "8",
            "--epochs", "1", "--warmup-epochs", "0", "--image-size", "16", "--precision", "f32", "--device", "cpu",
            "--num-processes", "0"]
    ((rc, out),) = run_ranks(lambda i: argv, tmp_path, n=1)
    assert rc == 0, out[-6000:]
    # torchrun's agent is one launcher process of two workers (LOCAL_WORLD_SIZE=2)
    assert "process 0 worker 0 rank 0: feeding 8 samples" in out, out
    assert "process 0 worker 1 rank 1: feeding 8 samples" in out, out
    assert load_variables(str(tmp_path / "ck" / "epoch_1_weights.npz"))[3] == 2


# -- bdt-eval over processes ---------------------------------------------------------------
def eval_args(img_dir, lab_dir, ckpt, batch_size=8):
    return ["scse", "--checkpoint", ckpt, "--images", img_dir, "--labels", lab_dir, "--batch-size", str(batch_size),
            "--image-size", "16", "--precision", "f32"]


def eval_ranks(args, port, n=2):
    return lambda i: [sys.executable, "-m", "building_detection_tpu_torch.cli.evaluate", *args, "--device", "cpu",
                      "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id", str(i)]


def json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_eval_cli_two_processes_match_one_process_and_jax(tmp_path, capsys):
    """``bdt-eval --data-parallel 2`` over two Gloo processes: one JSON line,
    from rank 0, equal to the one-process port (metrics equal, loss within
    1e-6 relative) and to the JAX ``bdt-eval --data-parallel 2`` on the
    suite's virtual devices at the port's eval tolerances (rel 1e-5; the
    line rounds to 6 places, so abs 1e-6)."""
    from building_detection_tpu.cli import evaluate as jax_eval_cli
    from building_detection_tpu_torch.cli import evaluate as eval_cli
    from building_detection_tpu_torch.train.trainer import Trainer

    img_dir, lab_dir = write_pairs(tmp_path, 24)
    tr = Trainer("scse", TrainConfig(batch_size=8, image_size=16), device="cpu")
    imgs, labs = batches(seed=5, n=8)
    tr.train_on_batch(imgs, labs)  # moving BN statistics away from their start
    ckpt = str(tmp_path / "ck.npz")
    tr.save(ckpt)
    args = eval_args(img_dir, lab_dir, ckpt)
    results = run_ranks(eval_ranks([*args, "--data-parallel", "2"], dryrun.free_port()), tmp_path)
    assert_all_ok(results, "bdt-eval --data-parallel 2")
    (two,) = json_lines(results[0][1])
    assert json_lines(results[1][1]) == [], "process 1 printed a result"
    assert eval_cli.main([*args, "--device", "cpu"]) == 0
    (one,) = json_lines(capsys.readouterr().out)
    assert jax_eval_cli.main([*args, "--data-parallel", "2"]) == 0
    (jax_two,) = json_lines(capsys.readouterr().out)
    assert two["samples"] == one["samples"] == jax_two["samples"] == 24
    assert sorted(two) == sorted(one) == sorted(jax_two)
    for k in one:
        if k == "loss":
            assert two[k] == pytest.approx(one[k], rel=1e-6), k
        else:
            assert two[k] == one[k], k
        assert two[k] == pytest.approx(jax_two[k], rel=1e-5, abs=1e-6), k


@pytest.mark.parametrize("data,match", [("2", r"batch of 3 does not split over data=2.*--batch-size"),
                                        ("-1", r"excludes rank\(s\) \[1\].*--batch-size")],
                         ids=["explicit", "gcd"])
def test_eval_cli_batch_not_dividing_fails_actionably(tmp_path, data, match):
    """A global batch of 3 over two processes: ``--data-parallel 2`` does not
    split it, and ``-1`` caps the data axis at gcd(3, 2) = 1, leaving rank 1
    out; both fail at set-up with ``check_covers_ranks``'s message."""
    import re

    img_dir, lab_dir = write_pairs(tmp_path, 6)
    args = eval_args(img_dir, lab_dir, str(tmp_path / "absent.npz"), batch_size=3)
    results = run_ranks(eval_ranks([*args, "--data-parallel", data], dryrun.free_port()), tmp_path)
    assert all(rc != 0 for rc, _ in results), results
    assert all(re.search(match, out) for _, out in results), results


def run_tp(tmp_path, data, model, kind, init_params, init_state, device="cpu"):
    from building_detection_tpu_torch.train.checkpoint import save_variables

    save_variables(str(tmp_path / "init.npz"), init_params, init_state)
    port = dryrun.free_port()
    results = run_ranks(lambda i: [sys.executable, os.path.abspath(__file__), "tp-worker", str(i), str(port),
                                   str(tmp_path), str(data), str(model), kind, device], tmp_path, n=data * model)
    assert_all_ok(results, f"TP data={data} x model={model}")
    ranks = []
    for r in range(data * model):
        with open(tmp_path / f"tp_rank{r}.json") as f:
            ranks.append(json.load(f))
    assert all(r == ranks[0] for r in ranks), "the ranks' metrics differ"
    assert np.isfinite(ranks[0]["staged_loss"]).all()
    return ranks[0]["step"], load_variables(str(tmp_path / "step1.npz"))


def one_process_step(build, init_path, device="cpu"):
    from building_detection_tpu_torch.train.trainer import Trainer

    tr = Trainer(build, CFG, steps_per_epoch=3, device=device)
    tr.load_weights(init_path)
    imgs, labs = batches()
    return tr.train_on_batch(imgs[:8], labs[:8]), jax_variables(tr.model), tr.optimizer.jax_state()


def assert_step_close(step, params, want_step, want_params):
    assert step["loss"] == pytest.approx(want_step["loss"], rel=2e-4)
    assert sorted(params) == sorted(want_params)
    for k in want_params:
        np.testing.assert_allclose(params[k], want_params[k], rtol=1e-3, atol=1e-4, err_msg=k)


def assert_moments_close(opt, want_opt):
    """The Keras Adam moments after one step, ``mu = 0.1 g`` and ``nu =
    0.001 g**2``: the gradients themselves, which the params cannot show
    (the first step at the warmup lr moves each weight by about lr, under
    their atol whatever the gradient).  Each tensor within ``MOMENT_RTOL``
    of its largest moment, plus ``MOMENT_FLOOR`` of the largest of any
    tensor (the SE gate's Dense bias behind a BatchNorm has a gradient of
    float noise).  A gradient scaled by ``model`` or missing a model-group
    sum is off by about its own size."""
    assert sorted(opt) == sorted(want_opt) and int(opt[".count"]) == int(want_opt[".count"]) == 1
    for attr in ("mu", "nu"):
        keys = [k for k in want_opt if k.startswith(f".{attr}[")]
        floor = MOMENT_FLOOR * max(float(np.abs(want_opt[k]).max()) for k in keys)
        for k in keys:
            atol = MOMENT_RTOL * float(np.abs(want_opt[k]).max()) + floor
            np.testing.assert_allclose(opt[k], want_opt[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("data,model", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_tp_training_matches_jax_tp_trainer_and_one_process(tmp_path, data, model):
    import jax

    from building_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from building_detection_tpu.train.trainer import Trainer as JaxTrainer
    from building_detection_tpu_torch.train.trainer import Trainer
    from test_torch_train import jax_tiny

    jt = JaxTrainer(jax_tiny, CFG, steps_per_epoch=3, tp=True,
                    mesh=jax_make_mesh(data=data, model=model, devices=jax.devices()[: data * model]))
    assert jt.tp
    init_p = {k: np.asarray(v) for k, v in jax.device_get(jt.params).items()}
    init_s = {k: np.asarray(v) for k, v in jax.device_get(jt.state).items()}
    step, (params, state, opt, n, _) = run_tp(tmp_path, data, model, "tiny", init_p, init_s)
    assert n == 1 and int(opt[".count"]) == 1

    imgs, labs = batches()
    want = jt.train_on_batch(imgs[:8], labs[:8])
    assert_step_close(step, params, want, {k: np.asarray(v) for k, v in jax.device_get(jt.params).items()})
    jt.save(str(tmp_path / "jax_step1.npz"))
    assert_moments_close(opt, load_variables(str(tmp_path / "jax_step1.npz"))[2])
    one, (one_params, _), one_opt = one_process_step(TorchTiny, str(tmp_path / "init.npz"))
    assert_step_close(step, params, one, one_params)
    assert_moments_close(opt, one_opt)

    plain = Trainer(TorchTiny, CFG, steps_per_epoch=3, device="cpu")
    plain.restore(str(tmp_path / "step1.npz"))
    got_p, got_s = jax_variables(plain.model)
    assert plain.step == 1 and all(np.array_equal(got_p[k], params[k]) for k in params)
    assert all(np.array_equal(got_s[k], state[k]) for k in state)


def zoo_weights():
    from building_detection_tpu_torch.core.module import init_layers

    zoo = init_layers(LayerZoo(), torch.Generator().manual_seed(3))
    with torch.no_grad():  # moving statistics away from their start
        for bn in (zoo.bn, zoo.se_bn):
            bn.moving_mean.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(4))
            bn.moving_variance.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(5))
    return jax_variables(zoo)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tp_training_of_every_layer_class_matches_one_process(tmp_path, data, model):
    """``LayerZoo`` over ``data x model`` Gloo processes against one
    process; inside the workers, ``remat=True`` equals the plain TP step."""
    step, (params, _, opt, n, _) = run_tp(tmp_path, data, model, "zoo", *zoo_weights())
    assert n == 1
    one, (one_params, _), one_opt = one_process_step(LayerZoo, str(tmp_path / "init.npz"))
    assert_step_close(step, params, one, one_params)
    assert_moments_close(opt, one_opt)


def test_dryrun_multichip_two_cpu_processes():
    results = dryrun.dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["device"] == "cpu" for r in results)
    assert np.isfinite(results[0]["loss"])


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
if __name__ == "__main__" and sys.argv[1:2] == ["tp-worker"]:
    tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]), int(sys.argv[6]), sys.argv[7],
              sys.argv[8])
