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

No process group is ever started in the pytest process.  The children are
started by :func:`parallel.dryrun.run_processes` (``Popen`` with an explicit
environment, a session each, a deadline, killed by pid), each run on a
fresh port; a child that fails fails the test with its output.  Run as a
script, this file is the library run's worker:

    python tests/test_torch_distributed.py worker RANK PORT OUTDIR
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
    assert "process 0: feeding 8 samples" in out and "process 1: feeding 8 samples" in out, out
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


def test_dryrun_multichip_two_cpu_processes():
    results = dryrun.dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["device"] == "cpu" for r in results)
    assert np.isfinite(results[0]["loss"])


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
