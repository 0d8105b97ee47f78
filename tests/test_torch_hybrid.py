"""PyTorch port, every local device of each process: workers started by
``parallel/launch.py``, two launcher processes of two Gloo workers each on
the CPU, held against the JAX package's device order, its ``data=4``
``Trainer`` and its two-process fused predictor.

* The layout: worker ``k`` of launcher process ``p`` is rank ``p * 2 + k``
  (``RANK``, ``LOCAL_RANK``, ``GROUP_RANK``, ``Mesh.process_index`` and
  ``local_rank``); each process's workers feed, together, the rows that the
  JAX package's ``make_mesh(data=4, devices=jax.devices()[:4])`` gives
  devices ``2p`` and ``2p + 1`` (its ``devices_indices_map``, the map JAX's
  ``parallel/distributed.py::_owned_rows`` reads); at ``data=2 x model=2``
  each model group is one process's workers, the rows of JAX's mesh.
* The library form, ``launch(fn, ..., local_devices=2, coordinator=...,
  num_processes=2, process_id=p)``: ``TorchTiny`` from the JAX ``Trainer``'s
  initial weights, STEPS global batches of 8, against the JAX ``Trainer`` on
  ``make_mesh(data=4)`` at the tolerances of
  ``test_torch_distributed.py::test_two_process_dp_matches_jax_data_parallel_trainer``
  (metrics rel 1e-5 / abs 1e-7, params atol 1e-5, BN state rtol 1e-5 / atol
  1e-6), every rank's params and state the same bits.
* The fused predictor over a mesh that spans processes: the JAX package's
  ``FusedEnsemblePredictor(mesh=make_mesh(data=4))`` in two JAX processes of
  two virtual CPU devices each returns every mask on both processes, equal
  to one process's (``tests/test_distributed.py``'s two-process pattern,
  through the JAX package's public API); the port's, over the four Gloo
  workers, does the same on every rank, equal to the port's one process and
  to the JAX package's, in f32, bit for bit.
* The CLI: two ``bdt-train hrnet --local-devices 2 --coordinator ...``
  launchers give the checkpoint of one ``bdt-train --local-devices 4``
  launcher, bit for bit, with their per-worker feeding lines and one writer;
  ``bdt-eval --local-devices 2`` equals one process; ``--local-devices 4
  --batch-size 2`` starts two workers (the JAX package's gcd cap).
* Failures and refusals: a failing worker makes the launcher raise (and the
  CLI exit 1) naming its rank and error; ``--local-devices`` under
  ``--num-processes 0``; several ``local_device_ids`` outside the launcher;
  more NCCL workers than cards, and no card, before anything starts.

No process group is started in the pytest process: launcher processes are
children (``parallel.dryrun.run_processes``), and this file, run as a
script, is their program:

    python tests/test_torch_hybrid.py library PROCESS_ID PORT OUTDIR
    python tests/test_torch_hybrid.py jax-fused PROCESS_ID PORT OUTDIR
    python tests/test_torch_hybrid.py fail
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from building_detection_tpu_torch.parallel import dryrun

torch.set_num_threads(2)

HERE = os.path.abspath(__file__)
K = 2  # workers a launcher process
PROCESSES = 2
N_SAMPLES = 32
TIMEOUT = 300
CHILD_ENV = {"OMP_NUM_THREADS": "1"}
SHAPES = [(56, 56), (40, 81), (120, 170), (6, 6)]  # 4, 8, 35 and 0 tiles of 32 at stride 24
SCENE_SEED = 7


def tiler():
    from building_detection_tpu_torch.core.config import TilerConfig

    return TilerConfig(tile=32, stride=24, overlap=8)


def run_children(argvs, cwd, extra_env=None):
    env = dryrun.port_env({**CHILD_ENV, **(extra_env or {})})
    return dryrun.run_processes(argvs, env, TIMEOUT, cwd=str(cwd))


def assert_all_ok(results, what):
    for i, (rc, out) in enumerate(results):
        assert rc == 0, f"{what}: process {i} exited {rc}:\n{out[-6000:]}"


# -- the launched workers ------------------------------------------------------------------
def library_worker(outdir: str) -> int:
    """One worker of the library run: its place, its rows, its groups at
    ``2 x 2``, STEPS steps of ``TorchTiny`` from ``outdir/init.npz`` and the
    fused predictor over the ranks; writes ``rank{r}.json``/``.npz`` and
    ``masks{r}.npz``."""
    import torch.distributed as dist

    from building_detection_tpu_torch.core.module import jax_variables, load_jax_variables
    from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
    from building_detection_tpu_torch.parallel import distributed as pdist
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from building_detection_tpu_torch.train.trainer import Trainer
    from test_torch_cuda import scenes, tiny_members
    from test_torch_distributed import CFG, STEPS, TorchTiny, batches

    torch.set_num_threads(1)
    mesh = make_mesh(batch_size=CFG.batch_size)
    rank = mesh.rank
    info = {
        "env": {k: int(os.environ[k]) for k in ("RANK", "LOCAL_RANK", "GROUP_RANK", "LOCAL_WORLD_SIZE", "WORLD_SIZE")},
        "rank": rank, "data": mesh.data, "data_index": mesh.data_index, "process_index": mesh.process_index,
        "local_rank": mesh.local_rank, "local_size": mesh.local_size, "primary": pdist.is_primary(),
        "rows": pdist.local_sample_indices(N_SAMPLES, CFG.batch_size, mesh).tolist(),
    }
    tp = make_mesh(data=2, model=2)
    info["model_group"] = dist.get_process_group_ranks(tp.model_group)
    info["data_group"] = dist.get_process_group_ranks(tp.group)

    tr = Trainer(TorchTiny, CFG, steps_per_epoch=3, mesh=mesh, device="cpu")
    with np.load(os.path.join(outdir, "init.npz")) as z:
        load_jax_variables(tr.model, {k[2:]: z[k] for k in z.files if k.startswith("p/")},
                           {k[2:]: z[k] for k in z.files if k.startswith("s/")})
    imgs, labs = batches()
    info["steps"] = [tr.train_on_batch(imgs[8 * i : 8 * i + 8], labs[8 * i : 8 * i + 8]) for i in range(STEPS)]
    info["eval"] = tr.eval_on_batch(imgs[:8], labs[:8])
    params, state = jax_variables(tr.model)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **{f"p/{k}": v for k, v in params.items()},
             **{f"s/{k}": v for k, v in state.items()})

    pred = FusedEnsemblePredictor(tiny_members(), tiler(), 2, torch.float32, "cpu", mesh=mesh)
    info["batch_tiles"] = pred.batch_tiles
    masks = pred.predict_masks_many(scenes(SCENE_SEED, SHAPES))
    np.savez(os.path.join(outdir, f"masks{rank}.npz"), **{f"{i}/{n}": m for i, ms in enumerate(masks) for n, m in ms.items()})
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    return rank


def failing_worker(bad_rank: int) -> int:
    import torch.distributed as dist

    rank = dist.get_rank()
    if rank == bad_rank:
        raise RuntimeError(f"deliberate failure on rank {rank}")
    dist.barrier()  # the others wait here until the launcher stops them
    return rank


def library_main(pid: int, port: int, outdir: str) -> None:
    from building_detection_tpu_torch.parallel.launch import launch

    first = launch(library_worker, outdir, local_devices=K, coordinator=f"127.0.0.1:{port}", num_processes=PROCESSES,
                   process_id=pid, backend="gloo", device_type="cpu")
    print(f"launcher {pid}: first worker returned {first}", flush=True)


def jax_fused_main(pid: int, port: int, outdir: str) -> None:
    """One JAX process of two virtual CPU devices: the JAX package's fused
    predictor over the global ``data=4`` mesh, its masks written to
    ``outdir``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from building_detection_tpu.core.config import TilerConfig as JaxTilerConfig
    from building_detection_tpu.infer.fused_ensemble import FusedEnsemblePredictor as JaxFused
    from building_detection_tpu.parallel import distributed as jdist
    from building_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from test_torch_cuda import NAMES, scenes, tiny_variables
    from test_torch_pipeline import tiny_member

    jdist.init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=PROCESSES, process_id=pid)
    assert jax.process_count() == PROCESSES and jax.device_count() == 2 * PROCESSES
    mesh = jax_make_mesh(data=4)
    members = {n: (tiny_member, *tiny_variables(i)) for i, n in enumerate(NAMES)}
    pred = JaxFused(members, JaxTilerConfig(tile=32, stride=24, overlap=8), batch_tiles=2,
                    compute_dtype=jnp.float32, mesh=mesh)
    masks = pred.predict_masks_many(scenes(SCENE_SEED, SHAPES))
    np.savez(os.path.join(outdir, f"jax_masks{pid}.npz"),
             **{f"{i}/{n}": np.asarray(m) for i, ms in enumerate(masks) for n, m in ms.items()})
    print(f"jax process {pid}: {len(masks)} scenes", flush=True)


def fail_main() -> None:
    from building_detection_tpu_torch.parallel.launch import launch

    launch(failing_worker, 1, local_devices=3, backend="gloo", device_type="cpu")


# -- fixtures ------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def library_run(tmp_path_factory):
    """The JAX ``Trainer`` over ``data=4`` (its initial weights to
    ``init.npz``), then two launcher processes of two workers each running
    :func:`library_worker`; returns (outdir, the ranks' info, the JAX
    trainer, its step and eval metrics)."""
    import jax

    from building_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from building_detection_tpu.train.trainer import Trainer as JaxTrainer
    from test_torch_distributed import CFG, STEPS, batches
    from test_torch_train import jax_tiny

    out = tmp_path_factory.mktemp("library")
    jt = JaxTrainer(jax_tiny, CFG, steps_per_epoch=3, mesh=jax_make_mesh(data=4, devices=jax.devices()[:4]))
    assert jt.mesh.shape["data"] == 4
    np.savez(out / "init.npz", **{f"p/{k}": np.asarray(v) for k, v in jax.device_get(jt.params).items()},
             **{f"s/{k}": np.asarray(v) for k, v in jax.device_get(jt.state).items()})
    port = dryrun.free_port()
    results = run_children([[sys.executable, HERE, "library", str(p), str(port), str(out)] for p in range(PROCESSES)],
                           out)
    assert_all_ok(results, "library form, 2 launchers x 2 workers")
    for p, (_, text) in enumerate(results):
        assert f"launcher {p}: first worker returned {p * K}" in text, text[-3000:]
    ranks = []
    for r in range(PROCESSES * K):
        with open(out / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    imgs, labs = batches()
    steps = [jt.train_on_batch(imgs[8 * i : 8 * i + 8], labs[8 * i : 8 * i + 8]) for i in range(STEPS)]
    return out, ranks, jt, steps, jt.eval_on_batch(imgs[:8], labs[:8])


def test_ranks_are_process_major(library_run):
    _, ranks, *_ = library_run
    for r, info in enumerate(ranks):
        p, k = divmod(r, K)
        assert info["rank"] == r
        assert info["env"] == {"RANK": r, "LOCAL_RANK": k, "GROUP_RANK": p, "LOCAL_WORLD_SIZE": K, "WORLD_SIZE": 4}
        assert (info["process_index"], info["local_rank"], info["local_size"]) == (p, k, K)
        assert (info["data"], info["data_index"]) == (4, r)
    assert [info["primary"] for info in ranks] == [True, False, False, False]


def test_each_process_feeds_the_rows_of_its_jax_devices(library_run):
    import jax

    from building_detection_tpu.parallel.mesh import data_sharded, make_mesh as jax_make_mesh

    _, ranks, *_ = library_run
    devices = jax.devices()[:4]
    index_map = data_sharded(jax_make_mesh(data=4, devices=devices), 1).devices_indices_map((8,))
    steps = N_SAMPLES // 8
    for p in range(PROCESSES):
        owned = sorted({i for d in devices[p * K : (p + 1) * K] for i in range(*index_map[d][0].indices(8))})
        want = (np.arange(steps)[:, None] * 8 + np.asarray(owned)).reshape(-1)
        got = sorted(i for info in ranks[p * K : (p + 1) * K] for i in info["rows"])
        np.testing.assert_array_equal(got, want)
        assert len(ranks[p * K]["rows"]) == N_SAMPLES // 4  # each worker its own quarter


def test_model_groups_sit_inside_one_process_as_jax_mesh_rows(library_run):
    import jax

    from building_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh

    _, ranks, *_ = library_run
    rows = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4]).devices
    for r, info in enumerate(ranks):
        assert info["model_group"] == [d.id for d in rows[r // 2]]
        assert info["model_group"] == [p * K + k for p in [r // K] for k in range(K)]
        assert info["data_group"] == [d.id for d in rows[:, r % 2]]


def test_library_form_matches_jax_trainer_over_four_devices(library_run):
    import jax

    out, ranks, jt, want_steps, want_eval = library_run
    for i, want in enumerate(want_steps):
        got = ranks[0]["steps"][i]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), (i, k)
    for k in want_eval:
        assert ranks[0]["eval"][k] == pytest.approx(want_eval[k], rel=1e-5, abs=1e-7), k
    assert all(r["steps"] == ranks[0]["steps"] and r["eval"] == ranks[0]["eval"] for r in ranks)
    with np.load(out / "rank0.npz") as z0:
        for r in range(1, PROCESSES * K):
            with np.load(out / f"rank{r}.npz") as z:
                assert sorted(z.files) == sorted(z0.files)
                for k in z0.files:
                    np.testing.assert_array_equal(z[k], z0[k], err_msg=f"rank {r} differs at {k}")
        for k, v in jax.device_get(jt.params).items():
            np.testing.assert_allclose(z0[f"p/{k}"], np.asarray(v), atol=1e-5, err_msg=k)
        for k, v in jax.device_get(jt.state).items():
            np.testing.assert_allclose(z0[f"s/{k}"], np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


def load_masks(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_fused_predictor_over_processes_on_both_packages(library_run, tmp_path):
    """JAX: two processes of two devices each return every mask, equal to
    one process's.  The port over two launchers of two workers: every rank
    returns the same masks, equal to one process and to the JAX package's."""
    import jax.numpy as jnp

    from building_detection_tpu.core.config import TilerConfig as JaxTilerConfig
    from building_detection_tpu.infer.fused_ensemble import FusedEnsemblePredictor as JaxFused
    from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
    from test_torch_cuda import NAMES, scenes, tiny_members, tiny_variables
    from test_torch_pipeline import tiny_member

    port = dryrun.free_port()
    results = run_children([[sys.executable, HERE, "jax-fused", str(p), str(port), str(tmp_path)]
                            for p in range(PROCESSES)], tmp_path)
    assert_all_ok(results, "JAX fused predictor over two processes")
    imgs = scenes(SCENE_SEED, SHAPES)
    members = {n: (tiny_member, *tiny_variables(i)) for i, n in enumerate(NAMES)}
    jax_one = JaxFused(members, JaxTilerConfig(tile=32, stride=24, overlap=8), batch_tiles=2,
                       compute_dtype=jnp.float32).predict_masks_many(imgs)
    want = {f"{i}/{n}": np.asarray(m) for i, ms in enumerate(jax_one) for n, m in ms.items()}
    port_one = FusedEnsemblePredictor(tiny_members(), tiler(), 2, torch.float32, "cpu").predict_masks_many(imgs)
    one = {f"{i}/{n}": m for i, ms in enumerate(port_one) for n, m in ms.items()}
    assert sorted(want) == sorted(one) and len(want) == len(SHAPES) * len(NAMES)
    assert any(m.any() for m in want.values()) and any(not m.all() for m in want.values())
    out, ranks, *_ = library_run
    assert all(info["batch_tiles"] == 2 * 4 for info in ranks)  # per rank, as in the JAX package
    got = [load_masks(tmp_path / f"jax_masks{p}.npz") for p in range(PROCESSES)]
    got += [load_masks(out / f"masks{r}.npz") for r in range(PROCESSES * K)]
    for masks in got:
        assert sorted(masks) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(masks[k], want[k], err_msg=k)
            np.testing.assert_array_equal(one[k], want[k], err_msg=k)


# -- the CLI -------------------------------------------------------------------------------
def train_argv(img_dir, lab_dir, ckpt_dir, *extra):
    return [sys.executable, "-m", "building_detection_tpu_torch.cli.train", "hrnet", "--train-images", img_dir,
            "--train-labels", lab_dir, "--checkpoint-dir", ckpt_dir, "--batch-size", "8", "--epochs", "2",
            "--warmup-epochs", "1", "--image-size", "16", "--precision", "f32", "--device", "cpu", *extra]


def test_cli_two_launchers_of_two_match_one_launcher_of_four(tmp_path):
    from test_torch_distributed import write_pairs

    from building_detection_tpu_torch.train.checkpoint import load_variables

    img_dir, lab_dir = write_pairs(tmp_path, 32)
    port = dryrun.free_port()
    hybrid = [train_argv(img_dir, lab_dir, str(tmp_path / f"h{p}"), "--local-devices", "2", "--coordinator",
                         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(p)) for p in range(2)]
    alone = train_argv(img_dir, lab_dir, str(tmp_path / "one"), "--local-devices", "4")
    results = run_children(hybrid + [alone], tmp_path)
    assert_all_ok(results, "bdt-train --local-devices")
    for p in range(2):
        text = results[p][1]
        assert f"process {p}: starting 2 training worker(s), ranks {2 * p}..{2 * p + 1} of 4" in text, text[-3000:]
        for k in range(2):
            assert f"process {p} worker {k} rank {2 * p + k}: feeding 8 samples" in text, text[-3000:]
    assert all(f"process 0 worker {k} rank {k}: feeding 8 samples" in results[2][1] for k in range(4))
    assert not os.path.exists(tmp_path / "h1") or os.listdir(tmp_path / "h1") == [], "process 1 wrote"
    a, b = tmp_path / "h0" / "epoch_2_weights.npz", tmp_path / "one" / "epoch_2_weights.npz"
    assert load_variables(str(a))[3] == 8  # 2 epochs x 4 global batches
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_eval_cli_over_launched_workers_equals_one_process(tmp_path, capsys):
    from test_torch_distributed import batches, eval_args, json_lines, write_pairs

    from building_detection_tpu_torch.cli import evaluate as eval_cli
    from building_detection_tpu_torch.core.config import TrainConfig
    from building_detection_tpu_torch.train.trainer import Trainer

    img_dir, lab_dir = write_pairs(tmp_path, 16)
    tr = Trainer("scse", TrainConfig(batch_size=8, image_size=16), device="cpu")
    tr.train_on_batch(*batches(seed=5, n=8))
    ckpt = str(tmp_path / "ck.npz")
    tr.save(ckpt)
    args = eval_args(img_dir, lab_dir, ckpt)
    ((rc, text),) = run_children([[sys.executable, "-m", "building_detection_tpu_torch.cli.evaluate", *args,
                                   "--device", "cpu", "--local-devices", "2"]], tmp_path)
    assert rc == 0, text[-6000:]
    assert "process 0: starting 2 evaluation worker(s)" in text
    (two,) = json_lines(text)
    assert eval_cli.main([*args, "--device", "cpu"]) == 0
    (one,) = json_lines(capsys.readouterr().out)
    assert sorted(two) == sorted(one) and two["samples"] == 16
    for k in one:
        if k == "loss":
            assert two[k] == pytest.approx(one[k], rel=1e-6), k
        else:
            assert two[k] == one[k], k


def test_cli_caps_workers_at_gcd_of_batch_and_devices(tmp_path):
    """``--local-devices 4 --batch-size 2`` starts 2 workers: JAX's
    ``make_mesh(batch_size=2)`` over 4 devices uses 2."""
    from test_torch_distributed import write_pairs

    img_dir, lab_dir = write_pairs(tmp_path, 4)
    argv = train_argv(img_dir, lab_dir, str(tmp_path / "ck"), "--local-devices", "4")
    argv[argv.index("--batch-size") + 1], argv[argv.index("--epochs") + 1] = "2", "1"
    argv[argv.index("--warmup-epochs") + 1] = "0"
    ((rc, text),) = run_children([argv], tmp_path)
    assert rc == 0, text[-6000:]
    assert "process 0: starting 2 training worker(s), ranks 0..1 of 2" in text, text[-3000:]
    assert "process 0 worker 1 rank 1: feeding 2 samples" in text and "rank 2" not in text
    assert os.path.exists(tmp_path / "ck" / "epoch_1_weights.npz")


# -- failures and refusals -----------------------------------------------------------------
def test_failing_worker_fails_the_launcher_naming_its_rank(tmp_path):
    ((rc, text),) = run_children([[sys.executable, HERE, "fail"]], tmp_path)
    assert rc != 0
    assert "WorkerFailed" in text and "failed, rank(s) [" in text, text[-4000:]
    assert "worker rank 1 (process 0 worker 1) failed: RuntimeError: deliberate failure on rank 1" in text


def test_cli_exits_1_when_its_workers_fail(tmp_path):
    from test_torch_distributed import write_pairs

    img_dir, lab_dir = write_pairs(tmp_path, 8)
    argv = train_argv(img_dir, lab_dir, str(tmp_path / "ck"), "--local-devices", "2", "--init-weights",
                      str(tmp_path / "absent.npz"))
    ((rc, text),) = run_children([argv], tmp_path)
    assert rc == 1, text[-4000:]
    assert "training failed:" in text and "worker(s) failed, rank(s) [" in text and "absent.npz" in text


def test_local_devices_under_torchrun_is_refused(capsys):
    from building_detection_tpu_torch.cli import evaluate as eval_cli
    from building_detection_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit) as e:
        train_cli.main(["hrnet", "--train-images", "i", "--train-labels", "l", "--device", "cpu",
                        "--num-processes", "0", "--local-devices", "2"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        eval_cli.main(["hrnet", "--checkpoint", "c", "--images", "i", "--labels", "l", "--device", "cpu",
                       "--num-processes", "0", "--local-devices", "2"])
    assert capsys.readouterr().err.count("torchrun already started the") == 2


def test_several_device_ids_outside_the_launcher_are_refused():
    from building_detection_tpu_torch.parallel import distributed as pdist

    with pytest.raises(ValueError, match=r"drives one device.*parallel/launch.py.*--local-devices"):
        pdist.init_distributed("127.0.0.1:1", 2, 0, local_device_ids=[0, 1], backend="gloo")
    assert not torch.distributed.is_initialized()


def test_launch_checks_the_cards_before_it_starts(monkeypatch):
    from building_detection_tpu_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch.launch(print, local_devices=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="3 NCCL workers need 3 cards and torch sees 2"):
        launch.launch(print, local_devices=3)
    assert launch.worker_cards(3, "gloo", "cuda") == [0, 1, 0]  # Gloo workers share the cards
    assert launch.worker_cards(2, "nccl", "cuda") == [0, 1]
    assert launch.worker_cards(4, "gloo", "cpu") is None
    with pytest.raises(ValueError, match="need a coordinator"):
        launch.launch(print, local_devices=1, num_processes=2, process_id=1, backend="gloo", device_type="cpu")


if __name__ == "__main__" and sys.argv[1:2] == ["library"]:
    library_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
if __name__ == "__main__" and sys.argv[1:2] == ["jax-fused"]:
    jax_fused_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
if __name__ == "__main__" and sys.argv[1:2] == ["fail"]:
    fail_main()
