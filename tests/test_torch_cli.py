"""PyTorch port, the file entry points: ``Pipeline.predict_file``,
``FusedEnsemblePredictor.predict_vote`` and the ``predict`` and ``serve``
CLIs (``python -m building_detection_tpu_torch.cli.predict|serve``).

``predict_file`` writes the same bytes as the JAX package's and
``predict_vote`` gives the same mask, over the tiny members of
``test_torch_pipeline.py`` (f32, CPU).  The predict CLI runs the five full
members at 32 px through ``--config`` with ``--device cpu``: the contract
files and one JSON line per scene, ``--chunk-scenes`` equal to one chunk,
shards by ``crc32(file name)`` that are disjoint and exhaustive, equal the
single run and stay put when a file is added between two shards' runs, bad
shard arguments exit 2, ``--fast-vote`` is the plain vote of the per-model
masks, and ``--int8`` reaches ``Pipeline`` as the JAX CLI's does.  The
serve CLI's flags, the int8 ones included, map onto ``Pipeline``,
``Config`` and ``ServeConfig`` as the JAX CLI's do, with ``serve`` and
``Pipeline`` stubbed.
"""
import contextlib
import dataclasses
import io
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_detection_tpu.utils import io as jax_uio
from building_detection_tpu_torch.cli import predict as predict_cli
from building_detection_tpu_torch.cli import serve as serve_cli
from building_detection_tpu_torch.core.config import Config, TilerConfig
from building_detection_tpu_torch.infer.fused_ensemble import DEFAULT_BATCH_TILES, FusedEnsemblePredictor
from test_torch_cuda import NAMES, scenes, tiny_members
from test_torch_pipeline import jax_pipeline, port_pipeline

torch.set_num_threads(2)


def listing(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


# -- predict_file and predict_vote -----------------------------------------------
@pytest.mark.parametrize("keep", [False, True], ids=["results_only", "keep_intermediates"])
def test_predict_file_writes_the_jax_bytes(tmp_path, keep):
    (img,) = scenes(7, [(200, 260)])
    path = str(tmp_path / "scene.png")
    jax_uio.imwrite(path, img)
    got = port_pipeline().predict_file(path, str(tmp_path / "port"), keep_intermediates=keep)
    want = jax_pipeline().predict_file(path, str(tmp_path / "jax"), keep_intermediates=keep)
    assert got.corners == want.corners and got.corners
    files = listing(tmp_path / "port")
    names = {"scene_result.png", "scene.txt"} | ({f"{n}_scene.png" for n in NAMES} if keep else set())
    assert set(files) == names
    assert files == listing(tmp_path / "jax")


def test_predict_vote_matches_jax():
    port, jax_pipe = port_pipeline().ensemble, jax_pipeline().ensemble
    for img in scenes(8, [(200, 260), (120, 170), (10, 12)]):
        masks = port.predict_masks(img)
        for threshold in (1, 3, 5):
            got = port.predict_vote(img, threshold)
            np.testing.assert_array_equal(got, jax_pipe.predict_vote(img, threshold))
            votes = sum((masks[n] > 0).astype(int) for n in NAMES)
            np.testing.assert_array_equal(got, np.where(votes >= threshold, 255, 0).astype(np.uint8))


# -- the predict CLI ----------------------------------------------------------------
# crc32 puts a, b, e in shard 1 of 2 and h, x in shard 0; two scenes share a shape
SCENES = {"a": (48, 40), "b": (40, 56), "h": (56, 56), "x": (48, 40), "e": (6, 6)}


def run_predict(argv):
    """(exit code, JSON lines printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = predict_cli.main(argv)
    return rc, [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    """The five full members at 32 px, one process, with intermediates."""
    root = tmp_path_factory.mktemp("predict_cli")
    cfg_path = str(root / "cfg.json")
    Config(tiler=TilerConfig(tile=32, stride=24, overlap=8)).to_json(cfg_path)
    scene_dir = root / "scenes"
    scene_dir.mkdir()
    rng = np.random.RandomState(1)
    for name, shape in SCENES.items():
        jax_uio.imwrite(str(scene_dir / f"{name}.png"), rng.randint(0, 256, shape + (3,), np.uint8))
    base = ["--config", cfg_path, "--batch-tiles", "4", "--precision", "f32", "--device", "cpu"]
    out = str(root / "single")
    rc, lines = run_predict(["--image-dir", str(scene_dir), "--out", out, "--keep-intermediates"] + base)
    assert rc == 0
    return {"root": root, "scenes": str(scene_dir), "base": base, "out": out, "lines": lines}


def results_of(out, names):
    return {n: listing(os.path.join(out, n)) for n in names}


def test_predict_cli_writes_the_contract_files(single_run):
    out, lines = single_run["out"], single_run["lines"]
    assert sorted(os.listdir(out)) == sorted(SCENES)
    assert [os.path.basename(line["image"]) for line in lines] == [f"{n}.png" for n in sorted(SCENES)]
    for line in lines:
        name = os.path.splitext(os.path.basename(line["image"]))[0]
        files = set(os.listdir(os.path.join(out, name)))
        assert files == {f"{name}_result.png", f"{name}.txt"} | {f"{m}_{name}.png" for m in
                                                                  ("res34", "hrnet", "v3plus", "scse", "bam")}
        assert line["result"] == os.path.join(out, name, f"{name}_result.png")
        with open(line["points"]) as f:
            assert len(f.read().splitlines()) == line["num_buildings"]
        mask = jax_uio.imread_gray(line["result"])
        assert mask.shape == SCENES[name] and set(np.unique(mask)) <= {0, 255}
    assert not jax_uio.imread_gray(os.path.join(out, "e", "e_result.png")).any()  # no tile: blank


def test_predict_cli_chunks_equal_one_chunk(single_run, tmp_path):
    out = str(tmp_path / "chunked")
    rc, lines = run_predict(["--image-dir", single_run["scenes"], "--out", out, "--chunk-scenes", "2",
                             "--keep-intermediates"] + single_run["base"])
    assert rc == 0 and len(lines) == len(SCENES)
    assert results_of(out, SCENES) == results_of(single_run["out"], SCENES)


def test_predict_cli_shards_are_stable_disjoint_and_exhaustive(single_run, tmp_path):
    """Two shards by crc32 of the file name cover every scene once, equal
    the single run, and a file added between the two shards' runs moves no
    other file (a round robin over the sorted listing would move them all)."""
    scene_dir = tmp_path / "scenes"
    shutil.copytree(single_run["scenes"], scene_dir)
    shard = {n: predict_cli.shard_of(f"{n}.png", 2) for n in SCENES}
    assert set(shard.values()) == {0, 1}  # both shards have work
    fleet = str(tmp_path / "fleet")
    args = ["--image-dir", str(scene_dir), "--out", fleet, "--num-processes", "2", "--keep-intermediates"]
    rc0, lines0 = run_predict(args + ["--process-id", "0"] + single_run["base"])
    # a new file that sorts first: it shifts every position in the listing
    jax_uio.imwrite(str(scene_dir / "0new.png"), np.random.RandomState(5).randint(0, 256, (40, 40, 3), np.uint8))
    rc1, lines1 = run_predict(args + ["--process-id", "1"] + single_run["base"])
    assert rc0 == rc1 == 0
    done = [[os.path.splitext(os.path.basename(line["image"]))[0] for line in lines] for lines in (lines0, lines1)]
    assert not set(done[0]) & set(done[1])
    assert set(done[0]) == {n for n in SCENES if shard[n] == 0}
    assert set(done[1]) == {n for n in SCENES if shard[n] == 1} | (
        {"0new"} if predict_cli.shard_of("0new.png", 2) == 1 else set())
    assert results_of(fleet, SCENES) == results_of(single_run["out"], SCENES)
    before = sorted(SCENES)
    after = sorted(list(SCENES) + ["0new"])
    assert any(before.index(n) % 2 != after.index(n) % 2 for n in SCENES)


@pytest.mark.parametrize(
    "extra",
    [["--num-processes", "2", "--process-id", "2"], ["--num-processes", "0"],
     ["--num-processes", "2", "--process-id", "-1"]],
    ids=["id_past_the_end", "no_processes", "negative_id"],
)
def test_predict_cli_bad_shard_exits_2(single_run, tmp_path, extra):
    rc, lines = run_predict(["--image-dir", single_run["scenes"], "--out", str(tmp_path / "o")] + extra
                            + single_run["base"])
    assert rc == 2 and not lines and not os.path.exists(tmp_path / "o")


def test_predict_cli_single_image_cannot_shard_and_empty_shard_is_a_no_op(single_run, tmp_path):
    image = os.path.join(single_run["scenes"], "a.png")
    rc, _ = run_predict(["--image", image, "--out", str(tmp_path / "o"), "--num-processes", "2"]
                        + single_run["base"])
    assert rc == 2
    one = tmp_path / "one"
    one.mkdir()
    shutil.copy(image, one)
    other = 1 - predict_cli.shard_of("a.png", 2)
    rc, lines = run_predict(["--image-dir", str(one), "--out", str(tmp_path / "o"), "--num-processes", "2",
                             "--process-id", str(other)] + single_run["base"])
    assert rc == 0 and not lines


def test_predict_cli_fast_vote_is_the_plain_vote(single_run, tmp_path):
    out = str(tmp_path / "vote")
    rc, lines = run_predict(["--image-dir", single_run["scenes"], "--out", out, "--fast-vote"] + single_run["base"])
    assert rc == 0 and len(lines) == len(SCENES)
    for name in SCENES:
        assert sorted(os.listdir(os.path.join(out, name))) == sorted([f"{name}_result.png", f"{name}.txt"])
        masks = [jax_uio.imread_gray(os.path.join(single_run["out"], name, f"{m}_{name}.png"))
                 for m in ("res34", "hrnet", "v3plus", "scse", "bam")]
        votes = sum((m > 0).astype(int) for m in masks)
        np.testing.assert_array_equal(
            jax_uio.imread_gray(os.path.join(out, name, f"{name}_result.png")),
            np.where(votes >= 3, 255, 0).astype(np.uint8),
        )


class _Stop(Exception):
    pass


def predict_calls(monkeypatch, tmp_path, extra):
    """(port, JAX) ``Pipeline`` kwargs of one predict CLI run over three
    scenes, ``Pipeline`` stubbed to stop the run once called."""
    import importlib

    img_dir = tmp_path / "int8_scenes"
    if not img_dir.exists():
        img_dir.mkdir()
        for i, img in enumerate(scenes(40, [(40, 50), (60, 30), (40, 50)])):
            jax_uio.imwrite(str(img_dir / f"s{i}.png"), img)
    monkeypatch.setattr(importlib.import_module("building_detection_tpu.core.runtime"),
                        "enable_compilation_cache", lambda *a, **k: None)
    calls = {}
    for package, device in (("building_detection_tpu_torch", ["--device", "cpu"]), ("building_detection_tpu", [])):
        def record(_package=package, **kwargs):
            calls[_package] = kwargs
            raise _Stop

        monkeypatch.setattr(importlib.import_module(f"{package}.infer.pipeline"), "Pipeline", record)
        with pytest.raises(_Stop):
            importlib.import_module(f"{package}.cli.predict").main(
                ["--image-dir", str(img_dir), "--out", str(tmp_path / "out")] + extra + device)
    return calls["building_detection_tpu_torch"], calls["building_detection_tpu"]


def test_predict_cli_refuses_int8(tmp_path, monkeypatch):
    """``--int8`` is ported: the first two scenes of the shard calibrate,
    ``int8_pointwise=512``, as in the JAX CLI."""
    got, want = predict_calls(monkeypatch, tmp_path, ["--int8"])
    assert got["int8_pointwise"] == want["int8_pointwise"] == 512
    assert len(got["int8_calibration"]) == len(want["int8_calibration"]) == 2
    for a, b in zip(got["int8_calibration"], want["int8_calibration"]):
        np.testing.assert_array_equal(a, b)
    got, want = predict_calls(monkeypatch, tmp_path, [])
    assert got["int8_pointwise"] is want["int8_pointwise"] is False
    assert got["int8_calibration"] is want["int8_calibration"] is None


# -- the serve CLI ----------------------------------------------------------------------
class Recorder:
    """Stands in for ``Pipeline``: records its keyword arguments."""

    calls = []

    def __init__(self, **kwargs):
        Recorder.calls.append(kwargs)


def serve_calls(monkeypatch, package, argv):
    """(Pipeline kwargs, serve args and kwargs) of one ``main(argv)``."""
    import importlib

    served = []
    monkeypatch.setattr(importlib.import_module(f"{package}.serve.server"), "serve",
                        lambda *a, **k: served.append((a, k)))
    monkeypatch.setattr(importlib.import_module(f"{package}.infer.pipeline"), "Pipeline", Recorder)
    if package == "building_detection_tpu":
        monkeypatch.setattr(importlib.import_module("building_detection_tpu.core.runtime"),
                            "enable_compilation_cache", lambda *a, **k: None)
    Recorder.calls = []
    assert importlib.import_module(f"{package}.cli.serve").main(argv) == 0
    (kwargs,), (call,) = Recorder.calls, served
    return kwargs, call


@pytest.mark.parametrize(
    "argv",
    [[], ["--no-bucket"], ["--drain-timeout", "5"],
     ["--precision", "f32", "--batch-tiles", "4", "--port", "0", "--host", "127.0.0.1", "--root-dir", "srv"]],
    ids=["defaults", "no_bucket", "drain_timeout", "f32_port0"],
)
def test_serve_cli_maps_flags_like_jax(monkeypatch, tmp_path, argv):
    (tmp_path / "w").mkdir()
    (tmp_path / "w" / "scse.npz").write_bytes(b"")
    argv = argv + ["--weights-dir", str(tmp_path / "w")]
    got, (got_args, got_kw) = serve_calls(monkeypatch, "building_detection_tpu_torch", argv + ["--device", "cpu"])
    want, (want_args, want_kw) = serve_calls(monkeypatch, "building_detection_tpu", argv)
    assert got["weights"] == want["weights"] == {"scse": str(tmp_path / "w" / "scse.npz")}
    assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(want["cfg"])
    assert got["cfg"].tiler.bucket_sizes is ("--no-bucket" not in argv)
    assert str(got["compute_dtype"]).split(".")[-1] == jnp.dtype(want["compute_dtype"]).name
    # the batch default is the card's sweep, not the TPU's 8
    assert got["batch_tiles"] == (want["batch_tiles"] if "--batch-tiles" in argv else DEFAULT_BATCH_TILES)
    assert got["device"] == "cpu"
    # serve(pipeline, cfg, root_dir=, host=, port=)
    assert isinstance(got_args[0], Recorder) and len(got_args) == len(want_args) == 2
    assert dataclasses.asdict(got_args[1]) == dataclasses.asdict(want_args[1])
    assert got_kw == want_kw


@pytest.mark.parametrize("flag", [["--int8"], ["--int8-scales", "s.json"], ["--int8-calibration-dir", "d"]],
                         ids=["int8", "int8_scales", "int8_calibration_dir"])
def test_serve_cli_refuses_int8(flag, monkeypatch, tmp_path):
    """The int8 flags are ported and reach ``Pipeline`` as in the JAX CLI:
    alone, ``--int8`` serves with dynamic scales; with it, a scales file
    (either package's JSON) or the first four images of a directory."""
    scales = {"bam": {"separable_conv2d_20": 2.5}}
    (tmp_path / "s.json").write_text(json.dumps(scales))
    (tmp_path / "d").mkdir()
    for i, (img,) in enumerate(scenes(30 + i, [(40, 50)]) for i in range(5)):
        jax_uio.imwrite(str(tmp_path / "d" / f"c{i}.png"), img)
    argv = [a if a == flag[0] else str(tmp_path / a) for a in flag]
    for argv in (argv, ["--int8"] + argv if flag[0] != "--int8" else argv):
        got, _ = serve_calls(monkeypatch, "building_detection_tpu_torch", argv + ["--device", "cpu"])
        want, _ = serve_calls(monkeypatch, "building_detection_tpu", argv)
        assert got["int8_pointwise"] == want["int8_pointwise"]
        assert got["int8_scales"] == want["int8_scales"]
        assert (got["int8_calibration"] is None) == (want["int8_calibration"] is None)
        for a, b in zip(got["int8_calibration"] or [], want["int8_calibration"] or []):
            np.testing.assert_array_equal(a, b)
    assert got["int8_pointwise"] == 512
    assert got["int8_scales"] == (scales if "--int8-scales" in flag else None)
    assert len(got["int8_calibration"] or []) == (4 if "--int8-calibration-dir" in flag else 0)


def test_fused_predictor_vote_default_is_three_of_five():
    fused = FusedEnsemblePredictor(tiny_members(), TilerConfig(tile=32, stride=24, overlap=8), 4, torch.float32, "cpu")
    (img,) = scenes(9, [(70, 90)])
    masks = fused.predict_masks(img)
    votes = sum((masks[n] > 0).astype(int) for n in NAMES)
    np.testing.assert_array_equal(fused.predict_vote(img), np.where(votes >= 3, 255, 0).astype(np.uint8))


# -- console scripts ----------------------------------------------------------------
JAX_SCRIPTS = {
    "bdt-predict": "building_detection_tpu.cli.predict:main",
    "bdt-train": "building_detection_tpu.cli.train:main",
    "bdt-eval": "building_detection_tpu.cli.evaluate:main",
    "bdt-augment": "building_detection_tpu.cli.augment:main",
    "bdt-serve": "building_detection_tpu.cli.serve:main",
    "bdt-convert": "building_detection_tpu.cli.convert:main",
    "bdt-client": "building_detection_tpu.serve.client:main",
}


def project_scripts():
    import tomllib

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


@pytest.mark.parametrize("jax_name", sorted(JAX_SCRIPTS))
def test_console_script_resolves_to_the_ports_main(jax_name):
    """``bdt-torch-X`` names the port's counterpart of ``bdt-X``'s module,
    and resolves to that module's ``main``."""
    import importlib

    name = jax_name.replace("bdt-", "bdt-torch-", 1)
    target = project_scripts()[name]
    assert target == JAX_SCRIPTS[jax_name].replace("building_detection_tpu.", "building_detection_tpu_torch.", 1)
    module, attr = target.split(":")
    main = getattr(importlib.import_module(module), attr)
    assert callable(main) and main.__module__ == module


def test_jax_console_scripts_are_unchanged():
    scripts = project_scripts()
    assert {k: v for k, v in scripts.items() if not k.startswith("bdt-torch-")} == JAX_SCRIPTS
    assert len(scripts) == 2 * len(JAX_SCRIPTS)
