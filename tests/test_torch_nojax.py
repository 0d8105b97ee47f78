"""The PyTorch port stands alone: it runs without JAX, PIL, OpenCV, h5py and
the JAX package, and its entry points run on the card unless asked for the CPU.

* In a subprocess that blocks ``jax``, ``PIL``, ``cv2``, ``h5py`` and
  ``building_detection_tpu`` itself, every module of the port imports, and
  ``make_targets``, a ``Pipeline`` over tiny members (fusion and polygons
  included), the geometry on both of its paths, a ``Trainer`` (augmented
  steps, the staged epoch, save and restore), the per-model engine and the
  blocked path, int8 pointwise convs (calibration, fused and per-model),
  ``bdt-convert``'s refusals, a Keras ``.h5`` round trip and a one-member
  ``Pipeline`` from an ``.h5``, ``bdt-client`` against the port's server, and
  the predict, serve and augment CLIs as far as they need no image file,
  and the launcher over two Gloo workers run end to end on the CPU.
* No file of the port, and not ``chip_smoke.py``, imports the JAX package
  or ``h5py`` (an AST scan, which also sees imports inside functions).
* ``Pipeline()``, ``FusedEnsemblePredictor``, ``Trainer``,
  ``TiledPredictor``, ``EnsemblePredictor``, the launcher
  (``parallel/launch.py``) and the predict and serve CLIs with no device
  argument ask for the card, and raise where torch sees none.
"""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
JAX_PACKAGE = "building_detection_tpu"

SCRIPT = textwrap.dedent(
    """
    import sys
    for blocked in ("jax", "jaxlib", "PIL", "cv2", "h5py", "building_detection_tpu"):
        sys.modules[blocked] = None
    import importlib, pkgutil
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import building_detection_tpu_torch as pkg
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)
    from building_detection_tpu_torch.core.config import Config, TilerConfig, TrainConfig
    from building_detection_tpu_torch.core.module import Namer, init_layers
    from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
    from building_detection_tpu_torch.infer.pipeline import Pipeline
    from building_detection_tpu_torch.nn import layers as L
    from building_detection_tpu_torch.post import geometry as G
    from building_detection_tpu_torch.train.trainer import Trainer, make_targets

    labels = torch.zeros(2, 32, 32, dtype=torch.uint8)
    labels[:, 8:20, 8:20] = 255
    y = make_targets(labels)
    assert y.shape == (2, 32, 32, 4) and float(y[..., 2:].max()) == 2.0

    cfg = Config(tiler=TilerConfig(tile=32, stride=24, overlap=8))
    pipe = Pipeline(models=(), cfg=cfg, compute_dtype=torch.float32, device="cpu")
    members = {
        f"m{i}": init_layers(L.Conv2d(Namer(), 3, 2, 3, activation="softmax").eval(), torch.Generator().manual_seed(i))
        for i in range(5)
    }
    pipe.ensemble = FusedEnsemblePredictor(members, cfg.tiler, 4, torch.float32, "cpu")
    img = np.random.RandomState(0).randint(0, 256, (70, 100, 3), np.uint8)
    (res,) = pipe.predict_images([img])
    assert res.masks["m0"].shape == (70, 100) and res.fused.shape == (70, 100)

    square = np.zeros((20, 20), np.uint8)
    square[4:12, 5:15] = 1
    assert G.native() is not None, "the geometry library did not build"
    native = G.find_contours(square)
    G.native.cache_clear()
    G.native = lambda: None
    assert [c.tolist() for c in G.find_contours(square)] == [c.tolist() for c in native]

    import os, tempfile

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            n = Namer()
            self.conv, self.bn = L.Conv2d(n, 3, 4, 3), L.BatchNorm(n, 4)
            self.out = L.Conv2d(n, 4, 2, 1, activation="softmax")

        def forward(self, x):
            return self.out(L.relu(self.bn(self.conv(x))))

    cfg = TrainConfig(batch_size=2, image_size=16, epochs=1, warmup_epochs=0)
    tr = Trainer(Tiny, cfg, steps_per_epoch=2, augment=True, device="cpu")
    imgs = np.random.RandomState(1).randint(0, 256, (4, 16, 16, 3), np.uint8)
    labs = np.where(np.random.RandomState(2).rand(4, 16, 16) < 0.4, 255, 0).astype(np.uint8)
    hist = tr.fit_arrays(imgs, labs, log_fn=lambda s: None)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"]) and tr.step == 2
    with tempfile.TemporaryDirectory() as d:
        tr.save(os.path.join(d, "t.npz"))
        again = Trainer(Tiny, cfg, steps_per_epoch=2, augment=True, seed=1, device="cpu")
        again.restore(os.path.join(d, "t.npz"))
        assert again.step == 2 and again.optimizer.count == 2
    from building_detection_tpu_torch.infer import large_scene as LS
    from building_detection_tpu_torch.infer.engine import EnsemblePredictor, TiledPredictor

    cfg = Config(tiler=TilerConfig(tile=32, stride=24, overlap=8))
    engine = Pipeline(models=(), cfg=cfg, batch_tiles=4, compute_dtype=torch.float32, device="cpu", fused=False,
                      max_scene_tiles=6)
    engine.ensemble = EnsemblePredictor(
        {n: init_layers(L.Conv2d(Namer(), 3, 2, 3, activation="softmax").eval(), torch.Generator().manual_seed(i))
         for i, n in enumerate(["m0", "m1", "m2", "m3", "m4"])},
        cfg.tiler, 4, torch.float32, "cpu",
    )
    big = np.random.RandomState(3).randint(0, 256, (130, 150, 3), np.uint8)
    (blocked, small) = engine.predict_images([big, img])
    assert blocked.fused.shape == (130, 150) and small.fused.shape == (70, 100)
    whole = engine.ensemble.predict_masks(big)
    assert all((blocked.masks[n] == whole[n]).all() for n in whole)
    one = TiledPredictor(init_layers(L.Conv2d(Namer(), 3, 2, 3, activation="softmax").eval(),
                                     torch.Generator().manual_seed(9)), cfg.tiler, 4, torch.float32, "cpu")
    assert (LS.predict_mask_blocked(one, big, max_block_tiles=4) == one.predict_mask(big)).all()

    from building_detection_tpu_torch.cli import augment as augment_cli
    from building_detection_tpu_torch.cli import predict as predict_cli
    from building_detection_tpu_torch.cli import serve as serve_cli
    from building_detection_tpu_torch.serve import server

    with tempfile.TemporaryDirectory() as d:
        for sub in ("img", "lab"):
            os.mkdir(os.path.join(d, sub))
        assert predict_cli.main(["--image-dir", os.path.join(d, "img"), "--out", d, "--device", "cpu"]) == 2
        assert augment_cli.main(["--images", os.path.join(d, "img"), "--labels", os.path.join(d, "lab"),
                                 "--out-images", os.path.join(d, "oi"), "--out-labels", os.path.join(d, "ol"),
                                 "--split-dir", os.path.join(d, "split"), "--seed", "0"]) == 0
        served = []
        server.serve = lambda pipe, cfg, **kw: served.append((pipe, cfg, kw))
        assert serve_cli.main(["--port", "0", "--root-dir", d, "--device", "cpu"]) == 0
        (pipe, cfg, kw), = served
        assert pipe.ensemble.names == ["res34", "hrnet", "v3plus", "scse", "bam"] and kw["port"] == 0

    # int8 pointwise convs: calibration, then the fused and per-model paths
    from building_detection_tpu_torch.infer.pipeline import calibrate_members_int8

    cfg = Config(tiler=TilerConfig(tile=32, stride=24, overlap=8))

    def one_by_one(seed):
        return {f"m{i}": init_layers(L.Conv2d(Namer(), 3, 2, 1, activation="softmax").eval(),
                                     torch.Generator().manual_seed(seed + i)) for i in range(5)}

    scales = calibrate_members_int8(one_by_one(20), [img], cfg, torch.float32, True)
    assert set(scales) == {"m0", "m1", "m2", "m3", "m4"} and all(set(v) == {"conv2d"} for v in scales.values())
    fused = FusedEnsemblePredictor(one_by_one(20), cfg.tiler, 4, torch.float32, "cpu", int8_pointwise=True,
                                   int8_scales=scales)
    per_model = EnsemblePredictor(one_by_one(20), cfg.tiler, 4, torch.float32, "cpu", int8_pointwise=True,
                                  int8_scales=scales)
    a, b = fused.predict_masks(img), per_model.predict_masks(img)
    assert all((a[n] == b[n]).all() for n in a)

    # bdt-convert refuses a wrong-model npz and two files of one kind
    from building_detection_tpu_torch.cli import convert as convert_cli
    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.train.checkpoint import save_variables

    with tempfile.TemporaryDirectory() as d:
        save_variables(os.path.join(d, "tiny.npz"), *jax_variables(Tiny()))
        for argv, said in ((["scse", os.path.join(d, "tiny.npz"), os.path.join(d, "x.h5")], "does not match model"),
                           (["scse", os.path.join(d, "tiny.npz"), os.path.join(d, "y.npz")], "exactly one")):
            try:
                convert_cli.main(argv)
            except SystemExit as e:
                assert said in str(e), e
            else:
                raise AssertionError("bdt-convert took " + " ".join(argv))

    # Keras .h5 with the port's own reader and writer: the small model's round
    # trip, then a one-member Pipeline from an .h5 equal to one from its .npz
    from building_detection_tpu_torch.models.registry import init_model, keras_layer_order
    from building_detection_tpu_torch.train.checkpoint import export_h5_weights, import_h5_weights

    with tempfile.TemporaryDirectory() as d:
        params, state = jax_variables(init_layers(Tiny(), torch.Generator().manual_seed(6)))  # not torch.empty's bits
        zeros = [{k: np.zeros_like(v) for k, v in x.items()} for x in (params, state)]
        export_h5_weights(os.path.join(d, "tiny.h5"), params, state)
        got_p, got_s, report = import_h5_weights(os.path.join(d, "tiny.h5"), *zeros)
        assert report.complete and all((got_p[k] == v).all() for k, v in params.items())
        assert all((got_s[k] == v).all() for k, v in state.items())
        hrnet = jax_variables(init_model("hrnet", torch.Generator().manual_seed(4)))
        export_h5_weights(os.path.join(d, "hrnet.h5"), *hrnet, layer_order=keras_layer_order("hrnet"))
        save_variables(os.path.join(d, "hrnet.npz"), *hrnet)
        small = np.random.RandomState(5).randint(0, 256, (40, 50, 3), np.uint8)
        masks = [Pipeline({"hrnet": os.path.join(d, f)}, cfg=cfg, batch_tiles=4, models=("hrnet",),
                          compute_dtype=torch.float32, device="cpu").ensemble.predict_masks(small)["hrnet"]
                 for f in ("hrnet.h5", "hrnet.npz")]
        assert masks[0].shape == (40, 50) and (masks[0] == masks[1]).all()

    # bdt-client against the port's server on 127.0.0.1 (no PIL here: the
    # upload cannot be decoded, so the answer is NG, which the client reports)
    import threading
    from http.server import ThreadingHTTPServer
    from building_detection_tpu_torch.serve import client

    with tempfile.TemporaryDirectory() as d:
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(server.DetectionService(engine, cfg, root_dir=d)))
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            path = os.path.join(d, "up.png")
            with open(path, "wb") as f:
                f.write(b"not decodable here")
            url = f"http://127.0.0.1:{httpd.server_address[1]}/photo"
            answer = client.detect(path, url=url)
            assert set(answer) == {"status", "data", "points", "error"} and answer["status"] == "NG", answer
            assert client.main([path, "--url", url]) == 1
            assert client.local_client_id("127.0.0.1") == "127_0_0_1"
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    # the launcher: two Gloo CPU workers, rank 0's value back
    import operator
    from building_detection_tpu_torch.parallel.launch import launch
    assert launch(operator.add, 1, 2, local_devices=2, backend="gloo", device_type="cpu") == 3

    for mod in ("jax", "PIL", "cv2", "h5py", "building_detection_tpu"):
        assert sys.modules[mod] is None, mod
    assert not [m for m in sys.modules if m.startswith("building_detection_tpu.")]
    print("NOJAX-OK")
    """
)


def test_port_runs_without_jax_pil_cv2_and_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    done = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert done.returncode == 0, done.stderr[-4000:]
    assert "NOJAX-OK" in done.stdout


def imported_modules(path: Path):
    """Every module name an ``import`` or ``from ... import`` of ``path``
    names, at any depth of the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


PORT_FILES = sorted((REPO / "building_detection_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_of_the_port_imports_the_jax_package(path):
    bad = [m for m in imported_modules(path) if m == JAX_PACKAGE or m.startswith(JAX_PACKAGE + ".")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_of_the_port_imports_h5py(path):
    bad = [m for m in imported_modules(path) if m == "h5py" or m.startswith("h5py.")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_scan_sees_a_jax_package_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from building_detection_tpu.post import geometry\n    import building_detection_tpu\n")
    assert list(imported_modules(probe)) == ["building_detection_tpu.post", "building_detection_tpu"]


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from building_detection_tpu_torch.cli import predict as predict_cli
    from building_detection_tpu_torch.cli import serve as serve_cli
    from building_detection_tpu_torch.infer.engine import EnsemblePredictor, TiledPredictor
    from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
    from building_detection_tpu_torch.infer.pipeline import Pipeline
    from building_detection_tpu_torch.parallel import dryrun
    from building_detection_tpu_torch.parallel.launch import launch
    from building_detection_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: Pipeline(), lambda: FusedEnsemblePredictor({}), lambda: Trainer("res34"),
        lambda: TiledPredictor(torch.nn.Identity()), lambda: EnsemblePredictor({}),
        lambda: predict_cli.main(["--image", str(tmp_path / "x.png"), "--out", str(tmp_path)]),
        lambda: serve_cli.main(["--port", "0", "--root-dir", str(tmp_path)]),
        lambda: dryrun.dryrun_multichip(1), lambda: dryrun.main(["1"]), lambda: launch(print, local_devices=2),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
