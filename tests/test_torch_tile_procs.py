"""PyTorch port, the per-model predictor over a mesh that spans processes:
``TiledPredictor`` with tile data parallelism and with channel TP across
workers started by ``parallel/launch.py``, held against the JAX package's
``TiledPredictor`` in two processes.

* The JAX package: two processes of two virtual CPU devices each, joined by
  ``jax.distributed`` (``tests/test_torch_hybrid.py::jax_fused_main``'s
  pattern), run its ``TiledPredictor`` over the global mesh at ``data=4``,
  ``data=2 x model=2, tp=True`` and ``data=1 x model=4, tp=True``, in f32,
  on ``tests/test_engine.py::tiny_model`` with the weights of
  ``jax.random.key(1)``, over a non-square multi-tile scene, a square one
  and a degenerate one, plain and bucketed; each process returns every
  mask, equal to the JAX package's one-device predictor.
* The port: two launcher processes of two Gloo workers each, in the same
  layouts, on the same weights (the weight bridge): every rank's masks are
  bit-equal to every other rank's, to both JAX processes' and to the port's
  one-process ``TiledPredictor`` on ``"cpu"``.  Every non-blank mask is
  5-95 % foreground, so an all-ones or all-zeros forward cannot pass.
* Every layer class: ``LayerZoo`` (``tests/test_torch_distributed.py``)
  under ``tp=True`` over two Gloo workers at ``data=1 x model=2``, in f32
  and with int8 pointwise convs: the softmax within 1e-5 of one process,
  its argmax and the mask equal, and each rank's sharded layers those of
  the one-process TP replica.
* The refusals that stay: ``Pipeline(fused=False, mesh=)`` and
  ``mesh_devices`` over a mesh that spans processes.

No process group is started in the pytest process: the JAX processes and
the launchers are children (``parallel.dryrun.run_processes``), and this
file, run as a script, is their program:

    python tests/test_torch_tile_procs.py jax PROCESS_ID PORT OUTDIR
    python tests/test_torch_tile_procs.py port PROCESS_ID PORT OUTDIR
    python tests/test_torch_tile_procs.py zoo OUTDIR
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu_torch.parallel import dryrun

torch.set_num_threads(2)

HERE = os.path.abspath(__file__)
K = 2  # workers a launcher process
PROCESSES = 2
TIMEOUT = 300
CHILD_ENV = {"OMP_NUM_THREADS": "1"}
LAYOUTS = {"data4": (4, 1, False), "2x2_tp": (2, 2, True), "1x4_tp": (1, 4, True)}
BATCH_TILES = 2  # a data row's tiles a forward: chunks of 8, 4 and 2 tiles
# 6 tiles of 32 at stride 24 (a chunk that data=4 splits only once padded), 4 tiles, none
SHAPES = [(56, 80), (56, 56), (6, 6)]
SCENE_SEED = 12
WEIGHT_KEY = 1  # test_engine.tiny_model's weights from jax.random.key(1): masks 5-95 % foreground
ZOO_TILES = 5


def tilers():
    from building_detection_tpu_torch.core.config import TilerConfig

    plain = TilerConfig(tile=32, stride=24, overlap=8)
    return {"plain": plain, "bucketed": dataclasses.replace(plain, bucket_sizes=True)}


def scenes():
    rng = np.random.RandomState(SCENE_SEED)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in SHAPES]


def zoo_tiles():
    return torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (ZOO_TILES, 32, 32, 3)).astype(np.float32))


class EngineTiny(nn.Module):
    """``tests/test_engine.py::tiny_model`` in the port
    (``test_torch_engine.EngineTiny``; that module imports JAX, the launched
    workers do not)."""

    def __init__(self):
        super().__init__()
        from building_detection_tpu_torch.core.module import Namer
        from building_detection_tpu_torch.nn import layers as L

        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 8, 3, strides=2, activation="relu")
        self.up = L.Conv2dTranspose(n, 8, 8, 2, strides=2, activation="relu")
        self.conv2 = L.Conv2d(n, 8, 2, 3, activation="softmax")

    def forward(self, x):
        return self.conv2(self.up(self.conv1(x)))


def load_model(model: nn.Module, path: str) -> nn.Module:
    """``model`` with the JAX-format variables of ``path`` (``p/...``, ``s/...``)."""
    from building_detection_tpu_torch.core.module import load_jax_variables

    with np.load(path) as z:
        return load_jax_variables(model.eval(), {k[2:]: z[k] for k in z.files if k.startswith("p/")},
                                  {k[2:]: z[k] for k in z.files if k.startswith("s/")})


def save_variables(path, params, state):
    np.savez(path, **{f"p/{k}": np.asarray(v) for k, v in params.items()},
             **{f"s/{k}": np.asarray(v) for k, v in state.items()})


def run_children(argvs, cwd):
    return dryrun.run_processes(argvs, dryrun.port_env(CHILD_ENV), TIMEOUT, cwd=str(cwd))


def assert_all_ok(results, what):
    for i, (rc, out) in enumerate(results):
        assert rc == 0, f"{what}: process {i} exited {rc}:\n{out[-6000:]}"


def sharded_layers(model: nn.Module) -> list:
    return sorted(n for n, m in model.named_modules() if getattr(m, "tp", None))


# -- the launched workers ------------------------------------------------------------------
def port_worker(outdir: str) -> int:
    """One worker: the port's ``TiledPredictor`` over ``make_mesh(data,
    model)`` of the four ranks in every layout and tiler, on
    ``outdir/tiny.npz``; writes ``masks{rank}.npz`` and ``rank{rank}.json``."""
    import torch.distributed as dist

    from building_detection_tpu_torch.infer.engine import TiledPredictor
    from building_detection_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    rank = dist.get_rank()
    masks, info = {}, {"rank": rank, "layouts": {}}
    for name, (data, model, tp) in LAYOUTS.items():
        mesh = make_mesh(data=data, model=model)
        for tiler, cfg in tilers().items():
            pred = TiledPredictor(load_model(EngineTiny(), os.path.join(outdir, "tiny.npz")), cfg, BATCH_TILES,
                                  torch.float32, "cpu", mesh=mesh, tp=tp)
            for i, img in enumerate(scenes()):
                masks[f"{name}/{tiler}/{i}"] = pred.predict_mask(img)
        info["layouts"][name] = {"data_index": mesh.data_index, "model_index": mesh.model_index, "tp": pred.tp,
                                 "batch_tiles": pred.batch_tiles, "device": str(pred.device),
                                 "stages": len(pred._stages), "sharded": sharded_layers(pred.model),
                                 "kernel": list(pred.model.conv1.kernel.shape)}
    np.savez(os.path.join(outdir, f"masks{rank}.npz"), **masks)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    return rank


def zoo_worker(outdir: str) -> int:
    """One of two workers: ``LayerZoo`` from ``outdir/zoo.npz`` under
    ``TiledPredictor(tp=True)`` at ``data=1 x model=2``, in f32 and int8;
    writes its softmax of :func:`zoo_tiles`, its mask and its sharded
    layers to ``zoo{rank}_{kind}.npz`` / ``.json``."""
    import torch.distributed as dist

    from building_detection_tpu_torch.infer.engine import TiledPredictor
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from test_torch_distributed import LayerZoo

    torch.set_num_threads(1)  # after the import: that module sets two
    rank = dist.get_rank()
    mesh = make_mesh(data=1, model=2)
    img = np.random.RandomState(4).randint(0, 256, (70, 90, 3), np.uint8)
    for kind, int8 in (("f32", False), ("int8", True)):
        pred = TiledPredictor(load_model(LayerZoo(), os.path.join(outdir, "zoo.npz")), tilers()["plain"], 4,
                              torch.float32, "cpu", mesh=mesh, tp=True, int8_pointwise=int8)
        with torch.inference_mode():
            probs = pred.model(zoo_tiles()).numpy()
        np.savez(os.path.join(outdir, f"zoo{rank}_{kind}.npz"), probs=probs, mask=pred.predict_mask(img))
        with open(os.path.join(outdir, f"zoo{rank}_{kind}.json"), "w") as f:
            json.dump({"sharded": sharded_layers(pred.model), "kernel": list(pred.model.conv.kernel.shape)}, f)
    return rank


def port_main(pid: int, port: int, outdir: str) -> None:
    from building_detection_tpu_torch.parallel.launch import launch

    first = launch(port_worker, outdir, local_devices=K, coordinator=f"127.0.0.1:{port}", num_processes=PROCESSES,
                   process_id=pid, backend="gloo", device_type="cpu")
    print(f"launcher {pid}: first worker returned {first}", flush=True)


def zoo_main(outdir: str) -> None:
    from building_detection_tpu_torch.parallel.launch import launch

    launch(zoo_worker, outdir, local_devices=2, backend="gloo", device_type="cpu")


def jax_main(pid: int, port: int, outdir: str) -> None:
    """One JAX process of two virtual CPU devices: the JAX package's
    ``TiledPredictor`` over the global mesh in every layout and tiler, its
    masks written to ``outdir/jax_masks{pid}.npz``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from building_detection_tpu.core import module as M
    from building_detection_tpu.core.config import TilerConfig as JaxTilerConfig
    from building_detection_tpu.infer.engine import TiledPredictor as JaxTiled
    from building_detection_tpu.parallel import distributed as jdist
    from building_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from test_engine import tiny_model

    jdist.init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=PROCESSES, process_id=pid)
    assert jax.process_count() == PROCESSES and jax.device_count() == 2 * PROCESSES
    params, state = M.init(tiny_model, jax.random.key(WEIGHT_KEY), jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    plain = JaxTilerConfig(tile=32, stride=24, overlap=8)
    cfgs = {"plain": plain, "bucketed": dataclasses.replace(plain, bucket_sizes=True)}
    masks = {}
    for name, (data, model, tp) in LAYOUTS.items():
        mesh = jax_make_mesh(data=data, model=model)
        for tiler, cfg in cfgs.items():
            pred = JaxTiled(tiny_model, params, state, cfg, batch_tiles=BATCH_TILES, compute_dtype=jnp.float32,
                            mesh=mesh, tp=tp)
            for i, img in enumerate(scenes()):
                masks[f"{name}/{tiler}/{i}"] = np.asarray(pred.predict_mask(img))
    np.savez(os.path.join(outdir, f"jax_masks{pid}.npz"), **masks)
    print(f"jax process {pid}: {len(masks)} masks", flush=True)


# -- fixtures ------------------------------------------------------------------------------
def load_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The weights (``tiny.npz``, ``zoo.npz``), then side by side the two
    JAX processes, the two port launchers of two workers and the zoo's
    launcher of two; returns (outdir, the JAX masks a process, the port's
    masks and info a rank, the one-device masks of each package)."""
    import jax
    import jax.numpy as jnp

    from building_detection_tpu.core import module as M
    from building_detection_tpu.core.config import TilerConfig as JaxTilerConfig
    from building_detection_tpu.infer.engine import TiledPredictor as JaxTiled
    from building_detection_tpu_torch.core.module import jax_variables
    from building_detection_tpu_torch.infer.engine import TiledPredictor
    from test_engine import tiny_model
    from test_torch_tp import zoo

    out = tmp_path_factory.mktemp("tile_procs")
    params, state = M.init(tiny_model, jax.random.key(WEIGHT_KEY), jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))
    save_variables(out / "tiny.npz", jax.device_get(params), jax.device_get(state))
    save_variables(out / "zoo.npz", *jax_variables(zoo()))
    jax_port, port_port = dryrun.free_port(), dryrun.free_port()
    argvs = [[sys.executable, HERE, "jax", str(p), str(jax_port), str(out)] for p in range(PROCESSES)]
    argvs += [[sys.executable, HERE, "port", str(p), str(port_port), str(out)] for p in range(PROCESSES)]
    argvs += [[sys.executable, HERE, "zoo", str(out)]]
    results = run_children(argvs, out)
    assert_all_ok(results, "JAX processes, port launchers, zoo launcher")
    for p in range(PROCESSES):
        assert f"launcher {p}: first worker returned {p * K}" in results[PROCESSES + p][1], results[PROCESSES + p][1]

    imgs = scenes()
    jcfg = JaxTilerConfig(tile=32, stride=24, overlap=8)
    one = {"jax": {}, "port": {}}
    for tiler, cfg in tilers().items():
        jax_one = JaxTiled(tiny_model, params, state, dataclasses.replace(jcfg, bucket_sizes=cfg.bucket_sizes),
                           batch_tiles=BATCH_TILES, compute_dtype=jnp.float32)
        port_one = TiledPredictor(load_model(EngineTiny(), str(out / "tiny.npz")), cfg, BATCH_TILES, torch.float32,
                                  "cpu")
        for i, img in enumerate(imgs):
            one["jax"][f"{tiler}/{i}"] = np.asarray(jax_one.predict_mask(img))
            one["port"][f"{tiler}/{i}"] = port_one.predict_mask(img)
    jax_masks = [load_npz(out / f"jax_masks{p}.npz") for p in range(PROCESSES)]
    port_masks = [load_npz(out / f"masks{r}.npz") for r in range(PROCESSES * K)]
    infos = []
    for r in range(PROCESSES * K):
        with open(out / f"rank{r}.json") as f:
            infos.append(json.load(f))
    return out, jax_masks, port_masks, infos, one


def test_one_device_masks_mix_and_packages_agree(runs):
    """The reference the layouts are held to: the one-device masks of the
    two packages are equal, blank on the degenerate scene and 5-95 %
    foreground on the others."""
    *_, one = runs
    assert sorted(one["jax"]) == sorted(one["port"]) and len(one["jax"]) == len(tilers()) * len(SHAPES)
    for key, want in one["jax"].items():
        np.testing.assert_array_equal(one["port"][key], want, err_msg=key)
        i = int(key.rsplit("/", 1)[1])
        assert want.shape == SHAPES[i] and set(np.unique(want)) <= {0, 255}
        if SHAPES[i] == (6, 6):
            assert not want.any(), key
        else:
            assert 0.05 <= float((want > 0).mean()) <= 0.95, (key, float((want > 0).mean()))


def test_jax_tiled_predictor_returns_every_mask_on_both_processes(runs):
    _, jax_masks, _, _, one = runs
    for p, masks in enumerate(jax_masks):
        assert sorted(masks) == sorted(f"{name}/{key}" for name in LAYOUTS for key in one["jax"])
        for key, got in masks.items():
            np.testing.assert_array_equal(got, one["jax"][key.split("/", 1)[1]], err_msg=f"JAX process {p}: {key}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_ranks_match_each_other_jax_and_one_process(runs, layout):
    _, jax_masks, port_masks, infos, one = runs
    data, model, tp = LAYOUTS[layout]
    for r, info in enumerate(infos):
        got = info["layouts"][layout]
        assert (got["data_index"], got["model_index"]) == (r // model, r % model)
        assert got["tp"] == tp and got["batch_tiles"] == BATCH_TILES * data and got["device"] == "cpu"
        assert got["stages"] == (2 if model > 1 else 1)  # model index 0's bits broadcast over the model group
        assert got["kernel"][0] == 8 // model if tp else got["kernel"][0] == 8  # the rank's out-channel slice
        assert got["sharded"] == (sorted(["conv1", "up"] + (["conv2"] if model == 2 else [])) if tp else [])
    for key in one["port"]:
        want = one["port"][key]
        for r, masks in enumerate(port_masks):
            np.testing.assert_array_equal(masks[f"{layout}/{key}"], want, err_msg=f"port rank {r}: {layout}/{key}")
        for p, masks in enumerate(jax_masks):
            np.testing.assert_array_equal(masks[f"{layout}/{key}"], want, err_msg=f"JAX process {p}: {layout}/{key}")


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_every_layer_class_under_process_tp_matches_one_process(runs, kind):
    from building_detection_tpu_torch.infer.engine import TiledPredictor
    from building_detection_tpu_torch.parallel import mesh as pmesh
    from test_torch_distributed import LayerZoo

    out, *_ = runs
    int8 = kind == "int8"
    cfg = tilers()["plain"]
    single = TiledPredictor(load_model(LayerZoo(), str(out / "zoo.npz")), cfg, 4, torch.float32, "cpu",
                            int8_pointwise=int8)
    local_tp = TiledPredictor(load_model(LayerZoo(), str(out / "zoo.npz")), cfg, 4, torch.float32, tp=True,
                              mesh=pmesh.make_mesh(devices=["cpu", "cpu"], data=1, model=2), int8_pointwise=int8)
    with torch.inference_mode():
        want = single.model(zoo_tiles()).numpy()
    img = np.random.RandomState(4).randint(0, 256, (70, 90, 3), np.uint8)
    want_mask = single.predict_mask(img)
    want_sharded = sharded_layers(local_tp.replicas[torch.device("cpu")])
    assert "odd" in want_sharded and "head" in want_sharded and "gate" not in want_sharded  # sharded at model=2 only
    for r in range(2):
        got = load_npz(out / f"zoo{r}_{kind}.npz")
        with open(out / f"zoo{r}_{kind}.json") as f:
            info = json.load(f)
        assert info["sharded"] == want_sharded and info["kernel"][0] == 8 // 2, (r, info)
        np.testing.assert_allclose(got["probs"], want, atol=1e-5, rtol=0, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["probs"].argmax(-1), want.argmax(-1), err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["mask"], want_mask, err_msg=f"rank {r}")


def test_refusals_over_a_mesh_that_spans_processes_stay():
    """The per-model ``Pipeline`` takes no mesh (the JAX package drops it),
    and a spanning mesh has no list of devices: each message names what
    runs instead."""
    from building_detection_tpu_torch.core.config import Config
    from building_detection_tpu_torch.infer.pipeline import Pipeline
    from building_detection_tpu_torch.parallel import mesh as pmesh

    spans = pmesh.Mesh(2, 1, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"needs fused=True.*TiledPredictor\(model, mesh="):
        Pipeline(cfg=Config(), fused=False, mesh=spans, models=("scse",), device="cpu")
    with pytest.raises(NotImplementedError, match=r"spans 2 processes.*rank_device\(mesh\).*TiledPredictor"):
        pmesh.mesh_devices(spans)


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    jax_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
if __name__ == "__main__" and sys.argv[1:2] == ["port"]:
    port_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
if __name__ == "__main__" and sys.argv[1:2] == ["zoo"]:
    zoo_main(sys.argv[2])
