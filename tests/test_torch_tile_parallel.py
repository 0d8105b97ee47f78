"""PyTorch port, inference over several devices in one process, held against
the JAX package on its meshes of the suite's virtual CPU devices.

The port's mesh of local devices is ``make_mesh(devices=["cpu"] * k)``: on
one CPU every entry is one shard of the tile batch and the entries share
one replica of each member, so the split, the padding of a short chunk and
the gather back run as they do over ``k`` cards.  In f32, bit for bit, at
k = 2 and 8 against the port on one device and the JAX package on
``make_mesh(data=k)``:

* ``FusedEnsemblePredictor(mesh=)``: ``predict_masks``,
  ``predict_masks_many`` and ``predict_vote``, tile counts that the shards
  do not divide, int8 options on the replicas;
* ``TiledPredictor(mesh=)``, including a last chunk the shards do not
  divide;
* ``EnsemblePredictor(devices=)``: round-robin placement, one upload per
  distinct device (the port of ``tests/test_parallel.py::
  TestEnsembleSharedUpload::test_one_upload_per_device``);
* ``Pipeline(mesh=)`` built through its constructor, over a scene that
  takes the blocked path and one that does not.

And the refusals: a mesh with a ``model`` axis on the fused path
(``ValueError``, the JAX package's words; ``TiledPredictor`` runs one, and
``test_torch_tp.py`` holds channel TP), ``Pipeline(fused=False, mesh=)``,
``Trainer`` over a mesh of local devices, a mesh under a process group of
several ranks, a card index past the cards visible.  The tiny members are ``test_torch_cuda.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_detection_tpu.core.config import Config as JaxConfig
from building_detection_tpu.core.config import TilerConfig as JaxTilerConfig
from building_detection_tpu.infer.engine import EnsemblePredictor as JaxEnsemble
from building_detection_tpu.infer.engine import TiledPredictor as JaxTiled
from building_detection_tpu.infer.fused_ensemble import FusedEnsemblePredictor as JaxFused
from building_detection_tpu.infer.pipeline import Pipeline as JaxPipeline
from building_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from building_detection_tpu_torch.core.config import Config, TilerConfig
from building_detection_tpu_torch.core.device import check_device
from building_detection_tpu_torch.core.module import load_jax_variables
from building_detection_tpu_torch.infer import pipeline as port_pipeline_module
from building_detection_tpu_torch.infer.engine import EnsemblePredictor, TiledPredictor
from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor, shard_forward
from building_detection_tpu_torch.infer.pipeline import Pipeline
from building_detection_tpu_torch.parallel import mesh as pmesh
from building_detection_tpu_torch.train.trainer import Trainer
from test_engine import tiny_model
from test_torch_cuda import NAMES, TinyMember, scenes, tiny_members, tiny_variables
from test_torch_engine import jax_variables_np, port_model
from test_torch_pipeline import tiny_member
from test_torch_train import TorchTiny

torch.set_num_threads(2)

CFG = TilerConfig(tile=32, stride=24, overlap=8)
JCFG = JaxTilerConfig(tile=32, stride=24, overlap=8)
SHARDS = [2, 8]
# tiles per scene at tile 32, stride 24: 4, 8, 35 (divides by neither 2 nor 8), 0
SHAPES = [(56, 56), (40, 81), (120, 170), (6, 6)]


def cpu_mesh(k):
    return pmesh.make_mesh(devices=["cpu"] * k)


def jax_members():
    return {n: (tiny_member, *tiny_variables(i)) for i, n in enumerate(NAMES)}


def assert_masks_equal(got, *wants):
    for want in wants:
        assert list(got) == list(want)
        for n in got:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)


# -- the mesh ---------------------------------------------------------------------
def test_make_mesh_over_local_devices():
    mesh = pmesh.make_mesh(devices=["cpu", "cpu", "cpu"])
    assert (mesh.data, mesh.model, mesh.rank, mesh.world_size, mesh.group) == (3, 1, 0, 1, None)
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.device == torch.device("cpu")
    assert mesh.shape == {"data": 3, "model": 1}
    assert pmesh.make_mesh(data=3, devices=["cpu"] * 3) == mesh
    with pytest.raises(ValueError, match="data must equal their number"):
        pmesh.make_mesh(data=2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="names no device"):
        pmesh.make_mesh(devices=[])
    # a training process's mesh keeps one entry, as before
    assert pmesh.make_mesh().devices == (None,)
    assert pmesh.make_mesh(devices="cpu").devices == (torch.device("cpu"),)
    assert pmesh.Mesh(2, 1, 1, 2).devices == (None,)
    assert pmesh.predictor_devices(mesh) == mesh.devices
    assert pmesh.predictor_devices(None, "cpu") == (torch.device("cpu"),)
    assert pmesh.predictor_devices(pmesh.make_mesh(), "cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="pass device=None"):
        pmesh.predictor_devices(mesh, "cpu")


def test_several_local_devices_under_a_process_group_are_refused(monkeypatch):
    """Several devices in a process under a process group are refused with
    what to run instead (a worker a device, ``parallel/launch.py``); over a
    mesh that spans processes the predictors run on this rank's device
    (``test_torch_hybrid.py`` runs the fused one, ``test_torch_tile_procs.py``
    ``TiledPredictor``): it builds there with no collective at ``data=2,
    model=1`` when the mesh has no group, and refuses ``tp=True`` on a model
    axis with no model group.  ``mesh_devices`` still refuses such a mesh."""
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(pmesh.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(pmesh.dist, "get_backend", lambda: "gloo")
    with pytest.raises(ValueError, match="2 local devices in each of 2 processes.*parallel/launch.py.*--local-devices 2"):
        pmesh.make_mesh(devices=["cpu", "cpu"])
    spans = pmesh.Mesh(2, 1, 0, 2, torch.device("cpu"))
    assert pmesh.predictor_devices(spans) == (torch.device("cpu"),)
    assert pmesh.predictor_devices(pmesh.Mesh(2, 1, 1, 2), "cpu") == (torch.device("cpu"),)
    pred = TiledPredictor(TinyMember(), CFG, 2, torch.float32, mesh=spans)  # no process group exists here
    assert pred.device == torch.device("cpu") and pred.batch_tiles == 2 * 2 and not pred.tp
    assert list(pred.replicas) == [torch.device("cpu")] and next(pred.model.parameters()).dtype == torch.float32
    with pytest.raises(ValueError, match="channel TP over processes at model=2 needs the mesh's model group"):
        TiledPredictor(TinyMember(), CFG, 2, torch.float32, mesh=pmesh.Mesh(1, 2, 0, 2, torch.device("cpu")), tp=True)
    with pytest.raises(NotImplementedError, match="spans 2 processes and each rank drives one device: rank_device"):
        pmesh.mesh_devices(spans)


def test_check_device_refuses_a_card_index_past_the_cards(monkeypatch):
    """``cuda:N`` with N not below the cards visible raises at set-up, with
    the no-fallback words, for a device and for a mesh that names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    check_device(torch.device("cuda:1"))
    check_device(torch.device("cuda"))
    with pytest.raises(RuntimeError, match=r"sees 2 CUDA card\(s\).*nothing falls back"):
        check_device(torch.device("cuda:2"))
    with pytest.raises(RuntimeError, match="cuda:5 asked for"):
        FusedEnsemblePredictor(tiny_members(), CFG, 2, torch.float32, mesh=pmesh.make_mesh(devices=["cuda:0", "cuda:5"]))
    with pytest.raises(RuntimeError, match="cuda:3 asked for"):
        EnsemblePredictor(tiny_members(), CFG, 2, torch.float32, devices=["cuda:0", "cuda:3"])


def test_shard_forward_splits_in_order_and_pads():
    """Part ``i`` holds rows ``[i*n/k, (i+1)*n/k)`` of the padded batch, every
    shard runs the same batch shape, and the pad's results are dropped."""
    seen = []

    def forward(part, _):
        seen.append(part[:, 0].tolist())
        return part * 10

    tiles = torch.arange(7).reshape(7, 1)
    out = shard_forward([forward], tiles, [torch.device("cpu")] * 4)
    assert seen == [[0, 1], [2, 3], [4, 5], [6, 6]]
    assert torch.equal(out, tiles * 10)
    seen.clear()
    assert torch.equal(shard_forward([forward], tiles, [torch.device("cpu")]), tiles * 10)
    assert seen == [list(range(7))]


def test_shard_forward_launches_stage_by_stage():
    """Each stage runs on every shard before the next stage starts, and
    each shard's result threads through the stages in order: the fused
    predictor launches one member on every card before the next member."""
    order = []

    def stage(k):
        def run(part, acc):
            order.append((k, int(part[0, 0])))
            out = part * 0 + (1 << k)
            return out if acc is None else acc | out
        return run

    tiles = torch.arange(6).reshape(6, 1)
    out = shard_forward([stage(0), stage(1), stage(2)], tiles, [torch.device("cpu")] * 3)
    assert order == [(k, start) for k in range(3) for start in (0, 2, 4)]
    assert torch.equal(out, torch.full((6, 1), 7))


# -- the fused predictor --------------------------------------------------------------
@pytest.mark.parametrize("k", SHARDS)
def test_fused_on_mesh_matches_one_device_and_jax(k):
    imgs = scenes(31, SHAPES)
    meshed = FusedEnsemblePredictor(tiny_members(), CFG, 3, torch.float32, mesh=cpu_mesh(k))
    assert meshed.batch_tiles == 3 * k and meshed.devices == (torch.device("cpu"),) * k
    assert list(meshed.replicas) == [torch.device("cpu")]  # the shards of one device share its replicas
    one = FusedEnsemblePredictor(tiny_members(), CFG, 3 * k, torch.float32, "cpu")
    jax_meshed = JaxFused(jax_members(), JCFG, 3, jnp.float32, mesh=jax_make_mesh(data=k))
    for img in imgs:
        assert_masks_equal(meshed.predict_masks(img), one.predict_masks(img), jax_meshed.predict_masks(img))
    for got, want in zip(meshed.predict_masks_many(imgs, max_in_flight=2), one.predict_masks_many(imgs)):
        assert_masks_equal(got, want)
    np.testing.assert_array_equal(meshed.predict_vote(imgs[2]), one.predict_vote(imgs[2]))
    assert not any(m.any() for m in meshed.predict_masks(imgs[-1]).values())


def test_fused_on_mesh_equal_per_forward_shapes():
    """At equal per-forward batch shapes (``batch_tiles=b`` per shard
    against ``b`` on one device, and one tile a forward on the last
    chunks) the mesh is the one-device predictor: ``predict_masks_many``
    over scenes that group into several chunks."""
    imgs = scenes(32, [(56, 56)] * 3 + [(120, 170)])
    meshed = FusedEnsemblePredictor(tiny_members(), CFG, 1, torch.float32, mesh=cpu_mesh(2))
    one = FusedEnsemblePredictor(tiny_members(), CFG, 1, torch.float32, "cpu")
    for got, want in zip(meshed.predict_masks_many(imgs), one.predict_masks_many(imgs)):
        assert_masks_equal(got, want)


def test_fused_int8_on_mesh_matches_one_device_and_jax():
    """The int8 options reach every replica: the int8 masks on a mesh equal
    the int8 masks on one device and the JAX package's on its mesh."""
    scales = {n: {"conv2d_1": 1.0 + 0.25 * i} for i, n in enumerate(NAMES)}
    (img,) = scenes(33, [(120, 170)])
    meshed = FusedEnsemblePredictor(tiny_members(), CFG, 4, torch.float32, int8_pointwise=True, int8_scales=scales,
                                    mesh=cpu_mesh(2))
    for models in meshed.replicas.values():
        assert all(m.conv2.int8_scale == scales[n]["conv2d_1"] for n, m in models.items())
    one = FusedEnsemblePredictor(tiny_members(), CFG, 8, torch.float32, "cpu", int8_pointwise=True,
                                 int8_scales=scales)
    jax_meshed = JaxFused(jax_members(), JCFG, 4, jnp.float32, mesh=jax_make_mesh(data=2), int8_pointwise=True,
                          int8_scales=scales)
    assert_masks_equal(meshed.predict_masks(img), one.predict_masks(img), jax_meshed.predict_masks(img))


def test_mesh_with_a_model_axis_is_refused_like_jax():
    """The fused path refuses a model axis with the JAX package's message
    (``Pipeline`` before any weight loads); the per-model engine takes one,
    and ``Trainer(tp=True)`` without one is the plain trainer."""
    mesh = pmesh.make_mesh(data=2, model=2, devices=["cpu"] * 4)
    want = r"data-axis sharding only; got a mesh with model axis > 1\. Use a data-only mesh, or per-member " \
           r"TiledPredictor\(tp=True\) for channel TP\."
    with pytest.raises(ValueError, match=want):
        FusedEnsemblePredictor(tiny_members(), CFG, 2, torch.float32, mesh=mesh)
    with pytest.raises(ValueError, match=want):
        JaxFused(jax_members(), JCFG, 2, jnp.float32, mesh=jax_make_mesh(data=2, model=4))
    with pytest.raises(ValueError, match=want):
        Pipeline(cfg=Config(tiler=CFG), compute_dtype=torch.float32, models=tuple(NAMES[:1]), mesh=mesh)
    assert TiledPredictor(TinyMember(), CFG, 2, torch.float32, mesh=mesh).devices == (torch.device("cpu"),) * 2
    assert pmesh.make_mesh(model=2, devices=["cpu", "cpu"]).shape == {"data": 1, "model": 2}
    assert Trainer(TorchTiny, tp=True, device="cpu").tp is False


# -- the per-model engine --------------------------------------------------------------
@pytest.fixture(scope="module")
def variables():
    return jax_variables_np()


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("shape", [(77, 130), (40, 81), (20, 20)], ids=["18_tiles", "8_tiles", "1_tile"])
def test_tiled_on_mesh_matches_one_device_and_jax(variables, k, shape):
    """Three tiles a shard.  18 tiles at k=8 are one chunk of 18, which the
    8 shards do not divide; 8 tiles at k=2 are chunks of 6, the last padded
    with repeated origins; one tile is a chunk smaller than the shards."""
    params, state = variables
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape + (3,), np.uint8)
    meshed = TiledPredictor(port_model(params, state), CFG, 3, torch.float32, mesh=cpu_mesh(k))
    assert meshed.batch_tiles == 3 * k
    one = TiledPredictor(port_model(params, state), CFG, 3 * k, torch.float32, "cpu")
    jax_meshed = JaxTiled(tiny_model, params, state, JCFG, batch_tiles=3, compute_dtype=jnp.float32,
                          mesh=jax_make_mesh(data=k))
    got = meshed.predict_mask(img)
    np.testing.assert_array_equal(got, one.predict_mask(img))
    np.testing.assert_array_equal(got, jax_meshed.predict_mask(img))


@pytest.mark.parametrize("k", [2, 5])
def test_ensemble_on_devices_matches_one_device_and_jax(k):
    imgs = scenes(34, SHAPES[:3])
    spread = EnsemblePredictor(tiny_members(), CFG, 3, torch.float32, devices=["cpu"] * k)
    assert [p.device for p in spread.predictors.values()] == [torch.device("cpu")] * 5
    one = EnsemblePredictor(tiny_members(), CFG, 3, torch.float32, "cpu")
    jax_spread = JaxEnsemble(jax_members(), JCFG, 3, jnp.float32, devices=jax.devices()[:k])
    for img in imgs:
        assert_masks_equal(spread.predict_masks(img), one.predict_masks(img), jax_spread.predict_masks(img))


def test_one_upload_per_device(monkeypatch):
    """``predict_masks`` uploads the scene once per distinct device, not once
    per member: five members over the shards of one device upload once."""
    ens = EnsemblePredictor(tiny_members(), CFG, 2, torch.float32, devices=["cpu", "cpu"])
    uploads = []
    real = TiledPredictor.upload

    def counting(self, staged):
        uploads.append(self.device)
        return real(self, staged)

    monkeypatch.setattr(TiledPredictor, "upload", counting)
    (img,) = scenes(35, [(56, 80)])
    masks = ens.predict_masks(img)
    assert len(masks) == 5
    assert uploads == [torch.device("cpu")]  # NOT 5
    uploads.clear()
    assert all(not m.any() for m in ens.predict_masks(np.zeros((6, 6, 3), np.uint8)).values())
    assert uploads == []  # no tile, no upload


# -- Pipeline ------------------------------------------------------------------------------
def tiny_init(name, generator):
    return load_jax_variables(TinyMember().eval(), *tiny_variables(NAMES.index(name)))


@pytest.mark.parametrize("k", SHARDS)
def test_pipeline_on_mesh_matches_one_device_and_jax(monkeypatch, k):
    """``Pipeline(mesh=)`` through its constructor (the members from
    ``init_model``, stubbed to the tiny members): a small scene, and a
    (152, 152) scene of 36 tiles over ``max_scene_tiles=6``, which takes the
    blocked path in blocks of ``batch_tiles`` = 4 tiles; against the
    pipeline on one device and the JAX pipeline on its mesh."""
    monkeypatch.setattr(port_pipeline_module, "init_model", tiny_init)
    cfg = Config(tiler=CFG)
    imgs = scenes(36, [(56, 56), (152, 152)])
    meshed = Pipeline(cfg=cfg, batch_tiles=4, compute_dtype=torch.float32, models=tuple(NAMES), mesh=cpu_mesh(k),
                      max_scene_tiles=6)
    assert isinstance(meshed.ensemble, FusedEnsemblePredictor)
    assert meshed.ensemble.devices == (torch.device("cpu"),) * k and meshed.ensemble.batch_tiles == 4 * k
    assert [meshed._needs_blocking(i) for i in imgs] == [False, True]
    one = Pipeline(cfg=cfg, batch_tiles=4, compute_dtype=torch.float32, models=tuple(NAMES), device="cpu",
                   max_scene_tiles=6)
    jmesh = jax_make_mesh(data=k)
    jax_pipe = JaxPipeline(models=(), cfg=JaxConfig(tiler=JCFG), batch_tiles=4, compute_dtype=jnp.float32,
                           mesh=jmesh, max_scene_tiles=6)
    jax_pipe.ensemble = JaxFused(jax_members(), JCFG, 4, jnp.float32, mesh=jmesh)
    got, want, jax_want = (p.predict_images(imgs) for p in (meshed, one, jax_pipe))
    for g, w, j in zip(got, want, jax_want):
        assert_masks_equal(g.masks, w.masks, j.masks)
        np.testing.assert_array_equal(g.fused, w.fused)
        np.testing.assert_array_equal(g.fused, j.fused)
        assert g.corners == w.corners == j.corners
    assert got[1].corners  # the big scene's rectangles come back as polygons


def test_pipeline_mesh_needs_fused():
    with pytest.raises(ValueError, match="needs fused=True"):
        Pipeline(models=(), fused=False, mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="pass device=None"):
        Pipeline(models=(), mesh=cpu_mesh(2), device="cpu")


def test_pipeline_int8_calibration_reaches_the_mesh(monkeypatch):
    """Scales calibrated by ``Pipeline(int8_calibration=...)`` are set on
    every replica, and the mesh's masks equal one device's."""
    monkeypatch.setattr(port_pipeline_module, "init_model", tiny_init)
    cal = scenes(37, [(120, 170)])
    kw = dict(cfg=Config(tiler=CFG), batch_tiles=2, compute_dtype=torch.float32, models=tuple(NAMES),
              int8_pointwise=True, int8_calibration=cal)
    meshed = Pipeline(mesh=cpu_mesh(2), **kw)
    one = Pipeline(device="cpu", **kw)
    assert meshed.int8_scales == one.int8_scales
    for models in meshed.ensemble.replicas.values():
        for n, m in models.items():
            assert m.conv2.int8_scale == meshed.int8_scales[n]["conv2d_1"]
    assert_masks_equal(meshed.ensemble.predict_masks(cal[0]), one.ensemble.predict_masks(cal[0]))


def test_trainer_refuses_a_mesh_of_local_devices():
    with pytest.raises(ValueError, match="one process per device.*--coordinator.*torchrun"):
        Trainer(TorchTiny, mesh=cpu_mesh(2), device="cpu")


def test_bucketed_fused_on_mesh_matches_one_device():
    bcfg = dataclasses.replace(CFG, bucket_sizes=True)
    imgs = scenes(38, [(40, 81), (56, 56), (33, 47)])
    meshed = FusedEnsemblePredictor(tiny_members(), bcfg, 2, torch.float32, mesh=cpu_mesh(2))
    one = FusedEnsemblePredictor(tiny_members(), CFG, 4, torch.float32, "cpu")
    for got, want in zip(meshed.predict_masks_many(imgs), one.predict_masks_many(imgs)):
        assert_masks_equal(got, want)
