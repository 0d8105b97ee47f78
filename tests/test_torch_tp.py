"""PyTorch port, channel tensor parallelism (``parallel/tp.py``) in one
process and the last two functions of ``ops/morphology.py``, held against
the JAX package.

* The rule: for each of the five members at ``model`` 2, 4 and 8, the
  parameters whose layer groups ``tp_device_replicas`` shards are exactly
  those the JAX ``_spec_for`` shards on the JAX names and shapes of the JAX
  package's own ``init_model``, and the BatchNorm statistics those its
  ``tp_replicate_state`` shards.
* ``TiledPredictor(tp=True)`` on meshes of local devices (``["cpu"] * 8``,
  each entry one shard) with the tiny model of ``tests/test_parallel.py``:
  at ``data=1 x model=8`` and ``data=2 x model=4`` the masks are bit-equal
  to one device and to the JAX ``TiledPredictor(tp=True)`` on the same
  scenes (``TestChannelTensorParallel``).
* ``LayerZoo`` (every layer class the rule shards; ``test_torch_distributed.py``)
  at ``model`` 2 and 4: f32 softmax within 1e-5 of one device and masks
  equal, in f32 and with int8 pointwise convs; each row's replica keeps
  only the slices of a sharded layer, on the row's devices.
* ``make_mesh`` over local devices with a model axis, and ``tp=True``
  without one (the plain predictor, as in the JAX package).
* ``majority_vote`` and ``fill_holes`` bit-equal to the JAX functions on
  ``tests/test_morphology.py``'s cases and on seeded random masks, and
  ``max_iters`` read by neither (a hole that needs many steps is filled at
  ``max_iters=1``).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_detection_tpu.core import module as M
from building_detection_tpu.core.config import TilerConfig as JaxTilerConfig
from building_detection_tpu.infer.engine import TiledPredictor as JaxTiled
from building_detection_tpu.models.registry import init_model as jax_init_model
from building_detection_tpu.ops import morphology as jax_morph
from building_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from building_detection_tpu.parallel.tp import _spec_for as jax_spec_for
from building_detection_tpu_torch.core.config import TilerConfig
from building_detection_tpu_torch.core.module import init_layers
from building_detection_tpu_torch.infer.engine import TiledPredictor
from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER, build_model
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.ops import morphology as morph
from building_detection_tpu_torch.parallel import mesh as pmesh
from building_detection_tpu_torch.parallel import tp
from test_engine import tiny_model
from test_morphology import random_mask
from test_torch_distributed import LayerZoo
from test_torch_engine import port_model

torch.set_num_threads(2)

CFG = TilerConfig(tile=32, stride=24, overlap=8)
JCFG = JaxTilerConfig(tile=32, stride=24, overlap=8)


def cpu_mesh(data, model):
    return pmesh.make_mesh(devices=["cpu"] * (data * model), data=data, model=model)


# -- the rule -----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_shapes(name):
    params, state = jax.eval_shape(lambda: jax_init_model(name, jax.random.key(0), (1, 32, 32, 3)))
    return {k: tuple(v.shape) for k, v in params.items()}, {k: tuple(v.shape) for k, v in state.items()}


@pytest.mark.parametrize("model", [2, 4, 8])
@pytest.mark.parametrize("name", ENSEMBLE_ORDER)
def test_sharded_names_match_jax_spec_for(name, model):
    params, state = jax_shapes(name)
    want = {k for k, shape in params.items() if "model" in tuple(jax_spec_for(k, shape, model))}
    want_state = {k for k, shape in state.items() if len(shape) == 1 and shape[0] % model == 0 and shape[0] >= model}
    port = build_model(name)
    dims = tp.tp_dims(port, model)
    (replica,) = tp.tp_device_replicas(port, cpu_mesh(1, model)).values()
    got, got_state = set(), set()
    for layer in replica.modules():
        for first in getattr(layer, "tp", None) or {}:
            for leaf in layer.TP_GROUPS[first][0]:
                key = f"{layer.jax_name}/{leaf}"
                (got if leaf in layer._parameters else got_state).add(key)
    assert got == want, (sorted(got ^ want)[:5], len(got), len(want))
    assert got_state == want_state == {k for k, d in dims["state"].items() if d is not None}
    assert want


# -- TiledPredictor(tp=True) ------------------------------------------------------------
@pytest.mark.parametrize("data,model,key,seed,shape", [(1, 8, 0, 11, (80, 104)), (2, 4, 1, 12, (56, 56))],
                         ids=["model8", "data2_model4"])
def test_tp_predictor_matches_one_device_and_jax(data, model, key, seed, shape):
    """``tests/test_parallel.py::TestChannelTensorParallel`` on the port."""
    x = jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)
    params, state = M.init(tiny_model, jax.random.key(key), x)
    img = np.random.RandomState(seed).randint(0, 256, (*shape, 3), np.uint8)
    single = TiledPredictor(port_model(params, state), CFG, 2, torch.float32, "cpu")
    sharded = TiledPredictor(port_model(params, state), CFG, 2 // data, torch.float32, mesh=cpu_mesh(data, model),
                             tp=True)
    assert sharded.tp and sharded.batch_tiles == 2 and len(sharded.devices) == data
    jax_tp = JaxTiled(tiny_model, params, state, JCFG, batch_tiles=2 // data, compute_dtype=jnp.float32,
                      mesh=jax_make_mesh(data=data, model=model), tp=True)
    got = sharded.predict_mask(img)
    np.testing.assert_array_equal(got, single.predict_mask(img))
    np.testing.assert_array_equal(got, jax_tp.predict_mask(img))


def zoo():
    model = init_layers(LayerZoo(), torch.Generator().manual_seed(7))
    with torch.no_grad():
        for bn in (model.bn, model.se_bn):
            bn.moving_mean.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(8))
            bn.moving_variance.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(9))
    return model


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("model", [2, 4])
def test_every_layer_class_under_tp_matches_one_device(model, int8):
    base = zoo()
    single = TiledPredictor(copy.deepcopy(base), CFG, 4, torch.float32, "cpu", int8_pointwise=int8)
    sharded = TiledPredictor(copy.deepcopy(base), CFG, 4, torch.float32, mesh=cpu_mesh(1, model), tp=True,
                             int8_pointwise=int8)
    replica = sharded.replicas[torch.device("cpu")]
    want_sharded = {"conv", "bn", "sep", "se_down", "se_bn", "se_up", "down", "up"} | ({"odd", "head"} if model == 2 else set())
    assert {n for n, m in replica.named_modules() if getattr(m, "tp", None)} == want_sharded
    assert replica.gate.tp is None and replica.gate.kernel is not None  # the 1-channel gate stays whole
    assert replica.conv.kernel is None and replica.bn.moving_mean is None  # only the slices, on the shard devices
    plan = replica.sep.tp["depthwise_kernel"]
    assert [tuple(p["depthwise_kernel"].shape) for _, p in plan.shards] == [(8 // model, 1, 3, 3)] * model

    tiles = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        want, got = single.model(tiles), replica(tiles)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1).numpy())
    img = np.random.RandomState(4).randint(0, 256, (70, 90, 3), np.uint8)
    np.testing.assert_array_equal(sharded.predict_mask(img), single.predict_mask(img))


def test_make_mesh_with_a_model_axis_over_local_devices():
    mesh = cpu_mesh(2, 4)
    assert (mesh.data, mesh.model, mesh.group, mesh.model_group) == (2, 4, None, None)
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert pmesh.make_mesh(devices=["cpu"] * 8, model=4) == mesh  # data=-1: the devices over the model axis
    assert pmesh.predictor_devices(mesh) == (torch.device("cpu"),) * 2  # the first device of each row
    assert pmesh.mesh_devices(mesh) == mesh.devices
    with pytest.raises(ValueError, match="data must equal their number divided by model=2"):
        pmesh.make_mesh(devices=["cpu"] * 8, data=3, model=2)
    with pytest.raises(ValueError, match="needs its devices"):
        pmesh.predictor_devices(pmesh.Mesh(1, 2, 0, 1))
    # a process mesh: data index and model index of rank r
    assert [(m.data_index, m.model_index) for m in (pmesh.Mesh(2, 2, r, 4) for r in range(4))] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert pmesh.data_rows(pmesh.Mesh(2, 2, 3, 4), 8) == slice(4, 8)


def test_tp_without_a_model_axis_is_the_plain_predictor():
    base = zoo()
    img = np.random.RandomState(5).randint(0, 256, (56, 56, 3), np.uint8)
    plain = TiledPredictor(copy.deepcopy(base), CFG, 2, torch.float32, "cpu")
    for kw in ({"device": "cpu"}, {"mesh": pmesh.make_mesh(devices=["cpu", "cpu"])}):
        pred = TiledPredictor(copy.deepcopy(base), CFG, 2, torch.float32, tp=True, **kw)
        assert not pred.tp and all(m.tp is None for m in pred.model.modules() if hasattr(m, "tp"))
        np.testing.assert_array_equal(pred.predict_mask(img), plain.predict_mask(img))
    # a model axis without tp repeats each row's work: it runs once, data-parallel
    rows = TiledPredictor(copy.deepcopy(base), CFG, 1, torch.float32, mesh=cpu_mesh(2, 2))
    assert not rows.tp and rows.batch_tiles == 2
    np.testing.assert_array_equal(rows.predict_mask(img), plain.predict_mask(img))


# -- ops/morphology.py::majority_vote, fill_holes ---------------------------------------------
def jax_and_port(fn_name, *args, **kw):
    want = np.asarray(getattr(jax_morph, fn_name)(*(jnp.asarray(a) for a in args), **kw))
    got = getattr(morph, fn_name)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw).numpy()
    return got, want


@pytest.mark.parametrize("threshold", [1, 3, 5])
@pytest.mark.parametrize("case", ["test_morphology", "random"])
def test_majority_vote_matches_jax(case, threshold):
    if case == "test_morphology":
        masks = np.stack([random_mask(i) // 255 for i in range(5)]).astype(np.uint8)
    else:
        masks = (np.random.RandomState(threshold).rand(5, 37, 53) < 0.5).astype(np.uint8)
    got, want = jax_and_port("majority_vote", masks, threshold)
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    np.testing.assert_array_equal(got, want)


def holed_rectangle():
    """``tests/test_morphology.py::test_fill_holes``'s mask and its answer."""
    m = np.zeros((32, 32), np.uint8)
    m[4:28, 4:28] = 1
    expected = m.copy()
    m[10:20, 10:20] = 0  # a hole
    m[0:2, 0:2] = 0
    return m, expected


def spiral(n=40):
    """Two square rings; the corridor between them opens to the background
    by a door with a wall beside it, so the flood runs once round it (over
    a hundred steps at n = 40), and the inner ring's hole is filled."""
    m = np.zeros((n, n), np.uint8)
    m[2:-2, 2] = m[2:-2, -3] = m[2, 2:-2] = m[-3, 2:-2] = 1
    m[6:-6, 6] = m[6:-6, -7] = m[6, 6:-6] = m[-7, 6:-6] = 1
    m[2, 4] = 0  # a door in the outer ring, into the corridor between the rings
    m[3:7, 5] = 1  # a wall beside it, past the inner corner: the flood goes the long way round
    return m


@pytest.mark.parametrize("case", ["test_morphology", "random", "batched", "spiral"])
def test_fill_holes_matches_jax(case):
    if case == "test_morphology":
        mask, expected = holed_rectangle()
        got, want = jax_and_port("fill_holes", mask)
        np.testing.assert_array_equal(got, expected)
    elif case == "random":
        mask = (np.random.RandomState(6).rand(48, 40) < 0.55).astype(np.uint8)
        got, want = jax_and_port("fill_holes", mask)
        assert got.sum() > mask.sum()  # something was filled
    elif case == "batched":
        mask = (np.random.RandomState(7).rand(3, 24, 30) < 0.6).astype(np.uint8)
        got, want = jax_and_port("fill_holes", mask)
    else:
        mask = spiral()
        got, want = jax_and_port("fill_holes", mask)
        filled, steps = morph.fill_holes_counted(torch.from_numpy(mask))
        assert steps > 100 and torch.equal(filled, torch.from_numpy(got))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_fill_holes_reads_no_max_iters():
    """The JAX ``while_loop`` never reads ``max_iters`` (it runs to
    convergence), so a hole that needs many steps fills at ``max_iters=1``."""
    mask = spiral()
    got, want = jax_and_port("fill_holes", mask, max_iters=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, morph.fill_holes(torch.from_numpy(mask)).numpy())
    assert got[20, 20] == 1 and mask[20, 20] == 0  # the ring's hole, deep inside the spiral
