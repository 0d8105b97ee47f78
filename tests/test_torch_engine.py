"""PyTorch port, the per-model engine (``infer/engine.py``) held against the
JAX package.

``TiledPredictor`` runs the tiny model of ``tests/test_engine.py`` (a
stride-2 conv, a transposed conv, a 3x3 softmax conv) with the JAX weights
carried over by ``load_jax_variables``, in f32 on the CPU, at
``TilerConfig(tile=32, stride=24, overlap=8)``.  Its masks must be bit-equal
to the JAX ``TiledPredictor``'s and to the numpy re-enactment of the
reference loop (``tests/test_engine.py::reference_loop``) on square,
non-square, one-tile, degenerate and bucketed scenes, at chunk sizes that do
and do not divide the tile count, and with dispatches and fetches
interleaved.  ``EnsemblePredictor`` over the brightness-following tiny
members of ``test_torch_cuda.py`` equals the port's
``FusedEnsemblePredictor`` and the JAX ``EnsemblePredictor``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu.core import module as M
from building_detection_tpu.core.config import TilerConfig as JaxTilerConfig
from building_detection_tpu.infer.engine import EnsemblePredictor as JaxEnsemble
from building_detection_tpu.infer.engine import TiledPredictor as JaxTiled
from building_detection_tpu_torch.core.config import TilerConfig
from building_detection_tpu_torch.core.module import Namer, load_jax_variables
from building_detection_tpu_torch.infer.engine import EnsemblePredictor, TiledPredictor
from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.parallel.mesh import make_mesh
from test_engine import reference_loop, tiny_model
from test_torch_cuda import NAMES, scenes, tiny_members, tiny_variables
from test_torch_pipeline import tiny_member

torch.set_num_threads(2)

CFG = TilerConfig(tile=32, stride=24, overlap=8)
JCFG = JaxTilerConfig(tile=32, stride=24, overlap=8)


class EngineTiny(nn.Module):
    """The port of ``tests/test_engine.py::tiny_model``."""

    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 8, 3, strides=2, activation="relu")
        self.up = L.Conv2dTranspose(n, 8, 8, 2, strides=2, activation="relu")
        self.conv2 = L.Conv2d(n, 8, 2, 3, activation="softmax")

    def forward(self, x):
        return self.conv2(self.up(self.conv1(x)))


def jax_variables_np():
    x = jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)
    params, state = M.init(tiny_model, jax.random.key(0), x)
    return params, state


def port_model(params, state):
    to_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return load_jax_variables(EngineTiny().eval(), to_np(params), to_np(state))


@pytest.fixture(scope="module")
def variables():
    return jax_variables_np()


def pair(variables, batch_tiles=3, cfg=CFG, jcfg=JCFG):
    """(port TiledPredictor, JAX TiledPredictor) on the same weights."""
    params, state = variables
    port = TiledPredictor(port_model(params, state), cfg, batch_tiles, torch.float32, "cpu")
    jax_pred = JaxTiled(tiny_model, params, state, jcfg, batch_tiles=batch_tiles, compute_dtype=jnp.float32)
    return port, jax_pred


def port_apply(pred):
    """``reference_loop``'s per-tile forward, through the port's model."""
    def apply(tile):
        with torch.inference_mode():
            return pred.model(torch.from_numpy(np.array(tile))).numpy()
    return apply


SHAPES = {"square": (56, 56), "wide": (40, 81), "tall": (81, 40), "one_tile": (20, 20), "odd": (77, 130)}


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_tiled_predictor_matches_jax_and_reference_loop(variables, shape):
    port, jax_pred = pair(variables)
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape + (3,), np.uint8)
    got = port.predict_mask(img)
    assert got.shape == shape and got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    np.testing.assert_array_equal(got, jax_pred.predict_mask(img))
    np.testing.assert_array_equal(got, reference_loop(img, port_apply(port)))


def test_degenerate_scene_is_blank(variables):
    port, jax_pred = pair(variables)
    for shape in [(6, 6), (8, 300), (300, 8)]:
        img = np.full(shape + (3,), 200, np.uint8)
        got = port.predict_mask(img)
        np.testing.assert_array_equal(got, np.zeros(shape, np.uint8))
        np.testing.assert_array_equal(got, jax_pred.predict_mask(img))


@pytest.mark.parametrize("batch_tiles", [1, 4, 5, 7, 32])
def test_batch_tiles_not_dividing_the_tile_count(variables, batch_tiles):
    """(77, 130) has 4 x 6 = 24 tiles: 5 and 7 leave a padded last chunk."""
    port, jax_pred = pair(variables, batch_tiles)
    img = np.random.RandomState(9).randint(0, 256, (77, 130, 3), np.uint8)
    np.testing.assert_array_equal(port.predict_mask(img), jax_pred.predict_mask(img))


def test_bucketed_scenes_match_unbucketed_and_jax(variables):
    import dataclasses

    bcfg = dataclasses.replace(CFG, bucket_sizes=True)
    port_b, jax_b = pair(variables, 3, bcfg, dataclasses.replace(JCFG, bucket_sizes=True))
    port, _ = pair(variables)
    rng = np.random.RandomState(4)
    for hw in [(40, 81), (56, 56), (70, 100), (33, 47)]:
        img = rng.randint(0, 256, hw + (3,), np.uint8)
        got = port_b.predict_mask(img)
        np.testing.assert_array_equal(got, port.predict_mask(img), err_msg=str(hw))
        np.testing.assert_array_equal(got, jax_b.predict_mask(img), err_msg=str(hw))
        np.testing.assert_array_equal(got, reference_loop(img, port_apply(port_b)), err_msg=str(hw))


def test_bug_mode_matches_jax(variables):
    import dataclasses

    port, jax_pred = pair(
        variables, 3, dataclasses.replace(CFG, fix_nonsquare_bug=False),
        dataclasses.replace(JCFG, fix_nonsquare_bug=False),
    )
    img = np.random.RandomState(3).randint(0, 256, (40, 81, 3), np.uint8)  # wide: under-tiled
    np.testing.assert_array_equal(port.predict_mask(img), jax_pred.predict_mask(img))


def test_dispatch_and_fetch_interleaved(variables):
    """Several scenes dispatched before any fetch, fetched out of order,
    give each scene's own mask."""
    port, _ = pair(variables, 4)
    imgs = [np.random.RandomState(20 + i).randint(0, 256, s + (3,), np.uint8)
            for i, s in enumerate([(56, 56), (6, 6), (40, 81), (56, 56)])]
    want = [port.predict_mask(img) for img in imgs]
    got = {}
    h0, h1 = port.dispatch(imgs[0]), port.dispatch(imgs[1])
    got[0] = port.fetch(h0)
    h2, h3 = port.dispatch(imgs[2]), port.dispatch(imgs[3])
    got[3], got[1], got[2] = port.fetch(h3), port.fetch(h1), port.fetch(h2)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i], w, err_msg=str(i))


def test_ensemble_matches_fused_and_jax():
    imgs = scenes(5, [(56, 56), (40, 81), (120, 170), (6, 6)])
    ens = EnsemblePredictor(tiny_members(), CFG, 3, torch.float32, "cpu")
    fused = FusedEnsemblePredictor(tiny_members(), CFG, 4, torch.float32, "cpu")
    jax_ens = JaxEnsemble(
        {n: (tiny_member, *tiny_variables(i)) for i, n in enumerate(NAMES)}, JCFG, 3, jnp.float32
    )
    assert ens.names == NAMES
    for img in imgs:
        got = ens.predict_masks(img)
        assert list(got) == NAMES
        want_fused, want_jax = fused.predict_masks(img), jax_ens.predict_masks(img)
        for n in NAMES:
            np.testing.assert_array_equal(got[n], want_fused[n], err_msg=n)
            np.testing.assert_array_equal(got[n], want_jax[n], err_msg=n)
    assert not any(m.any() for m in ens.predict_masks(imgs[-1]).values())


def test_predictor_owns_its_model(variables):
    """The predictor moves the model to its device and casts its params."""
    model = port_model(*variables)
    pred = TiledPredictor(model, CFG, 4, torch.bfloat16, "cpu")
    assert pred.model is model
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    img = np.random.RandomState(1).randint(0, 256, (56, 56, 3), np.uint8)
    mask = pred.predict_mask(img)
    assert mask.shape == (56, 56) and set(np.unique(mask)) <= {0, 255}


def test_multi_device_and_int8_options_are_refused(variables):
    """No multi-device option is refused any more, and a mesh must be a
    ``parallel.mesh.Mesh``: ``tp=True`` without a mesh is the plain
    predictor, as in the JAX package (``test_torch_tp.py`` holds channel TP
    on meshes), and a mesh of two devices and ``EnsemblePredictor(devices=...)``
    give the one-device masks (``test_torch_tile_parallel.py`` holds them
    against the JAX package).
    int8 pointwise convs are ported: the options reach every layer of the
    owned models, and the int8 engine gives the JAX int8 engine's masks on
    the same scales."""
    model = port_model(*variables)
    assert not TiledPredictor(port_model(*variables), CFG, 4, torch.float32, "cpu", tp=True).tp
    with pytest.raises(TypeError, match=r"parallel\.mesh\.Mesh"):
        TiledPredictor(model, CFG, 4, torch.float32, "cpu", mesh=object())
    (img,) = scenes(12, [(70, 90)])
    meshed = TiledPredictor(port_model(*variables), CFG, 2, torch.float32, mesh=make_mesh(devices=["cpu", "cpu"]))
    np.testing.assert_array_equal(meshed.predict_mask(img), TiledPredictor(model, CFG, 4, torch.float32, "cpu")
                                  .predict_mask(img))
    for kwargs in ({"int8_pointwise": True}, {"int8_scales": {"conv2d_1": 1.5}}):
        pred = TiledPredictor(port_model(*variables), CFG, 4, torch.float32, "cpu", **kwargs)
        layers = {m.jax_name: m for m in pred.model.modules() if hasattr(m, "jax_name")}
        assert all(m.int8_pointwise is kwargs.get("int8_pointwise", False) for m in layers.values())
        assert layers["conv2d_1"].int8_scale == kwargs.get("int8_scales", {}).get("conv2d_1")
        assert layers["conv2d"].int8_scale is None
    two = EnsemblePredictor(tiny_members(), CFG, 4, torch.float32, devices=["cpu", "cpu"])
    alone = EnsemblePredictor(tiny_members(), CFG, 4, torch.float32, "cpu")
    got, want = two.predict_masks(img), alone.predict_masks(img)
    for name in NAMES:
        np.testing.assert_array_equal(got[name], want[name])
    scales = {n: {"conv2d_1": 1.0 + 0.25 * i} for i, n in enumerate(NAMES)}
    ens = EnsemblePredictor(tiny_members(), CFG, 4, torch.float32, "cpu", int8_pointwise=True, int8_scales=scales)
    jax_ens = JaxEnsemble({n: (tiny_member, *tiny_variables(i)) for i, n in enumerate(NAMES)}, JCFG, 4,
                          jnp.float32, int8_pointwise=True, int8_scales=scales)
    (img,) = scenes(11, [(70, 90)])
    got, want = ens.predict_masks(img), jax_ens.predict_masks(img)
    for name in NAMES:
        np.testing.assert_array_equal(got[name], want[name])
    one = EnsemblePredictor(tiny_members(), CFG, 4, torch.float32, devices=["cpu"])
    assert all(p.device.type == "cpu" for p in one.predictors.values())
