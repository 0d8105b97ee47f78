"""PyTorch port, the five models and both golden fixtures, held against the
JAX package.

Weights are the JAX package's own ``init_model`` draws, carried over with
``load_jax_variables``.  Per model (f32, CPU, 32 px): parameter and state
counts equal ``EXPECTED_PARAMS``/``EXPECTED_STATE``, and the softmax agrees
within ``atol=1e-4`` (about a hundred layers of convolutions summed in
different orders).  The golden fixtures are reproduced through the port's
fused predictor from the weights ``tests/test_golden.py`` uses: masks, fused
mask, corners and height equal; a mask pixel may differ only where the JAX
members' ``|p1 - p0| < 1e-5`` (an argmax tie), and at most a handful do.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu.core import module as M
from building_detection_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from building_detection_tpu.models.registry import init_model as jax_init_model
from building_detection_tpu.ops import tiling as JT
from building_detection_tpu.post import edges as E
from building_detection_tpu.post import fusion as F
from building_detection_tpu_torch.core.module import Namer, load_jax_variables, param_count, state_count
from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER, build_model, init_model
from building_detection_tpu_torch.nn import layers as L
from test_golden import CFG, FIXTURE, ZOO_CFG, ZOO_FIXTURE, ZOO_NAMES, golden_model
from test_models import EXPECTED_PARAMS, EXPECTED_STATE

torch.set_num_threads(2)

TIE = 1e-5          # |p1 - p0| below which the argmax is a tie
MAX_TIE_PIXELS = 5  # "a handful"


@functools.lru_cache(maxsize=None)
def zoo_variables(name):
    """The JAX weights of ``test_golden.run_zoo_pipeline`` for ``name``."""
    i = ZOO_NAMES.index(name)
    params, state = jax_init_model(name, jax.random.key(100 + i), (1, 32, 32, 3))
    return (
        {k: np.asarray(v) for k, v in params.items()},
        {k: np.asarray(v) for k, v in state.items()},
    )


def port_zoo_model(name):
    return load_jax_variables(build_model(name), *zoo_variables(name))


@pytest.mark.parametrize("name", ENSEMBLE_ORDER)
def test_param_and_state_counts(name):
    model = init_model(name, torch.Generator().manual_seed(0))
    assert param_count(model) == EXPECTED_PARAMS[name]
    assert state_count(model) == EXPECTED_STATE[name]


@pytest.mark.parametrize("name", ENSEMBLE_ORDER)
def test_forward_matches_jax(name):
    x = np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    params, state = zoo_variables(name)
    fn = JAX_REGISTRY[name]
    want = np.asarray(jax.jit(lambda p, s, xx: M.apply(fn, p, s, xx)[0])(params, state, jnp.asarray(x)))
    with torch.inference_mode():
        got = port_zoo_model(name)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 32, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_init_model_is_keras_distributed():
    """he_normal kernels are truncated at two standard deviations of
    sqrt(2 / fan_in) / 0.8796; glorot_uniform kernels are bounded by
    sqrt(6 / (fan_in + fan_out)); BN gammas start at 1."""
    model = init_model("res34", torch.Generator().manual_seed(3))
    conv = model.encoder.stem[1].conv.kernel.detach()  # he_normal, (64, 64, 3, 3)
    std = np.sqrt(2.0 / (64 * 9)) / 0.87962566103423978
    assert float(conv.abs().max()) <= 2 * std
    np.testing.assert_allclose(float(conv.std()), np.sqrt(2.0 / (64 * 9)), rtol=0.05)
    pool = model.encoder.stages[1][0].kernel.detach()  # glorot_uniform, (128, 64, 1, 1)
    assert float(pool.abs().max()) <= np.sqrt(6.0 / (64 + 128))
    assert torch.equal(model.encoder.stem[1].bn.gamma, torch.ones(64))
    again = init_model("res34", torch.Generator().manual_seed(3))
    assert torch.equal(again.encoder.stem[1].conv.kernel, conv)


class GoldenModel(nn.Module):
    """Port of ``test_golden.golden_model``."""

    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 8, 3, strides=2, activation="relu")
        self.bn = L.BatchNorm(n, 8)
        self.up = L.Conv2dTranspose(n, 8, 8, 2, strides=2, activation="relu")
        self.conv2 = L.Conv2d(n, 8, 2, 3, activation="softmax")

    def forward(self, x):
        return self.conv2(self.up(self.bn(self.conv1(x))))


def tie_margin(jax_fn, params, state, img, cfg):
    """Per canvas pixel, the smallest JAX ``|p1 - p0|`` over the tiles that
    cover it (+inf where no tile does)."""
    plan = JT.plan_tiles(*img.shape[:2], cfg.tiler)
    canvas = np.zeros((plan.canvas_h, plan.canvas_w, 3), np.float32)
    canvas[: img.shape[0], : img.shape[1]] = np.asarray(JT.normalize(jnp.asarray(img), cfg.tiler))
    t = cfg.tiler.tile
    tiles = np.stack([canvas[r : r + t, c : c + t] for r, c in plan.origins])
    probs = np.asarray(M.apply(jax_fn, params, state, jnp.asarray(tiles))[0])
    margin = np.full(canvas.shape[:2], np.inf, np.float32)
    for (r, c), p in zip(plan.origins, probs):
        view = margin[r : r + t, c : c + t]
        np.minimum(view, np.abs(p[..., 1] - p[..., 0]), out=view)
    return margin[: img.shape[0], : img.shape[1]]


def check_fixture(fixture, members, jax_members, cfg, img, batch_tiles):
    pred = FusedEnsemblePredictor(members, cfg.tiler, batch_tiles=batch_tiles,
                                  compute_dtype=torch.float32, device="cpu")
    masks = pred.predict_masks(img)
    fused = F.fuse_masks([masks[k] for k in sorted(masks)], cfg.fuse)
    corners, height = E.extract_polygons(fused, cfg.edge)
    blob = json.dumps([[list(map(float, xs)), list(map(float, ys))] for xs, ys in corners])
    with np.load(fixture) as z:
        for name in members:
            diff = masks[name] != z[f"mask_{name}"]
            if diff.any():
                margin = tie_margin(*jax_members[name], img, cfg)
                assert diff.sum() <= MAX_TIE_PIXELS, f"{name}: {diff.sum()} pixels differ"
                assert (margin[diff] < TIE).all(), f"{name}: a non-tie pixel differs"
        np.testing.assert_array_equal(fused, z["fused"])
        assert blob == str(z["corners"])
        assert height == int(z["height"])


def test_golden_pipeline_fixture():
    members, jax_members = {}, {}
    for i, name in enumerate(["m0", "m1", "m2", "m3", "m4"]):
        params, state = M.init(golden_model, jax.random.key(1000 + i), jnp.zeros((1, 64, 64, 3)))
        params = {k: np.asarray(v) for k, v in params.items()}
        state = {k: np.asarray(v) for k, v in state.items()}
        members[name] = load_jax_variables(GoldenModel().eval(), params, state)
        jax_members[name] = (golden_model, params, state)
    img = np.random.RandomState(2024).randint(0, 256, (120, 170, 3), np.uint8)
    check_fixture(FIXTURE, members, jax_members, CFG, img, batch_tiles=4)


def test_golden_zoo_fixture():
    members = {name: port_zoo_model(name) for name in ZOO_NAMES}
    jax_members = {name: (JAX_REGISTRY[name], *zoo_variables(name)) for name in ZOO_NAMES}
    img = np.random.RandomState(7).randint(0, 256, (70, 100, 3), np.uint8)
    check_fixture(ZOO_FIXTURE, members, jax_members, ZOO_CFG, img, batch_tiles=8)
