"""PyTorch port, int8 pointwise convs: gating, calibration and the pipeline
helpers, held against the JAX package (``tests/test_int8.py``'s cases).

The toy model and the members run in f32 on the CPU from the same
variables in both packages.  What must hold:

* the active sites (their names) are the JAX package's for every gate:
  off by default, 1x1 only, an integer flag as a minimum input-channel
  count, never in training;
* at one site with the same input, the int8 codes of the activation and of
  the weight are equal to the JAX codes, and the dequantized output is
  equal (the int32 accumulation is exact and the dequantization is the same
  f32 arithmetic), with static and with dynamic scales;
* through the whole toy model the output is within 1e-5 of its largest
  value of the JAX output (the 3x3 convs between the sites round
  differently in the two libraries) and within the int8 grid's noise (5 %)
  of the f32 output;
* calibrated ``amax`` equals the JAX package's to f32 rounding (relative
  1e-6 at the first site, 1e-5 past a conv);
* the scale JSON of either package loads in the other;
* on a card the product goes through ``torch._int_mm``: its shape rules
  (M > 16, K and N multiples of 8, a column-major right operand) are held
  here on the padding helper with the plain product standing in.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu.core import module as JM
from building_detection_tpu.core.config import Config as JaxConfig
from building_detection_tpu.core.config import TilerConfig as JaxTilerConfig
from building_detection_tpu.infer import pipeline as JP
from building_detection_tpu.nn import layers as JL
from building_detection_tpu_torch.core.config import Config, TilerConfig
from building_detection_tpu_torch.core.module import (
    Namer,
    calibrate_int8,
    init_layers,
    jax_variables,
    load_jax_variables,
    recording_int8_amax,
    set_int8,
)
from building_detection_tpu_torch.infer import pipeline as PP
from building_detection_tpu_torch.infer.engine import EnsemblePredictor
from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
from building_detection_tpu_torch.nn import layers as L
from test_torch_cuda import NAMES, TinyMember, scenes, tiny_variables

torch.set_num_threads(2)


def jax_toy(s, x):
    x = JL.conv2d(s, x, 16, 1, use_bias=False)
    x = jax.nn.relu(x)
    x = JL.separable_conv2d(s, x, 8, 3, use_bias=False)
    return JL.conv2d(s, x, 4, 3, use_bias=False)  # spatial: never quantized


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 16, 1, use_bias=False)
        self.sep = L.SeparableConv2d(n, 16, 8, 3, use_bias=False)
        self.conv2 = L.Conv2d(n, 8, 4, 3, use_bias=False)

    def forward(self, x):
        return self.conv2(self.sep(L.relu(self.conv1(x))))


@pytest.fixture(scope="module")
def toy():
    model = init_layers(Toy(), torch.Generator().manual_seed(0)).eval()
    params, state = jax_variables(model)
    x = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
    return model, {k: jnp.asarray(v) for k, v in params.items()}, state, x


def port_run(model, x, flag=False, scales=None, train=False):
    """(output, {site: amax}) of the port's toy."""
    set_int8(model, flag, scales)
    model.train(train)
    try:
        with torch.no_grad(), recording_int8_amax(model) as amax:
            y = model(torch.from_numpy(x))
    finally:
        set_int8(model, False)
        model.eval()
    return y.numpy(), {k: float(v) for k, v in amax.items()}


def jax_run(params, state, x, flag=False, scales=None, train=False):
    amax = {}
    kw = dict(train=True, rng=jax.random.key(1)) if train else {}
    y, _ = JM.apply(jax_toy, params, state, jnp.asarray(x), int8_pointwise=flag, int8_scales=scales,
                    int8_amax=amax, **kw)
    return np.asarray(y), {k: float(v) for k, v in amax.items()}


# -- gating -----------------------------------------------------------------------------
@pytest.mark.parametrize(
    "flag,train,sites",
    [(False, False, set()), (True, False, {"conv2d", "separable_conv2d"}), (4, False, {"separable_conv2d"}),
     (True, True, set())],
    ids=["off_by_default", "pointwise_only", "int_flag_is_min_input_channels", "training_never_quantizes"],
)
def test_active_sites_match_jax(toy, flag, train, sites):
    model, params, state, x = toy
    _, got = port_run(model, x, flag, train=train)
    _, want = jax_run(params, state, x, flag, train=train)
    assert set(got) == set(want) == sites


def test_quantized_output_matches_jax_and_stays_near_f32(toy):
    model, params, state, x = toy
    y_q, _ = port_run(model, x, True)
    y_jax, _ = jax_run(params, state, x, True)
    y_f, _ = port_run(model, x, False)
    scale = np.abs(y_jax).max()
    np.testing.assert_allclose(y_q, y_jax, rtol=0, atol=1e-5 * scale)
    assert np.abs(y_q - y_f).max() / np.abs(y_f).max() < 0.05  # int8 grid noise, not garbage


# -- one site, the same input: codes and output -----------------------------------------
class Spies:
    """Captures the int8 operands of both packages' site products."""

    def __init__(self, monkeypatch):
        self.port, self.jax = [], []
        plain = L.int8_matmul

        def port_mm(a, b):
            self.port.append((a.numpy().copy(), b.numpy().copy()))
            return plain(a, b)

        monkeypatch.setattr(L, "int8_matmul", port_mm)
        lax = JL.lax
        spies = self

        class JaxLax:
            def __getattr__(self, name):
                return getattr(lax, name)

            def conv_general_dilated(self, *a, **k):
                if k.get("preferred_element_type") == jnp.int32:
                    spies.jax.append((np.asarray(a[0]), np.asarray(a[1])))
                return lax.conv_general_dilated(*a, **k)

        monkeypatch.setattr(JL, "lax", JaxLax())


@pytest.mark.parametrize("layer", ["conv", "separable"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_site_codes_and_output_equal_jax(monkeypatch, layer, static):
    """A 1x1 conv with bias, and a separable conv with a 1x1 depthwise step
    (an exact product in both packages), so the site sees the same input."""
    rng = np.random.RandomState(3)
    x = (3 * rng.randn(2, 5, 6, 24)).astype(np.float32)
    n = Namer()
    port = L.Conv2d(n, 24, 40, 1) if layer == "conv" else L.SeparableConv2d(n, 24, 40, 1)
    init_layers(port, torch.Generator().manual_seed(1)).eval()
    params, _ = jax_variables(port)
    params = {k: v + (0.3 if k.endswith("bias") else 0.0) for k, v in params.items()}
    load_jax_variables(port, params, {})
    site = port.jax_name
    scales = {site: 1.0} if static else None

    def jax_fn(s, v):
        if layer == "conv":
            return JL.conv2d(s, v, 40, 1)
        return JL.separable_conv2d(s, v, 40, 1)

    spies = Spies(monkeypatch)
    set_int8(port, True, scales)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want, _ = JM.apply(jax_fn, {k: jnp.asarray(v) for k, v in params.items()}, {}, jnp.asarray(x),
                       int8_pointwise=True, int8_scales=scales)
    (xq_p, wq_p), (xq_j, wq_j) = spies.port[0], spies.jax[0]
    assert xq_p.dtype == xq_j.dtype == np.int8 and wq_p.dtype == wq_j.dtype == np.int8
    np.testing.assert_array_equal(xq_p, xq_j.reshape(-1, 24))
    np.testing.assert_array_equal(wq_p, wq_j.reshape(24, 40))
    if static:  # the static scale clips: some codes sit at +-127
        assert np.abs(xq_p).max() == 127 and (np.abs(xq_p) == 127).mean() > 0.01
    np.testing.assert_array_equal(got, np.asarray(want))


def test_int_mm_shape_rules_on_the_padding_helper():
    """Every shape reaches the product with M > 16, K and N multiples of 8
    and a column-major right operand, and the crop gives the plain
    product."""
    rng = np.random.RandomState(4)
    seen = []

    def int_mm(a, b):
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        assert a.is_contiguous() and b.t().is_contiguous()
        seen.append((tuple(a.shape), tuple(b.shape)))
        return L.int8_matmul_plain(a, b)

    for m, k, n in ((32, 16, 24), (5, 16, 8), (40, 3, 2), (17, 728, 728), (1, 1, 1)):
        a = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
        wq = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
        got = L._int_mm_padded(a, wq.t(), int_mm)
        want = a.numpy().astype(np.int64) @ wq.numpy().astype(np.int64).T
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), want)
    assert seen[1] == ((17, 16), (16, 8)) and seen[2] == ((40, 8), (8, 8)) and seen[3] == ((17, 728), (728, 728))


def test_int8_matmul_on_cpu_is_the_plain_product():
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randint(-127, 128, (33, 40)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, (40, 24)).astype(np.int8))
    got = L.int8_matmul(a, b)
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64) @ b.numpy().astype(np.int64))
    assert L.int8_matmul.calls == 0  # counted only where it launches on a card
    with pytest.raises(ValueError, match="int8"):
        L.int8_matmul(a.float(), b)


# -- calibration ------------------------------------------------------------------------
def test_calibration_matches_jax(toy):
    model, params, state, x = toy
    got = calibrate_int8(model, [torch.from_numpy(x)])
    want = JM.calibrate_int8(jax_toy, params, state, [jnp.asarray(x)])
    assert set(got) == set(want) == {"conv2d", "separable_conv2d"}
    assert got["conv2d"] == pytest.approx(want["conv2d"], rel=1e-6)
    assert got["separable_conv2d"] == pytest.approx(want["separable_conv2d"], rel=1e-5)
    assert model.conv1.int8_pointwise is False and model.conv1.int8_amax is None  # restored


def test_calibrated_matches_dynamic_on_calibration_data(toy):
    model, _, _, x = toy
    scales = calibrate_int8(model, [torch.from_numpy(x)])
    y_dyn, _ = port_run(model, x, True)
    y_cal, _ = port_run(model, x, True, scales)
    np.testing.assert_allclose(y_dyn, y_cal, rtol=0, atol=1e-5)


def test_max_over_batches_and_flag_threads_to_sites(toy):
    model, params, state, x = toy
    s1 = calibrate_int8(model, [torch.from_numpy(x)])
    s2 = calibrate_int8(model, [torch.from_numpy(x * 0.5), torch.from_numpy(x)])
    for site in s1:
        assert s2[site] == pytest.approx(s1[site], rel=1e-6)
    got = calibrate_int8(model, [torch.from_numpy(x)], int8_pointwise=4)
    want = JM.calibrate_int8(jax_toy, params, state, [jnp.asarray(x)], int8_pointwise=4)
    assert set(got) == set(want) == {"separable_conv2d"}


def test_calibrated_larger_input_still_static(toy):
    model, params, state, x = toy
    scales = calibrate_int8(model, [torch.from_numpy(x)])
    y_f, _ = port_run(model, 2 * x)
    y_c, _ = port_run(model, 2 * x, True, scales)
    y_j, _ = jax_run(params, state, 2 * x, True, JM.calibrate_int8(jax_toy, params, state, [jnp.asarray(x)]))
    assert np.isfinite(y_c).all()
    assert np.abs(y_c - y_f).max() / np.abs(y_f).max() < 0.5
    np.testing.assert_allclose(y_c, y_j, rtol=0, atol=1e-5 * np.abs(y_j).max())


# -- the pipeline helpers ---------------------------------------------------------------
CFG = Config(tiler=TilerConfig(tile=32, stride=24, overlap=8))
JAX_CFG = JaxConfig(tiler=JaxTilerConfig(tile=32, stride=24, overlap=8))


def test_calibration_tiles_equal_jax():
    imgs = [np.random.RandomState(7).randint(0, 256, (70, 50, 3), np.uint8),
            np.random.RandomState(8).randint(0, 256, (40, 90, 3), np.uint8)]
    for max_tiles in (100, 5):
        got = PP._calibration_tiles(imgs, CFG, max_tiles)
        np.testing.assert_array_equal(got, JP._calibration_tiles(imgs, JAX_CFG, max_tiles))
    with pytest.raises(ValueError, match="at least one scene"):
        PP._calibration_tiles([], CFG, 4)


def jax_member(s, x):
    x = JL.conv2d(s, x, 4, 3, activation="relu")
    return JL.conv2d(s, x, 2, 1, activation="softmax")


def port_members():
    return {n: load_jax_variables(TinyMember().eval(), *tiny_variables(i)) for i, n in enumerate(NAMES)}


def test_calibrate_members_matches_jax():
    imgs = scenes(7, [(70, 50)])
    got = PP.calibrate_members_int8(port_members(), imgs, CFG, torch.float32)
    members = {n: (jax_member, *tiny_variables(i)) for i, n in enumerate(NAMES)}
    want = JP.calibrate_members_int8(members, imgs, cfg=JAX_CFG, compute_dtype=jnp.float32)
    assert set(got) == set(want) == set(NAMES)
    for name in NAMES:
        assert set(got[name]) == set(want[name]) == {"conv2d_1"}  # the 1x1 head; the 3x3 stays
        assert got[name]["conv2d_1"] == pytest.approx(want[name]["conv2d_1"], rel=1e-5)


def test_scales_json_crosses_packages(tmp_path):
    scales = {"res34": {"conv2d": 1.5, "conv2d_7": 0.25}, "bam": {"separable_conv2d_3": 3.0000001}}
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    PP.save_int8_scales(ours, scales)
    JP.save_int8_scales(theirs, scales)
    assert open(ours).read() == open(theirs).read()
    assert PP.load_int8_scales(theirs) == JP.load_int8_scales(ours) == scales
    with open(ours) as f:
        assert json.load(f) == scales


def test_pipeline_int8_calibrates_and_engine_agrees():
    """``Pipeline(int8_pointwise=True, int8_calibration=...)`` calibrates
    its members where they live and serves with the static scales; the
    per-model engine with the same scales gives the fused path's masks, and
    the masks equal the JAX fused predictor's with the JAX scales."""
    from building_detection_tpu.infer.fused_ensemble import FusedEnsemblePredictor as JaxFused

    imgs = scenes(8, [(70, 90), (60, 60)])
    pipe = PP.Pipeline(models=(), cfg=CFG, compute_dtype=torch.float32, device="cpu")
    members = port_members()
    scales = PP.calibrate_members_int8(members, imgs[:1], CFG, torch.float32)
    fused = FusedEnsemblePredictor(members, CFG.tiler, 4, torch.float32, "cpu", int8_pointwise=True,
                                   int8_scales=scales)
    engine = EnsemblePredictor(port_members(), CFG.tiler, 4, torch.float32, "cpu", int8_pointwise=True,
                               int8_scales=scales)
    jmembers = {n: (jax_member, *tiny_variables(i)) for i, n in enumerate(NAMES)}
    jscales = JP.calibrate_members_int8(jmembers, imgs[:1], cfg=JAX_CFG, compute_dtype=jnp.float32)
    jfused = JaxFused(jmembers, JAX_CFG.tiler, 4, jnp.float32, int8_pointwise=True, int8_scales=jscales)
    for img in imgs:
        got = fused.predict_masks(img)
        eng = engine.predict_masks(img)
        want = jfused.predict_masks(img)
        for name in NAMES:
            np.testing.assert_array_equal(got[name], eng[name])
            np.testing.assert_array_equal(got[name], want[name])
    assert pipe.int8_scales is None
    full = PP.Pipeline(models=("scse",), cfg=CFG, compute_dtype=torch.float32, device="cpu", int8_pointwise=512,
                       int8_calibration=imgs[:1])
    assert set(full.int8_scales) == {"scse"} and full.int8_scales["scse"]  # scSE's 1x1 convs at 512 in
    assert all(v > 0 for v in full.int8_scales["scse"].values())
    layer = next(m for m in full.ensemble.models["scse"].modules() if getattr(m, "jax_name", None) in
                 full.int8_scales["scse"])
    assert layer.int8_pointwise == 512 and layer.int8_scale == full.int8_scales["scse"][layer.jax_name]
