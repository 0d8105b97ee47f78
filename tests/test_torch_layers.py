"""PyTorch port, layers and attention blocks held against the JAX package.

Same inputs and weights (numpy, from a seed) go through each JAX layer and
its port; f32 on the CPU, ``atol = rtol = 1e-5`` (the two frameworks' conv
kernels sum in different orders).  The cases cover the known traps: TF's
asymmetric SAME padding on strided and dilated convs, the Xception entry
SAME max-pool, res34's gapped max-pool, Conv2DTranspose 'same' at k=2 and
k=3, and inference BN with eps 1e-3 on 4-D and 2-D inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_detection_tpu.core import module as M
from building_detection_tpu.nn import attention as JA
from building_detection_tpu.nn import layers as JL
from building_detection_tpu_torch.core.module import (
    Namer,
    jax_variables,
    load_jax_variables,
    param_count,
)
from building_detection_tpu_torch.nn import attention as A
from building_detection_tpu_torch.nn import layers as L

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)


def random_variables(jax_fn, x, seed=0):
    """Shapes from the JAX init, values from numpy: random kernels scaled
    by 1/sqrt(fan in) so activations stay O(1), random BN gammas/betas and
    moving statistics (variance positive)."""
    params, state = M.init(jax_fn, jax.random.key(0), jnp.asarray(x))
    rng = np.random.RandomState(seed)
    params = {
        k: (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]) if v.ndim > 1 else 2.0)).astype(np.float32)
        for k, v in params.items()
    }
    state = {
        k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("variance") else 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in state.items()
    }
    return params, state


def check_layer(jax_fn, build_port, shape, seed=0):
    x = np.random.RandomState(seed + 1).uniform(-1, 1, shape).astype(np.float32)
    params, state = random_variables(jax_fn, x, seed)
    want, _ = M.apply(jax_fn, params, state, jnp.asarray(x))
    port = load_jax_variables(build_port(Namer()).eval(), params, state)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return port, params, state


CONV_CASES = {
    "k3_s1": (dict(features=6, kernel_size=3), (2, 9, 11, 4)),
    "k3_s2_even": (dict(features=6, kernel_size=3, strides=2), (2, 16, 16, 4)),
    "k3_s2_odd": (dict(features=6, kernel_size=3, strides=2), (2, 15, 17, 4)),
    "k1_s2_pool": (dict(features=8, kernel_size=1, strides=2), (2, 16, 15, 4)),
    "k3_d4": (dict(features=5, kernel_size=3, dilation=4), (1, 20, 20, 4)),
    "k3_d6": (dict(features=5, kernel_size=3, dilation=6), (1, 16, 16, 4)),
    "k3_d12": (dict(features=5, kernel_size=3, dilation=12), (1, 16, 16, 4)),
    "k3_d18": (dict(features=5, kernel_size=3, dilation=18), (1, 12, 12, 4)),
    "k2_s1_even_kernel": (dict(features=5, kernel_size=2), (1, 9, 8, 4)),
    "k3_valid": (dict(features=5, kernel_size=3, padding="VALID"), (2, 10, 10, 3)),
    "no_bias_relu": (dict(features=5, kernel_size=3, use_bias=False, activation="relu"), (2, 8, 8, 3)),
    "sigmoid": (dict(features=1, kernel_size=1, activation="sigmoid"), (2, 8, 8, 3)),
    "softmax": (dict(features=2, kernel_size=3, activation="softmax"), (2, 8, 8, 3)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d(case):
    kw, shape = CONV_CASES[case]
    check_layer(lambda s, x: JL.conv2d(s, x, **kw), lambda n: L.Conv2d(n, shape[-1], **kw), shape)


@pytest.mark.parametrize(
    "kw,shape",
    [
        (dict(features=7, kernel_size=3), (2, 9, 9, 5)),
        (dict(features=7, kernel_size=3, strides=2), (2, 15, 16, 5)),
        (dict(features=7, kernel_size=3, dilation=2, activation="relu"), (1, 10, 10, 5)),
    ],
    ids=["s1", "s2_odd", "d2_relu"],
)
def test_separable_conv2d(kw, shape):
    check_layer(lambda s, x: JL.separable_conv2d(s, x, **kw), lambda n: L.SeparableConv2d(n, shape[-1], **kw), shape)


@pytest.mark.parametrize(
    "kw,shape",
    [
        (dict(features=6, kernel_size=2, strides=2, activation="relu"), (2, 5, 7, 4)),
        (dict(features=6, kernel_size=3, strides=2), (2, 5, 7, 4)),
        (dict(features=6, kernel_size=3, strides=2), (1, 6, 6, 4)),
        (dict(features=3, kernel_size=4, strides=2), (1, 5, 4, 2)),
        (dict(features=3, kernel_size=3, strides=3), (1, 4, 5, 2)),
    ],
    ids=["k2_s2", "k3_s2_odd", "k3_s2_even", "k4_s2", "k3_s3"],
)
def test_conv2d_transpose(kw, shape):
    check_layer(lambda s, x: JL.conv2d_transpose(s, x, **kw), lambda n: L.Conv2dTranspose(n, shape[-1], **kw), shape)


@pytest.mark.parametrize("shape", [(3, 7), (2, 4, 4, 7)], ids=["2d", "4d"])
def test_dense(shape):
    check_layer(lambda s, x: JL.dense(s, x, 5, activation="relu"), lambda n: L.Dense(n, 7, 5, activation="relu"), shape)


@pytest.mark.parametrize("shape", [(2, 6, 5, 8), (4, 8)], ids=["4d", "2d"])
def test_batch_norm_inference(shape):
    check_layer(lambda s, x: JL.batch_norm(s, x), lambda n: L.BatchNorm(n, shape[-1]), shape)


def test_batch_norm_refuses_train_mode():
    """Train mode is no longer refused: it normalises with the batch's own
    statistics and moves the buffers (held against JAX in
    test_torch_train.py), while eval mode keeps the moving ones."""
    params = {"batch_normalization/gamma": np.ones(3, np.float32), "batch_normalization/beta": np.zeros(3, np.float32)}
    state = {"batch_normalization/moving_mean": np.zeros(3, np.float32),
             "batch_normalization/moving_variance": np.ones(3, np.float32)}
    bn = load_jax_variables(L.BatchNorm(Namer(), 3), params, state)
    x = torch.from_numpy(np.random.RandomState(0).standard_normal((16, 3)).astype(np.float32) * 3 + 2)
    np.testing.assert_allclose(bn.eval()(x).detach().numpy(), x.numpy() / np.sqrt(1.001), rtol=1e-6)
    y = bn.train()(x)
    np.testing.assert_allclose(y.mean(0).detach().numpy(), 0.0, atol=1e-5)
    var = x.var(0, unbiased=False)
    np.testing.assert_allclose(y.var(0, unbiased=False).detach().numpy(), (var / (var + 1e-3)).numpy(), rtol=1e-5)
    np.testing.assert_allclose(bn.moving_mean.numpy(), 0.01 * x.mean(0).numpy(), rtol=1e-5)


POOL_CASES = {
    "max_default": (lambda m, x: m.max_pool(x), (2, 16, 16, 3)),
    "max_default_odd": (lambda m, x: m.max_pool(x), (2, 15, 17, 3)),
    "max_gapped_w2_s4": (lambda m, x: m.max_pool(x, pool_size=2, strides=4), (2, 32, 32, 3)),
    "max_gapped_ragged": (lambda m, x: m.max_pool(x, pool_size=2, strides=4), (2, 30, 29, 3)),
    "max_same_3_s2_even": (lambda m, x: m.max_pool(x, pool_size=3, strides=2, padding="SAME"), (2, 16, 16, 3)),
    "max_same_3_s2_odd": (lambda m, x: m.max_pool(x, pool_size=3, strides=2, padding="SAME"), (2, 15, 13, 3)),
    "avg_valid": (lambda m, x: m.avg_pool(x, 2), (2, 16, 14, 3)),
    "avg_same_3_s2": (lambda m, x: m.avg_pool(x, 3, strides=2, padding="SAME"), (2, 15, 16, 3)),
    "gap": (lambda m, x: m.global_avg_pool(x), (2, 9, 7, 5)),
    "gap_keepdims": (lambda m, x: m.global_avg_pool(x, keepdims=True), (2, 9, 7, 5)),
    "upsample_2": (lambda m, x: m.upsample2d(x, 2), (2, 5, 3, 4)),
    "upsample_4": (lambda m, x: m.upsample2d(x, 4), (1, 3, 4, 2)),
    "upsample_2x3": (lambda m, x: m.upsample2d(x, (2, 3)), (1, 3, 4, 2)),
    "relu": (lambda m, x: m.relu(x), (2, 4, 4, 3)),
    "sigmoid": (lambda m, x: m.sigmoid(x), (2, 4, 4, 3)),
    "softmax": (lambda m, x: m.softmax(x), (2, 4, 4, 3)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_parameter_free_ops(case):
    fn, shape = POOL_CASES[case]
    x = np.random.RandomState(3).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(fn(JL, jnp.asarray(x)))
    got = fn(L, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


BLOCK_CASES = {
    "se": (JA.se_block, lambda n: A.SEBlock(n, 16), (2, 8, 8, 16)),
    "sse": (JA.sse_block, lambda n: A.SSEBlock(n, 16), (2, 8, 8, 16)),
    "cse": (JA.cse_block, lambda n: A.CSEBlock(n, 32), (2, 8, 8, 32)),
    "scse": (JA.scse_block, lambda n: A.SCSEBlock(n, 32), (2, 8, 8, 32)),
    "bam": (JA.bam_attention, lambda n: A.BAMAttention(n, 32), (2, 12, 12, 32)),
    "sknet": (JA.sknet_block, lambda n: A.SKNetBlock(n, 8), (2, 8, 8, 8)),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_attention_block(case):
    jax_fn, build, shape = BLOCK_CASES[case]
    port, params, state = check_layer(jax_fn, build, shape)
    assert param_count(port) == sum(v.size for v in params.values())


def test_auto_names_follow_keras():
    """The build-time namer hands out the JAX package's Keras names."""
    namer = Namer()
    layers = [L.Conv2d(namer, 3, 4, 3), L.BatchNorm(namer, 4), L.Conv2d(namer, 4, 4, 1),
              L.Conv2d(namer, 4, 4, 1, name="pool1"), L.BatchNorm(namer, 4, name="pool1_BN"),
              L.BatchNorm(namer, 4), L.SeparableConv2d(namer, 4, 4, 3), L.Conv2dTranspose(namer, 4, 2, 2)]
    assert [m.jax_name for m in layers] == [
        "conv2d", "batch_normalization", "conv2d_1", "pool1", "pool1_BN",
        "batch_normalization_1", "separable_conv2d", "conv2d_transpose",
    ]


def test_load_is_strict_and_round_trips():
    x = np.zeros((1, 8, 8, 32), np.float32)
    params, state = random_variables(JA.bam_attention, x)
    port = load_jax_variables(A.BAMAttention(Namer(), 32).eval(), params, state)
    back_p, back_s = jax_variables(port)
    assert set(back_p) == set(params) and set(back_s) == set(state)
    for k in params:
        np.testing.assert_array_equal(back_p[k], params[k])
    for k in state:
        np.testing.assert_array_equal(back_s[k], state[k])
    missing = dict(params)
    missing.pop(sorted(missing)[0])
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(A.BAMAttention(Namer(), 32), missing, state)
    extra = dict(state, **{"stray/moving_mean": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_variables(A.BAMAttention(Namer(), 32), params, extra)
    wrong = dict(params)
    key = next(k for k in wrong if k.endswith("kernel"))
    wrong[key] = np.zeros((1,) + wrong[key].shape, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(A.BAMAttention(Namer(), 32), wrong, state)
