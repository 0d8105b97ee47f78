"""PyTorch port, the training modules held against the JAX package on the CPU.

The same numpy-seeded inputs go through each JAX function and its port:

* train-mode ``BatchNorm``: output, gradients and the new moving statistics,
  4-D (Bessel ``n/(n-1)`` on the moving variance) and 2-D (biased), in f32
  and with bf16 compute over f32 params;
* the three losses, the four metrics (argmax ties included), both
  schedules and Keras Adam over several steps;
* ``augment_batch`` on shared per-sample decisions, bit-equal;
* ``.npz`` checkpoints written by either package's ``Trainer`` and
  restored exactly, optimizer state and step included, by the other.

Tolerances: f32 elementwise math 1e-6 relative; BN outputs and gradients
1e-5 (one mean/variance reduction, summed in other orders); bf16 compute
3e-2 (about four bf16 ulps on values of order 1).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu.core import module as M
from building_detection_tpu.core.config import AugmentConfig, TrainConfig
from building_detection_tpu.data import augment as JA
from building_detection_tpu.nn import layers as JL
from building_detection_tpu.parallel.mesh import make_mesh
from building_detection_tpu.train import losses as JLoss
from building_detection_tpu.train import metrics as JMetrics
from building_detection_tpu.train import schedule as JS
from building_detection_tpu.train.optim import keras_adam
from building_detection_tpu.train.trainer import Trainer as JaxTrainer
from building_detection_tpu_torch.core.module import (
    Namer,
    jax_params,
    jax_variables,
    load_jax_variables,
    set_compute_dtype,
)
from building_detection_tpu_torch.data import augment as PA
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.train import checkpoint as ckpt
from building_detection_tpu_torch.train import losses as PLoss
from building_detection_tpu_torch.train import metrics as PMetrics
from building_detection_tpu_torch.train import schedule as PS
from building_detection_tpu_torch.train.optim import KerasAdam
from building_detection_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)


def np_tree(tree):
    return {k: np.asarray(v) for k, v in jax.device_get(tree).items()}


# -- train-mode BatchNorm --------------------------------------------------------
def _bn_case(rank, seed=0):
    rng = np.random.RandomState(seed)
    shape = (3, 5, 6, 8) if rank == 4 else (4, 8)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    params = {
        "batch_normalization/gamma": rng.uniform(0.5, 1.5, 8).astype(np.float32),
        "batch_normalization/beta": rng.uniform(-0.5, 0.5, 8).astype(np.float32),
    }
    state = {
        "batch_normalization/moving_mean": rng.uniform(-1, 1, 8).astype(np.float32),
        "batch_normalization/moving_variance": rng.uniform(0.5, 2, 8).astype(np.float32),
    }
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, params, state, dy


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rank", [4, 2])
def test_train_batch_norm_matches_jax(rank, dtype):
    """Batch statistics in f32, biased variance in the normalisation, Keras
    momentum on the buffers, Bessel factor only for 4-D inputs."""
    x, params, state, dy = _bn_case(rank)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)

    def f(p, xx):
        y, new_state = M.apply(lambda s, v: JL.batch_norm(s, v), p, state, xx, train=True, compute_dtype=jdt)
        return jnp.sum(y.astype(jnp.float32) * dy), (y, new_state)

    (_, (y_j, st_j)), (g_j, gx_j) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bn = set_compute_dtype(load_jax_variables(L.BatchNorm(Namer(), 8).train(), params, state), tdt)
    xt = torch.from_numpy(x).requires_grad_(True)
    y_p = bn(xt)
    assert y_p.dtype == tdt and bn.gamma.dtype == torch.float32
    torch.sum(y_p.float() * torch.from_numpy(dy)).backward()
    tol = 1e-5 if dtype == "f32" else 3e-2
    np.testing.assert_allclose(y_p.detach().float().numpy(), np.asarray(y_j, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j, np.float32), atol=tol, rtol=tol)
    for leaf in ("gamma", "beta"):
        np.testing.assert_allclose(getattr(bn, leaf).grad.numpy(), np.asarray(g_j[f"batch_normalization/{leaf}"]),
                                   atol=tol * 10, rtol=tol)
    for leaf in ("moving_mean", "moving_variance"):  # f32 statistics in both dtypes
        np.testing.assert_allclose(getattr(bn, leaf).numpy(), np.asarray(st_j[f"batch_normalization/{leaf}"]),
                                   atol=1e-6, rtol=1e-5 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("rank", [4, 2])
def test_bessel_factor_by_rank(rank):
    """Moving variance after one step, from the formula: 4-D takes the
    unbiased batch variance, 2-D the biased one."""
    x, params, state, _ = _bn_case(rank, seed=1)
    bn = load_jax_variables(L.BatchNorm(Namer(), 8).train(), params, state)
    bn(torch.from_numpy(x))
    flat = x.reshape(-1, 8).astype(np.float64)
    var = flat.var(axis=0, ddof=1 if rank == 4 else 0)
    want = state["batch_normalization/moving_variance"] * 0.99 + var * 0.01
    np.testing.assert_allclose(bn.moving_variance.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(bn.moving_mean.numpy(),
                               state["batch_normalization/moving_mean"] * 0.99 + flat.mean(0) * 0.01, rtol=1e-5, atol=1e-7)


def test_per_use_cast_keeps_f32_params():
    """bf16 compute over f32 params: the conv runs in bf16 and its gradient
    lands on the f32 kernel."""
    conv = L.Conv2d(Namer(), 3, 4, 3)
    nn.init.normal_(conv.kernel, generator=torch.Generator().manual_seed(0))
    nn.init.zeros_(conv.bias)
    set_compute_dtype(conv, torch.bfloat16)
    y = conv(torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(1)))
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert conv.kernel.dtype == torch.float32 and conv.kernel.grad.dtype == torch.float32
    assert float(conv.kernel.grad.abs().max()) > 0


# -- losses, metrics, schedules ----------------------------------------------------
def random_batch(seed, n=2, hw=16):
    rng = np.random.RandomState(seed)
    y_pred = rng.dirichlet([1, 1], size=(n, hw, hw)).astype(np.float32)
    lab = (rng.rand(n, hw, hw) < 0.4).astype(np.float32)
    one_hot = np.stack([1 - lab, lab], -1)
    edge = rng.choice([1.0, 2.0], size=(n, hw, hw, 2)).astype(np.float32)
    return np.concatenate([one_hot, edge], -1).astype(np.float32), y_pred


@pytest.mark.parametrize("name", sorted(JLoss.LOSSES))
def test_loss_matches_jax(name):
    y_true, y_pred = random_batch(2)
    y_pred[0, 0, 0] = [0.0, 1.0]  # log(0 + 1e-7) stays finite
    want = float(JLoss.LOSSES[name](jnp.asarray(y_true), jnp.asarray(y_pred)))
    got = float(PLoss.LOSSES[name](torch.from_numpy(y_true), torch.from_numpy(y_pred)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("case", ["random", "ties", "no_positives"])
def test_metrics_match_jax(case):
    y_true, y_pred = random_batch(4)
    if case == "ties":
        y_pred[:, ::2] = 0.5  # argmax ties resolve to class 0
        y_true[:, 1::3, :, :2] = 0.5
    elif case == "no_positives":
        y_true[..., 0], y_true[..., 1] = 1.0, 0.0
    want = JMetrics.all_metrics(jnp.asarray(y_true), jnp.asarray(y_pred))
    got = PMetrics.all_metrics(torch.from_numpy(y_true), torch.from_numpy(y_pred))
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6, abs=1e-12), k
    for fn in ("pixel_accuracy", "iou", "miou", "f1_score"):
        j = float(getattr(JMetrics, fn)(jnp.asarray(y_true), jnp.asarray(y_pred)))
        assert float(getattr(PMetrics, fn)(torch.from_numpy(y_true), torch.from_numpy(y_pred))) == pytest.approx(
            j, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize(
    "args", [(1e-3, 300, 1e-5, 30, 0.0), (1e-3, 100, 0.0, 0, 0.0), (2e-3, 50, 1e-4, 10, 5e-4)],
    ids=["warmup", "no_warmup", "min_lr"],
)
def test_warmup_cosine_matches_jax(args):
    want, got = JS.warmup_cosine(*args), PS.warmup_cosine(*args)
    for step in [0, 1, 5, 9, 10, 11, 29, 30, 31, 49, 50, 99, 150, 299, 300, 400]:
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12), step


def test_exponential_decay_matches_jax():
    want, got = JS.exponential_decay(1e-3, 0.9, 2e-4), PS.exponential_decay(1e-3, 0.9, 2e-4)
    for epoch in range(0, 30, 3):
        assert got(epoch) == pytest.approx(float(want(epoch)), rel=1e-6)


# -- Keras Adam ------------------------------------------------------------------------
@pytest.mark.parametrize("lr", ["constant", "schedule"])
def test_keras_adam_matches_jax(lr):
    """Six updates of two tensors (a 4-D kernel in the two layouts and a
    vector) against ``keras_adam``; the schedule is read at the count before
    the increment."""
    rng = np.random.RandomState(7)
    p = {"conv/kernel": rng.randn(3, 3, 2, 4).astype(np.float32), "conv/bias": rng.randn(4).astype(np.float32)}
    sched_j = 1e-3 if lr == "constant" else JS.warmup_cosine(1e-3, 6, 1e-5, 2)
    sched_p = 1e-3 if lr == "constant" else PS.warmup_cosine(1e-3, 6, 1e-5, 2)
    tx = keras_adam(sched_j)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    sj = tx.init(pj)
    conv = L.Conv2d(Namer(), 2, 4, 3, name="conv")
    load_jax_variables(conv, p, {})
    opt = KerasAdam(jax_params(conv), sched_p)
    for _ in range(6):
        g = {k: rng.randn(*v.shape).astype(np.float32) * 1e-2 for k, v in p.items()}
        g["conv/bias"][0] = 1e-9  # below epsilon: the Keras placement matters
        upd, sj = tx.update({k: jnp.asarray(v) for k, v in g.items()}, sj)
        pj = {k: pj[k] + upd[k] for k in pj}
        opt.step({k: torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v))
                  for k, v in g.items()})
    got, _ = jax_variables(conv)
    for k in p:
        np.testing.assert_allclose(got[k], np.asarray(pj[k]), rtol=0, atol=2e-7, err_msg=k)
    flat = opt.jax_state()
    assert int(flat[".count"]) == int(sj.count) == 6
    for k in p:
        np.testing.assert_allclose(flat[f".mu['{k}']"], np.asarray(sj.mu[k]), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(flat[f".nu['{k}']"], np.asarray(sj.nu[k]), rtol=1e-5, atol=1e-15)


def test_keras_adam_is_not_torch_adam():
    """The first update with a tiny gradient: Keras' raw epsilon on sqrt(v)
    and torch's epsilon on the bias-corrected sqrt(v_hat) differ by far more
    than rounding."""
    w = nn.Parameter(torch.zeros(4))
    KerasAdam({"w": w}, 1e-3).step({"w": torch.full((4,), 1e-6)})
    v = nn.Parameter(torch.zeros(4))
    v.grad = torch.full((4,), 1e-6)
    torch.optim.Adam([v], lr=1e-3, eps=1e-7).step()
    assert float(((w - v).abs() / w.abs()).max().detach()) > 0.01


# -- augmentation ------------------------------------------------------------------------
def _jax_decisions(rng, n, cfg):
    """Drawn from the key exactly as ``augment_batch`` draws them."""
    k_ud, k_lr, k_sc, k_scale, k_col = jax.random.split(rng, 5)
    lo, hi = cfg.scale_range
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return PA.Decisions(
        do_ud=t(jax.random.uniform(k_ud, (n,)) < cfg.p_flip_ud),
        do_lr=t(jax.random.uniform(k_lr, (n,)) < cfg.p_flip_lr),
        do_sc=t(jax.random.uniform(k_sc, (n,)) < cfg.p_scale),
        scales=t(jax.random.uniform(k_scale, (n,), minval=lo, maxval=hi)),
        do_col=t(jax.random.uniform(k_col, (n,)) < cfg.p_color),
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_bit_equal_on_shared_decisions(seed):
    """JAX's ``augment_batch`` on a key against the port's worker on the
    decisions drawn from that key: every byte equal.  Seed 3 forces every
    transform on, with a shrink and a grow."""
    rng = np.random.RandomState(seed)
    n, h, w = 6, 24, 31
    imgs = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    labs = np.where(rng.rand(n, h, w) < 0.4, 255, 0).astype(np.uint8)
    cfg = AugmentConfig()
    if seed == 3:
        cfg = AugmentConfig(p_flip_ud=1.0, p_flip_lr=1.0, p_scale=1.0, p_color=1.0)
    key = jax.random.key(seed)
    want_i, want_l = JA.augment_batch(jnp.asarray(imgs), jnp.asarray(labs), key, cfg)
    dec = _jax_decisions(key, n, cfg)
    assert dec.do_sc.any()
    got_i, got_l = PA.apply_augment(torch.from_numpy(imgs), torch.from_numpy(labs), dec, cfg)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_augment_decisions_keyed_on_step():
    a = PA.draw_decisions(8, 5, 3)
    b = PA.draw_decisions(8, 5, 3)
    c = PA.draw_decisions(8, 5, 4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert a.scales.dtype == torch.float32 and bool(((a.scales >= 0.6) & (a.scales <= 2.0)).all())


# -- checkpoints across the two packages ----------------------------------------------------
def jax_tiny(s, x):
    x = JL.conv2d(s, x, 8, 3, activation="relu")
    x = JL.batch_norm(s, x)
    return JL.conv2d(s, x, 2, 1, activation="softmax")


class TorchTiny(nn.Module):
    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 8, 3, activation="relu")
        self.bn = L.BatchNorm(n, 8)
        self.conv2 = L.Conv2d(n, 8, 2, 1, activation="softmax")

    def forward(self, x):
        return self.conv2(self.bn(self.conv1(x)))


CKPT_CFG = TrainConfig(batch_size=4, image_size=16, epochs=2, warmup_epochs=1)


def tiny_data(seed=0, n=4, hw=16):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8), np.where(rng.rand(n, hw, hw) < 0.4, 255, 0).astype(np.uint8)


def test_jax_checkpoint_restores_in_port(tmp_path):
    imgs, labs = tiny_data()
    jt = JaxTrainer(jax_tiny, CKPT_CFG, steps_per_epoch=3, mesh=make_mesh(data=1))
    for _ in range(2):
        jt.train_on_batch(imgs, labs)
    path = str(tmp_path / "jax.npz")
    jt.save(path)
    want = jt.train_on_batch(imgs, labs)["loss"]
    pt = Trainer(TorchTiny, CKPT_CFG, steps_per_epoch=3, device="cpu")
    pt.restore(path)
    assert pt.step == 2 and pt.optimizer.count == 2
    params, state = jax_variables(pt.model)
    for k, v in np_tree(jt.params).items():
        assert k in params
    got = pt.train_on_batch(imgs, labs)["loss"]
    assert got == pytest.approx(want, rel=1e-5)
    after = np_tree(jt.params)
    params, _ = jax_variables(pt.model)
    for k in after:
        np.testing.assert_allclose(params[k], after[k], atol=1e-6, err_msg=k)


def test_port_checkpoint_restores_in_jax(tmp_path):
    imgs, labs = tiny_data(1)
    pt = Trainer(TorchTiny, CKPT_CFG, steps_per_epoch=3, seed=4, device="cpu")
    for _ in range(2):
        pt.train_on_batch(imgs, labs)
    path = str(tmp_path / "port.npz")
    pt.save(path)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    params, state, opt, step, meta = ckpt.load_variables(path)
    assert step == 2 and meta == {"model": "TorchTiny"} and opt[".count"].dtype == np.int32
    jt = JaxTrainer(jax_tiny, CKPT_CFG, steps_per_epoch=3, mesh=make_mesh(data=1))
    jt.restore(path)
    assert jt.step == 2 and int(jax.device_get(jt.opt_state).count) == 2
    for k, v in np_tree(jt.params).items():
        np.testing.assert_array_equal(v, params[k])
    mu = {k: np.asarray(v) for k, v in jax.device_get(jt.opt_state).mu.items()}
    for k in mu:
        np.testing.assert_array_equal(mu[k], opt[f".mu['{k}']"])
    want = pt.train_on_batch(imgs, labs)["loss"]
    assert jt.train_on_batch(imgs, labs)["loss"] == pytest.approx(want, rel=1e-5)


def test_wrong_model_checkpoint_raises(tmp_path):
    class Other(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = L.Conv2d(Namer(), 3, 2, 1, activation="softmax")

        def forward(self, x):
            return self.conv(x)

    path = str(tmp_path / "other.npz")
    Trainer(Other, CKPT_CFG, device="cpu").save(path)
    with pytest.raises(ValueError, match="does not match model"):
        Trainer(TorchTiny, CKPT_CFG, device="cpu").load_weights(path)
