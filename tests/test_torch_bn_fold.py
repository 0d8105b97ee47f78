"""Inference BatchNorm folded into the convolution before it (``nn/fold.py``)
and the fused predictor that folds below f32.

* Each of the five members on 64x64 tiles, with BN gammas, betas and
  moving statistics far from an identity (statistics of a train-mode
  forward): the folded forward's softmax is the unfolded one's to 1e-9, both
  in f64.  (In f32 these random members are chaotic: an input moved by
  1e-6 moves their softmax by 5e-5 to 2e-4, so an f32 comparison would
  measure the roundings, not the fold.)  A conv whose output has a second
  reader would not fold so: a planted one misses by more than 1e-3.
* The folded and eager BN sites of each member are pinned.
* An f32 predictor folds nothing: its members' tensors equal an unfolded
  build's bit for bit.
* A bf16 predictor rounds each folded tensor once: its kernel is
  ``bf16(f32 kernel * s)``, not a product of bf16 casts.
* A bf16 predictor over tiny BN members gives the unfolded bf16
  predictor's masks but for a pinned small share of pixels.

The file imports neither JAX nor the JAX package, so it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest tests/test_torch_bn_fold.py -q
"""
import copy

import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu_torch.core.config import TilerConfig
from building_detection_tpu_torch.core.module import Namer, jax_variables
from building_detection_tpu_torch.infer import fused_ensemble as FE
from building_detection_tpu_torch.models.registry import ENSEMBLE_ORDER, init_model
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.nn.fold import FoldedBatchNorm, bn_sites, fold_batchnorm
from test_torch_cuda import scenes

torch.set_num_threads(2)

# (folded, eager) BN sites: every BN fed by a conv folds; SKNet's BN after
# the branch sum and the SE and BAM channel gates' BNs after Dense stay
SITES = {"res34": (43, 10), "hrnet": (108, 0), "v3plus": (91, 1), "scse": (0, 0), "bam": (99, 9)}
TILE_CFG = TilerConfig(tile=32, stride=24, overlap=8)


@torch.no_grad()
def calibrated(model: nn.Module, seed: int, size: int = 64) -> nn.Module:
    """``model`` in eval mode with BN gammas ``1 + 0.2 N(0, 1)``, betas ``0.2
    N(0, 1)`` and moving statistics those of one train-mode forward over two
    random tiles, so every BN is a map far from the identity."""
    g = torch.Generator().manual_seed(seed)
    bns = [m for m in model.modules() if isinstance(m, L.BatchNorm)]
    for bn in bns:
        bn.gamma.copy_(1 + 0.2 * torch.randn(bn.gamma.shape, generator=g))
        bn.beta.copy_(0.2 * torch.randn(bn.beta.shape, generator=g))
        bn.momentum = 0.0  # the moving statistics become the batch's
    model.train()(torch.rand((2, size, size, 3), generator=g) * 2 - 1)
    for bn in bns:
        bn.momentum = 0.99
    return model.eval()


def max_softmax_gap(model: nn.Module, seed: int) -> float:
    """The largest softmax difference between ``model`` and its folded copy,
    both in f64, on two 64x64 tiles."""
    model = model.double()
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(seed), dtype=torch.float64) * 2 - 1
    folded = fold_batchnorm(copy.deepcopy(model))
    with torch.no_grad():
        return float((folded(x) - model(x)).abs().max())


@pytest.mark.parametrize("name", ENSEMBLE_ORDER)
def test_folded_forward_keeps_the_softmax(name):
    model = calibrated(init_model(name, torch.Generator().manual_seed(3)), 4)
    assert max_softmax_gap(model, 5) <= 1e-9


class ReadTwice(nn.Module):
    """A conv whose output feeds its BN and a skip sum too, wrongly declared
    foldable: folding it changes what the skip reads."""

    FOLDS = (("conv", "bn"),)

    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv = L.Conv2d(n, 3, 8, 3)
        self.bn = L.BatchNorm(n, 8)
        self.head = L.Conv2d(n, 8, 2, 1, activation="softmax")

    def forward(self, x):
        y = self.conv(x)
        return self.head(L.relu(self.bn(y)) + y)


def test_a_conv_read_twice_would_miss_the_bound():
    from building_detection_tpu_torch.core.module import init_layers

    model = calibrated(init_layers(ReadTwice().eval(), torch.Generator().manual_seed(6)), 7)
    assert max_softmax_gap(model, 8) > 1e-3


@pytest.mark.parametrize("name", ENSEMBLE_ORDER)
def test_bn_site_counts(name):
    model = init_model(name, torch.Generator().manual_seed(0))
    folded, eager = SITES[name]
    assert bn_sites(model) == (0, folded + eager)
    assert bn_sites(fold_batchnorm(model)) == (folded, eager)
    assert bn_sites(fold_batchnorm(model)) == (folded, eager)  # a second fold finds nothing more
    with pytest.raises(ValueError, match="eval-mode"):
        fold_batchnorm(model.train())


def test_an_f32_predictor_folds_nothing():
    members = {n: init_model(n, torch.Generator().manual_seed(10 + i)) for i, n in enumerate(ENSEMBLE_ORDER)}
    pred = FE.FusedEnsemblePredictor(members, TILE_CFG, 4, torch.float32, "cpu")
    assert (pred._bn_folded, pred._bn_eager) == (0, sum(f + e for f, e in SITES.values()))
    for i, n in enumerate(ENSEMBLE_ORDER):
        assert not any(isinstance(m, FoldedBatchNorm) for m in pred.models[n].modules())
        got, want = jax_variables(pred.models[n]), jax_variables(init_model(n, torch.Generator().manual_seed(10 + i)))
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{n} {k}")


def test_the_fold_reads_f32():
    """v3plus has both kinds of pair: ``_CBR`` (Conv2d) and ``_SepBN``
    (the separable conv's pointwise step)."""
    model = calibrated(init_model("v3plus", torch.Generator().manual_seed(11)), 12)
    want, by_bf16 = {}, {}
    for m in model.modules():
        for conv_name, bn_name in getattr(m, "FOLDS", ()):
            conv, bn = getattr(m, conv_name), getattr(m, bn_name)
            kernel = conv.pointwise_kernel if isinstance(conv, L.SeparableConv2d) else conv.kernel
            s = bn.gamma * torch.rsqrt(bn.moving_variance + bn.epsilon)
            want[conv.jax_name] = ((kernel * s[:, None, None, None]).to(torch.bfloat16),
                                   ((conv.bias - bn.moving_mean) * s + bn.beta).to(torch.bfloat16))
            b16 = kernel.to(torch.bfloat16) * s.to(torch.bfloat16)[:, None, None, None]
            by_bf16[conv.jax_name] = b16
    pred = FE.FusedEnsemblePredictor({"v3plus": model}, TILE_CFG, 4, torch.bfloat16, "cpu")
    assert (pred._bn_folded, pred._bn_eager) == SITES["v3plus"]
    convs = {m.jax_name: m for m in pred.models["v3plus"].modules() if isinstance(m, (L.Conv2d, L.SeparableConv2d))}
    assert len(want) == SITES["v3plus"][0]
    assert any(isinstance(convs[k], L.SeparableConv2d) for k in want)
    assert any(type(convs[k]) is L.Conv2d for k in want)
    differ = 0
    for k, (kernel, bias) in want.items():
        conv = convs[k]
        got = conv.pointwise_kernel if isinstance(conv, L.SeparableConv2d) else conv.kernel
        assert got.dtype == conv.bias.dtype == torch.bfloat16
        assert torch.equal(got, kernel), k
        assert torch.equal(conv.bias, bias), k
        differ += int((by_bf16[k] != kernel).sum())
    assert differ > 0  # the casts' product would differ: the check tells the two apart


class TinyBNMember(nn.Module):
    """A conv-BN-ReLU and a separable conv-BN-ReLU before a softmax head,
    with a BN after a skip sum that stays eager; class 1 follows
    brightness, as the tiny members of ``test_torch_cuda.py`` do."""

    FOLDS = (("conv1", "bn1"), ("sep", "bn2"))

    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 4, 3)
        self.bn1 = L.BatchNorm(n, 4)
        self.sep = L.SeparableConv2d(n, 4, 4, 3)
        self.bn2 = L.BatchNorm(n, 4)
        self.bn3 = L.BatchNorm(n, 4)
        self.head = L.Conv2d(n, 4, 2, 1, activation="softmax")

    def forward(self, x):
        y = L.relu(self.bn1(self.conv1(x)))
        y = self.bn3(L.relu(self.bn2(self.sep(y))) + y)
        return self.head(y)


@torch.no_grad()
def tiny_bn_member(i: int) -> TinyBNMember:
    rng = np.random.RandomState(70 + i)
    m = TinyBNMember().eval()

    def put(t, v):
        t.copy_(torch.as_tensor(np.asarray(v, np.float32)))

    k1 = 0.05 * rng.standard_normal((4, 3, 3, 3))
    k1[:, :, 1, 1] += 1.0 / 3.0
    put(m.conv1.kernel, k1)
    put(m.conv1.bias, 0.1 * rng.standard_normal(4))
    dw = 0.05 * rng.standard_normal((4, 1, 3, 3))
    dw[:, :, 1, 1] += 1.0
    put(m.sep.depthwise_kernel, dw)
    put(m.sep.pointwise_kernel, np.eye(4)[:, :, None, None] + 0.1 * rng.standard_normal((4, 4, 1, 1)))
    put(m.sep.bias, 0.1 * rng.standard_normal(4))
    for bn in (m.bn1, m.bn2, m.bn3):
        put(bn.gamma, 1.5 + 0.3 * rng.standard_normal(4))
        put(bn.beta, 0.2 + 0.1 * rng.standard_normal(4))
        put(bn.moving_mean, 0.2 * rng.standard_normal(4))
        put(bn.moving_variance, rng.uniform(0.5, 2.0, 4))
    k2 = 0.2 * rng.standard_normal((2, 4, 1, 1))
    k2[1, :, 0, 0] += 2.0
    k2[0, :, 0, 0] -= 2.0
    put(m.head.kernel, k2)
    put(m.head.bias, [12.0, -12.0] + 0.1 * rng.standard_normal(2))
    return m


def tiny_bn_members():
    return {f"b{i}": tiny_bn_member(i) for i in range(3)}


def test_bf16_masks_agree_with_the_unfolded_predictor(monkeypatch):
    imgs = scenes(13, [(120, 170), (64, 64), (200, 96)])
    folded = FE.FusedEnsemblePredictor(tiny_bn_members(), TILE_CFG, 8, torch.bfloat16, "cpu")
    assert (folded._bn_folded, folded._bn_eager) == (6, 3)
    monkeypatch.setattr(FE, "fold_batchnorm", lambda m: m)
    eager = FE.FusedEnsemblePredictor(tiny_bn_members(), TILE_CFG, 8, torch.bfloat16, "cpu")
    assert (eager._bn_folded, eager._bn_eager) == (0, 9)
    flipped = total = 0
    for got, want in zip(folded.predict_masks_many(imgs), eager.predict_masks_many(imgs)):
        for name in want:
            flipped += int((got[name] != want[name]).sum())
            total += want[name].size
            assert 0.05 < (want[name] > 0).mean() < 0.95, name  # both classes present
    assert flipped / total <= 0.002, (flipped, total)
