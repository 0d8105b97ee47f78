"""Inference BatchNorm folded into the convolution that feeds it.

In eval mode a :class:`layers.BatchNorm` is a per-channel affine map of its
input, ``x * s + (beta - mean * s)`` with ``s = gamma * rsqrt(var + eps)``
over the moving statistics.  Where that input is exactly the output of a
convolution (a :class:`layers.Conv2d` with no activation, or the pointwise
step of a :class:`layers.SeparableConv2d`) and nothing else reads it, the
map folds into the convolution: its kernel becomes ``kernel * s`` along the
out-channel axis of the stored OIHW layout and its bias ``(bias - mean) * s
+ beta``.  The BN then has nothing left to do and becomes a
:class:`FoldedBatchNorm`, an identity that holds no tensor.  The convolution
already adds its bias, so the forward loses the BN's three elementwise
passes and its per-channel launches and gains nothing.

The modules that compute ``bn(conv(x))`` declare it: ``FOLDS`` on the
class lists ``(conv attribute, bn attribute)`` pairs whose convolution
output has no other reader.  A BN fed by anything else (SKNet's weighted
branch sum, the ``Dense`` layers of the SE and BAM channel gates) stays as
it is.

Folding is for serving: the fused predictor folds its members when it
computes below f32 (:class:`infer.fused_ensemble.FusedEnsemblePredictor`).
The fold is the same mathematics in another rounding order, so an f32
predictor, which the parity tests hold to the JAX package's roundings,
stays unfolded.  A folded model has no BN statistics left to train.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from building_detection_tpu_torch.nn.layers import BatchNorm, Conv2d, SeparableConv2d


class FoldedBatchNorm(nn.Identity):
    """A BatchNorm whose affine map now lives in the convolution before it;
    ``jax_name`` keeps the name of the layer it replaced."""

    def __init__(self, jax_name: str):
        super().__init__()
        self.jax_name = jax_name


@torch.no_grad()
def fold_into(conv: nn.Module, bn: BatchNorm) -> None:
    """Fold the eval-mode ``bn`` into ``conv`` in place, on their device, in
    f32 (or the kernel's dtype where it is wider); each folded tensor is
    rounded once into its own dtype."""
    if isinstance(conv, SeparableConv2d):
        kernel = conv.pointwise_kernel
    elif isinstance(conv, Conv2d):
        kernel = conv.kernel
    else:
        raise TypeError(f"cannot fold a BatchNorm into {type(conv).__name__}")
    if conv.activation is not None or conv.bias is None or conv.tp or bn.tp:
        raise ValueError(f"{conv.jax_name} -> {bn.jax_name}: only a conv with a bias, no activation and no "
                         "tensor-parallel plan folds its BatchNorm")
    dtype = torch.promote_types(kernel.dtype, torch.float32)
    gamma, beta, mean, var = (t.to(dtype) for t in (bn.gamma, bn.beta, bn.moving_mean, bn.moving_variance))
    s = gamma * torch.rsqrt(var + bn.epsilon)
    kernel.copy_(kernel.to(dtype) * s[:, None, None, None])
    conv.bias.copy_((conv.bias.to(dtype) - mean) * s + beta)


def fold_batchnorm(model: nn.Module) -> nn.Module:
    """Fold every BatchNorm of the eval-mode ``model`` that a module's
    ``FOLDS`` pairs with the convolution feeding it; the BN's slot gets a
    :class:`FoldedBatchNorm`, so its tensors are freed.  In place; returns
    ``model``."""
    if model.training:
        raise ValueError("fold_batchnorm folds the moving statistics of an eval-mode model")
    for module in list(model.modules()):
        for conv_name, bn_name in getattr(module, "FOLDS", ()):
            bn = getattr(module, bn_name)
            if isinstance(bn, BatchNorm):
                fold_into(getattr(module, conv_name), bn)
                setattr(module, bn_name, FoldedBatchNorm(bn.jax_name))
    return model


def bn_sites(model: nn.Module) -> Tuple[int, int]:
    """``(folded, eager)``: the BN sites of ``model`` that its forward runs
    folded into a convolution and those it runs as BatchNorm."""
    folded = sum(isinstance(m, FoldedBatchNorm) for m in model.modules())
    return folded, sum(isinstance(m, BatchNorm) for m in model.modules())
