"""Plain Keras-semantics layers in float32: the benchmark's reference.

A frozen copy of the layer semantics that the five members are written
against, with nothing of the program in it: no kernels, no casts to a
compute dtype, no int8, tensor-parallel or rematerialisation paths.
Tensors are NHWC at every boundary; a convolution views them as NCHW and
calls ``torch.nn.functional``.

* ``SAME`` padding is TF's: the odd row and column of padding go after
  (:func:`same_pads`);
* ``Conv2DTranspose(padding='same')`` is torch's full transposed
  convolution cropped to ``input * stride`` from :func:`_transpose_start`;
* ``BatchNormalization`` is ``(x - mean) * rsqrt(var + 1e-3) * gamma +
  beta``: the moving statistics in eval mode; in train mode the batch's
  mean and biased variance, and the moving statistics move by
  ``0.99 * moving + 0.01 * batch``, the variance with Bessel's ``n / (n -
  1)`` for 4-D inputs only (Keras' fused 4-D path).

Every tensor is registered under its Keras name, ``f"{layer}/{leaf}"``,
counted per layer kind in construction order (:class:`Namer`), and its
shape in Keras' layout is kept in ``Layer.keras_shapes`` so the benchmark
can make weights for any model built from these layers.

``Layer.fp8`` (set by :func:`set_fp8`) rounds the inputs and weights of
every convolution and dense product to float8 e4m3 with one scale per
tensor: the lower-precision control that a comparison must fail.
``Layer.logits`` (set by :func:`set_logits`) makes a softmax layer return
its logits.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

IntPair = Union[int, Tuple[int, int]]
Shape = Tuple[int, ...]

# Keras layout -> torch layout, by rank: conv HWIO -> OIHW (also depthwise
# (kh, kw, 1, C) -> (C, 1, kh, kw) and ConvT (kh, kw, out, in) -> (in, out,
# kh, kw)); dense (in, out) -> (out, in).
TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """TF's SAME padding along one axis, ``(before, after)``."""
    k = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its absolute max maps
    to 448), returned in ``t``'s dtype.  The gradient passes straight
    through in ``t``'s dtype, as an fp8 product's operands take their
    gradients in a wider type."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (rounded - t.detach())


class Namer:
    """One counter per layer kind; an explicit name takes precedence."""

    def __init__(self):
        self.counts: Dict[str, int] = {}

    def name(self, kind: str, explicit: Optional[str] = None) -> str:
        if explicit is not None:
            return explicit
        n = self.counts.get(kind, 0)
        self.counts[kind] = n + 1
        return kind if n == 0 else f"{kind}_{n}"


class Layer(nn.Module):
    """A layer whose tensors carry Keras names and Keras shapes.

    ``keras_shapes`` maps each leaf to ``(keras shape, role)``; the role
    (``kernel``, ``depthwise``, ``bias``, ``gamma``, ``beta``,
    ``moving_mean``, ``moving_variance``) tells the weight maker what to
    draw."""

    fp8 = False
    logits = False

    def __init__(self, namer: Namer, kind: str, name: Optional[str]):
        super().__init__()
        self.keras_name = namer.name(kind, name)
        self.keras_shapes: Dict[str, Tuple[Shape, str]] = {}

    def add_param(self, leaf: str, shape: Shape, role: str) -> None:
        perm = TO_TORCH.get(len(shape), range(len(shape)))
        self.register_parameter(leaf, nn.Parameter(torch.empty([shape[i] for i in perm])))
        self.keras_shapes[leaf] = (tuple(shape), role)

    def add_state(self, leaf: str, shape: Shape, role: str) -> None:
        self.register_buffer(leaf, torch.empty(shape))
        self.keras_shapes[leaf] = (tuple(shape), role)

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.fp8 else t

    def activate(self, x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
        if activation is None or (activation == "softmax" and self.logits):
            return x
        if activation == "relu":
            return torch.relu(x)
        if activation == "sigmoid":
            return torch.sigmoid(x)
        if activation == "softmax":
            return torch.softmax(x, dim=-1)
        raise ValueError(f"unknown activation {activation!r}")


def _conv(x, w, b, strides, padding, dilation, groups=1):
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        top, bottom = same_pads(xc.shape[2], w.shape[2], strides[0], dilation[0])
        left, right = same_pads(xc.shape[3], w.shape[3], strides[1], dilation[1])
        xc = F.pad(xc, (left, right, top, bottom))
    return F.conv2d(xc, w, b, strides, 0, dilation, groups).permute(0, 2, 3, 1)


class Conv2d(Layer):
    def __init__(self, namer, in_ch, features, kernel_size, strides=1, padding="SAME", dilation=1,
                 use_bias=True, activation=None, name=None):
        super().__init__(namer, "conv2d", name)
        kh, kw = _pair(kernel_size)
        self.strides, self.dilation = _pair(strides), _pair(dilation)
        self.padding, self.activation = padding, activation
        self.add_param("kernel", (kh, kw, in_ch, features), "kernel")
        if use_bias:
            self.add_param("bias", (features,), "bias")
        else:
            self.bias = None

    def forward(self, x):
        y = _conv(self.q(x), self.q(self.kernel), self.bias, self.strides, self.padding, self.dilation)
        return self.activate(y, self.activation)


class SeparableConv2d(Layer):
    """Depthwise (multiplier 1), then a pointwise 1x1 projection."""

    def __init__(self, namer, in_ch, features, kernel_size, strides=1, padding="SAME", dilation=1,
                 use_bias=True, activation=None, name=None):
        super().__init__(namer, "separable_conv2d", name)
        kh, kw = _pair(kernel_size)
        self.strides, self.dilation = _pair(strides), _pair(dilation)
        self.padding, self.activation = padding, activation
        self.add_param("depthwise_kernel", (kh, kw, 1, in_ch), "depthwise")
        self.add_param("pointwise_kernel", (1, 1, in_ch, features), "kernel")
        if use_bias:
            self.add_param("bias", (features,), "bias")
        else:
            self.bias = None

    def forward(self, x):
        y = _conv(self.q(x), self.q(self.depthwise_kernel), None, self.strides, self.padding, self.dilation,
                  groups=x.shape[-1])
        y = _conv(self.q(y), self.q(self.pointwise_kernel), self.bias, (1, 1), "VALID", (1, 1))
        return self.activate(y, self.activation)


def _transpose_start(kernel: int, stride: int) -> int:
    """Leading rows of torch's full transposed convolution that
    ``padding='SAME'`` drops."""
    pad_a = kernel - 1 if stride > kernel - 1 else -(-(kernel + stride - 2) // 2)
    return kernel - 1 - pad_a


class Conv2dTranspose(Layer):
    def __init__(self, namer, in_ch, features, kernel_size, strides=2, use_bias=True, activation=None,
                 name=None):
        super().__init__(namer, "conv2d_transpose", name)
        kh, kw = _pair(kernel_size)
        self.strides, self.activation = _pair(strides), activation
        self.add_param("kernel", (kh, kw, features, in_ch), "kernel")
        if use_bias:
            self.add_param("bias", (features,), "bias")
        else:
            self.bias = None

    def forward(self, x):
        (sh, sw), (kh, kw) = self.strides, self.kernel.shape[2:]
        h, w = x.shape[1], x.shape[2]
        y = F.conv_transpose2d(self.q(x).permute(0, 3, 1, 2), self.q(self.kernel), self.bias, (sh, sw))
        top, left = _transpose_start(kh, sh), _transpose_start(kw, sw)
        y = y[:, :, top : top + h * sh, left : left + w * sw].permute(0, 2, 3, 1)
        return self.activate(y, self.activation)


class Dense(Layer):
    def __init__(self, namer, in_features, features, use_bias=True, activation=None, name=None):
        super().__init__(namer, "dense", name)
        self.activation = activation
        self.add_param("kernel", (in_features, features), "kernel")
        if use_bias:
            self.add_param("bias", (features,), "bias")
        else:
            self.bias = None

    def forward(self, x):
        return self.activate(F.linear(self.q(x), self.q(self.kernel), self.bias), self.activation)


class BatchNorm(Layer):
    def __init__(self, namer, ch, momentum=0.99, epsilon=1e-3, name=None):
        super().__init__(namer, "batch_normalization", name)
        self.momentum, self.epsilon = momentum, epsilon
        self.add_param("gamma", (ch,), "gamma")
        self.add_param("beta", (ch,), "beta")
        self.add_state("moving_mean", (ch,), "moving_mean")
        self.add_state("moving_variance", (ch,), "moving_variance")

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.dim() - 1))
            var, mean = torch.var_mean(x, dim=axes, correction=0)
            n = x.numel() // x.shape[-1]
            bessel = n / (n - 1) if x.dim() == 4 and n > 1 else 1.0
            with torch.no_grad():
                m = self.momentum
                self.moving_mean.copy_(self.moving_mean * m + mean * (1.0 - m))
                self.moving_variance.copy_(self.moving_variance * m + var * bessel * (1.0 - m))
        else:
            mean, var = self.moving_mean, self.moving_variance
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.gamma) + self.beta


def max_pool(x, pool_size=2, strides=None, padding="VALID"):
    ph, pw = _pair(pool_size)
    sh, sw = _pair(strides) if strides is not None else (ph, pw)
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        top, bottom = same_pads(xc.shape[2], ph, sh)
        left, right = same_pads(xc.shape[3], pw, sw)
        xc = F.pad(xc, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(xc, (ph, pw), (sh, sw)).permute(0, 2, 3, 1)


def global_avg_pool(x, keepdims=False):
    return x.mean(dim=(1, 2), keepdim=keepdims)


def upsample2d(x, size=2):
    """Nearest-neighbour ``UpSampling2D``."""
    return x.repeat_interleave(size, dim=1).repeat_interleave(size, dim=2)


def layers(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, Layer)]


def keras_tensors(model: nn.Module) -> Dict[str, Tuple[torch.Tensor, Shape, str]]:
    """``{keras key: (tensor, keras shape, role)}`` over ``model``."""
    out = {}
    for layer in layers(model):
        for leaf, (shape, role) in layer.keras_shapes.items():
            key = f"{layer.keras_name}/{leaf}"
            if key in out:
                raise ValueError(f"two tensors claim {key!r}")
            out[key] = (getattr(layer, leaf), shape, role)
    return out


@torch.no_grad()
def load_keras(model: nn.Module, weights: Dict[str, torch.Tensor]) -> nn.Module:
    """Fill ``model`` from ``{keras key: tensor in Keras layout}``; the key
    sets must match."""
    ours = keras_tensors(model)
    if set(ours) != set(weights):
        missing, extra = sorted(set(ours) - set(weights))[:5], sorted(set(weights) - set(ours))[:5]
        raise ValueError(f"weights differ from the model: missing {missing}, unexpected {extra}")
    for key, (t, shape, _) in ours.items():
        w = weights[key]
        if tuple(w.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(w.shape)} != {shape}")
        t.copy_(w.permute(TO_TORCH[w.dim()]) if w.dim() in TO_TORCH else w)
    return model


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    for layer in layers(model):
        layer.fp8 = on
    return model


def set_logits(model: nn.Module, on: bool = True) -> nn.Module:
    for layer in layers(model):
        layer.logits = on
    return model
