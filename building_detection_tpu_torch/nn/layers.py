"""Keras-semantics layers as ``nn.Module``s, NHWC at every public boundary.

The counterpart of ``building_detection_tpu/nn/layers.py``.  Tensors enter
and leave each layer as ``(B, H, W, C)``; inside, a layer views them as
NCHW with ``permute``, which for an NHWC-contiguous tensor is the
channels-last memory format and costs no copy, and hands the convolution to
``torch.nn.functional`` (cuDNN on the card).  The semantics follow the JAX
package, which follows Keras:

* ``SAME`` padding on strided and dilated convolutions is TF's asymmetric
  split, the extra row and column going to the bottom and right; torch's
  ``padding='same'`` refuses stride > 1, so such pads are explicit
  (:func:`same_pads`);
* :class:`Conv2dTranspose` is ``Conv2DTranspose(padding='same')``: torch's
  full transposed convolution, cropped to ``input * stride`` on the side
  ``lax.conv_transpose``'s SAME padding drops;
* :class:`BatchNorm` is ``(x - mean) * (rsqrt(var + eps) * gamma) + beta``
  with Keras' epsilon 1e-3: the moving statistics in eval mode, the batch
  statistics in train mode, which also updates the moving ones;
* a layer casts its parameters to its compute dtype where it uses them and
  its input to the same dtype, as the JAX layers cast to ``compute_dtype``
  (:meth:`core.module.KerasLayer.cast`); BN statistics stay f32.

The int8 pointwise branch of the JAX package is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from building_detection_tpu_torch.core.module import (
    Init,
    KerasLayer,
    Namer,
    glorot_uniform,
    he_normal,
    ones,
    zeros,
)

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """TF's SAME padding along one axis: ``(before, after)``, the odd one
    after."""
    k = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _activate(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation is None:
        return x
    if activation == "relu":
        return torch.relu(x)
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "softmax":
        return torch.softmax(x, dim=-1)
    raise ValueError(f"unknown activation {activation!r}")


def _conv_nhwc(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    strides: Tuple[int, int],
    padding: str,
    dilation: Tuple[int, int],
    groups: int = 1,
) -> torch.Tensor:
    xc = x.permute(0, 3, 1, 2)
    pad: Tuple[int, int] = (0, 0)
    if padding == "SAME":
        top, bottom = same_pads(xc.shape[2], w.shape[2], strides[0], dilation[0])
        left, right = same_pads(xc.shape[3], w.shape[3], strides[1], dilation[1])
        if top == bottom and left == right:
            pad = (top, left)
        else:
            xc = F.pad(xc, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(xc, w, b, strides, pad, dilation, groups)
    return y.permute(0, 2, 3, 1)


class Conv2d(KerasLayer):
    """``keras.layers.Conv2D`` (JAX kernel HWIO, stored OIHW)."""

    def __init__(
        self,
        namer: Namer,
        in_ch: int,
        features: int,
        kernel_size: IntPair,
        strides: IntPair = 1,
        padding: str = "SAME",
        dilation: IntPair = 1,
        use_bias: bool = True,
        activation: Optional[str] = None,
        kernel_init: Init = glorot_uniform,
        name: Optional[str] = None,
    ):
        super().__init__(namer, "conv2d", name)
        kh, kw = _pair(kernel_size)
        self.strides, self.dilation = _pair(strides), _pair(dilation)
        self.padding, self.activation = padding, activation
        self.add_param("kernel", (kh, kw, in_ch, features), kernel_init)
        if use_bias:
            self.add_param("bias", (features,), zeros)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.cast(self.kernel)
        y = _conv_nhwc(x.to(w.dtype), w, self.cast(self.bias), self.strides, self.padding, self.dilation)
        return _activate(y, self.activation)


class SeparableConv2d(KerasLayer):
    """``keras.layers.SeparableConv2D``: depthwise (multiplier 1), then a
    pointwise 1x1 projection."""

    def __init__(
        self,
        namer: Namer,
        in_ch: int,
        features: int,
        kernel_size: IntPair,
        strides: IntPair = 1,
        padding: str = "SAME",
        dilation: IntPair = 1,
        use_bias: bool = True,
        activation: Optional[str] = None,
        name: Optional[str] = None,
    ):
        super().__init__(namer, "separable_conv2d", name)
        kh, kw = _pair(kernel_size)
        self.strides, self.dilation = _pair(strides), _pair(dilation)
        self.padding, self.activation = padding, activation
        self.add_param("depthwise_kernel", (kh, kw, 1, in_ch), glorot_uniform)
        self.add_param("pointwise_kernel", (1, 1, in_ch, features), glorot_uniform)
        if use_bias:
            self.add_param("bias", (features,), zeros)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw = self.cast(self.depthwise_kernel)
        y = _conv_nhwc(
            x.to(dw.dtype), dw, None, self.strides, self.padding,
            self.dilation, groups=x.shape[-1],
        )
        y = _conv_nhwc(y, self.cast(self.pointwise_kernel), self.cast(self.bias), (1, 1), "VALID", (1, 1))
        return _activate(y, self.activation)


def _transpose_same_start(kernel: int, stride: int) -> int:
    """Leading rows torch's full transposed convolution has beyond
    ``lax.conv_transpose(padding='SAME')``, whose front pad is ``k - 1`` for
    ``s > k - 1`` and ``ceil((k + s - 2) / 2)`` otherwise."""
    pad_a = kernel - 1 if stride > kernel - 1 else -(-(kernel + stride - 2) // 2)
    return kernel - 1 - pad_a


class Conv2dTranspose(KerasLayer):
    """``keras.layers.Conv2DTranspose(padding='same')``: output = input *
    stride.  JAX kernel ``(kh, kw, out, in)``, stored ``(in, out, kh, kw)``.

    torch's full transposed convolution gives ``(n - 1) * s + k`` rows; TF
    keeps ``n * s`` of them starting at :func:`_transpose_same_start` (0 for
    k=2/s=2 and for k=3/s=2, so k=3 drops its last row and column).
    """

    def __init__(
        self,
        namer: Namer,
        in_ch: int,
        features: int,
        kernel_size: IntPair,
        strides: IntPair = 2,
        use_bias: bool = True,
        activation: Optional[str] = None,
        kernel_init: Init = glorot_uniform,
        name: Optional[str] = None,
    ):
        super().__init__(namer, "conv2d_transpose", name)
        kh, kw = _pair(kernel_size)
        self.strides, self.activation = _pair(strides), activation
        self.add_param("kernel", (kh, kw, features, in_ch), kernel_init)
        if use_bias:
            self.add_param("bias", (features,), zeros)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.cast(self.kernel)
        x = x.to(kernel.dtype)
        (sh, sw), (kh, kw) = self.strides, kernel.shape[2:]
        h, w = x.shape[1], x.shape[2]
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), kernel, self.cast(self.bias), (sh, sw))
        top, left = _transpose_same_start(kh, sh), _transpose_same_start(kw, sw)
        y = y[:, :, top : top + h * sh, left : left + w * sw]
        return _activate(y.permute(0, 2, 3, 1), self.activation)


class Dense(KerasLayer):
    """``keras.layers.Dense`` over the last axis (JAX kernel ``(in, out)``,
    stored ``(out, in)``)."""

    def __init__(
        self,
        namer: Namer,
        in_features: int,
        features: int,
        use_bias: bool = True,
        activation: Optional[str] = None,
        kernel_init: Init = glorot_uniform,
        name: Optional[str] = None,
    ):
        super().__init__(namer, "dense", name)
        self.activation = activation
        self.add_param("kernel", (in_features, features), kernel_init)
        if use_bias:
            self.add_param("bias", (features,), zeros)
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.cast(self.kernel)
        return _activate(F.linear(x.to(w.dtype), w, self.cast(self.bias)), self.activation)


class BatchNorm(KerasLayer):
    """``keras.layers.BatchNormalization`` over the last axis, epsilon 1e-3.

    Eval mode normalises with the moving statistics.  Train mode (the JAX
    ``batch_norm`` under ``s.train``) normalises with the batch mean and the
    biased batch variance, taken in f32 over every axis but the last, and
    updates the buffers Keras' way, ``moving * 0.99 + batch * 0.01``.  The
    moving variance takes the Bessel factor ``n / (n - 1)`` only for 4-D
    inputs: Keras' fused 4-D path reports the unbiased variance, its 2-D
    path (the SE and BAM gates' ``(B, C)`` inputs) the biased one.
    ``F.batch_norm`` always applies the factor, so it is not used here.
    """

    def __init__(
        self,
        namer: Namer,
        ch: int,
        momentum: float = 0.99,
        epsilon: float = 1e-3,
        name: Optional[str] = None,
    ):
        super().__init__(namer, "batch_normalization", name)
        self.momentum, self.epsilon = momentum, epsilon
        self.add_param("gamma", (ch,), ones)
        self.add_param("beta", (ch,), zeros)
        self.add_state("moving_mean", (ch,), zeros)
        self.add_state("moving_variance", (ch,), ones)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma = self.cast(self.gamma)
        x = x.to(gamma.dtype)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            var, mean = torch.var_mean(x.float(), dim=axes, correction=0)
            n = x.numel() // x.shape[-1]
            bessel = n / (n - 1) if x.dim() == 4 and n > 1 else 1.0
            with torch.no_grad():
                m = self.momentum
                self.moving_mean.copy_(self.moving_mean * m + mean * (1.0 - m))
                self.moving_variance.copy_(self.moving_variance * m + (var * bessel) * (1.0 - m))
        else:
            mean, var = self.moving_mean, self.moving_variance
        inv = torch.rsqrt(var + self.epsilon).to(x.dtype) * gamma
        return (x - mean.to(x.dtype)) * inv + self.cast(self.beta)


def max_pool(
    x: torch.Tensor,
    pool_size: IntPair = 2,
    strides: Optional[IntPair] = None,
    padding: str = "VALID",
) -> torch.Tensor:
    """``keras.layers.MaxPooling2D`` (default pool 2, stride = pool, VALID).

    A stride wider than the window (res34's gapped pool) and SAME padding
    (the Xception entry pool, padded with -inf on TF's sides) both map onto
    ``F.max_pool2d``.
    """
    ph, pw = _pair(pool_size)
    sh, sw = _pair(strides) if strides is not None else (ph, pw)
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        top, bottom = same_pads(xc.shape[2], ph, sh)
        left, right = same_pads(xc.shape[3], pw, sw)
        if top or bottom or left or right:
            xc = F.pad(xc, (left, right, top, bottom), value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    return F.max_pool2d(xc, (ph, pw), (sh, sw)).permute(0, 2, 3, 1)


def avg_pool(
    x: torch.Tensor,
    pool_size: IntPair,
    strides: Optional[IntPair] = None,
    padding: str = "VALID",
) -> torch.Tensor:
    """``AveragePooling2D``: the window sum in f32 over ``ph * pw`` (the JAX
    package counts SAME's zero padding in the window)."""
    ph, pw = _pair(pool_size)
    sh, sw = _pair(strides) if strides is not None else (ph, pw)
    xc = x.permute(0, 3, 1, 2).float()
    if padding == "SAME":
        top, bottom = same_pads(xc.shape[2], ph, sh)
        left, right = same_pads(xc.shape[3], pw, sw)
        xc = F.pad(xc, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    y = F.avg_pool2d(xc, (ph, pw), (sh, sw))
    return y.permute(0, 2, 3, 1).to(x.dtype)


def global_avg_pool(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    """``GlobalAveragePooling2D``: (B,H,W,C) -> (B,C) (or (B,1,1,C)), in f32."""
    return x.float().mean(dim=(1, 2), keepdim=keepdims).to(x.dtype)


def upsample2d(x: torch.Tensor, size: IntPair = 2) -> torch.Tensor:
    """``UpSampling2D`` with nearest-neighbour interpolation."""
    sh, sw = _pair(size)
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, sh, w, sw, c).reshape(b, h * sh, w * sw, c)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)
