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

Three opt-ins of the JAX package live here too: int8 pointwise convs for
serving (:func:`int8_pointwise_conv`, switched on per model by
:func:`core.module.set_int8`), rematerialised stages for training
(:func:`stage`, switched on by :func:`core.module.set_remat`) and channel
tensor parallelism.  Under TP (``parallel/tp.py`` decides which parameters
shard and installs the plans) each layer computes the out-channels of its
sharded parameter groups (``TP_GROUPS``) shard by shard and returns the full
tensor, the activation applied after the gather: :class:`ProcessShards`
over the ranks of a model group (training), :class:`DeviceShards` over the
local devices of a mesh row (inference).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from building_detection_tpu_torch.core.module import (
    Init,
    KerasLayer,
    Namer,
    glorot_uniform,
    he_normal,
    ones,
    zeros,
)
from building_detection_tpu_torch.parallel.collectives import copy_to_model, gather_channels, global_moments

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


# -- int8 pointwise convs (serving opt-in) ------------------------------------
def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`int8_matmul`: the same product in int32
    with ``torch.matmul`` (exact; CPU tensors, where int32 matmul exists)."""
    return torch.matmul(a.to(torch.int32), b.to(torch.int32))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K) int8 @ (K, N) int8 -> (M, N) int32``, exact.

    On a CUDA tensor this is ``torch._int_mm`` (cuBLASLt's int8 GEMM with
    int32 accumulation; counted in ``int8_matmul.calls``).  It takes M > 16
    and K, N multiples of 8, so a shape that breaks those is padded with
    zero rows and columns, which adds nothing to the product, and the pad is
    cropped off.  On the TPU, XLA generated this product; no Pallas kernel
    computes it.  A CPU tensor runs :func:`int8_matmul_plain`.
    """
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul takes (M, K) @ (K, N) int8, got {a.dtype} {tuple(a.shape)} @ "
                         f"{b.dtype} {tuple(b.shape)}")
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CPU or CUDA tensors, got {a.device}")
    out = _int_mm_padded(a, b, torch._int_mm)
    int8_matmul.calls += 1
    return out


def _int_mm_padded(a: torch.Tensor, b: torch.Tensor, mm: Callable) -> torch.Tensor:
    """``mm(a, b)`` within ``torch._int_mm``'s shape rules: M padded to 17
    rows where it has fewer, K and N to multiples of 8, all with zeros (which
    add nothing), and the right operand handed over column-major, the layout
    cuBLASLt's int8 path takes; the pad is cropped off the product."""
    (m, k), n = a.shape, b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    out = mm(a, b.t().contiguous().t())
    return out[:m, :n] if pm or pn else out


int8_matmul.calls = 0


def _use_int8(layer: KerasLayer, in_ch: int, kernel: Tuple[int, int], strides, dilation) -> bool:
    """The JAX ``_use_int8`` gate: ``layer.int8_pointwise`` is a bool or a
    minimum input-channel count; only 1x1, stride-1, dilation-1 convs of a
    layer in eval mode quantize (training never does)."""
    flag = layer.int8_pointwise
    if not flag or layer.training:
        return False
    min_ch = 1 if flag is True else int(flag)
    return in_ch >= min_ch and tuple(kernel) == (1, 1) and tuple(strides) == (1, 1) and tuple(dilation) == (1, 1)


def int8_pointwise_conv(layer: KerasLayer, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv as an int8 x int8 -> int32 product: the JAX package's
    ``_int8_pointwise_matmul``, site named by ``layer.jax_name``.

    ``x`` is ``(B, H, W, C_in)`` in the compute dtype, ``kernel`` the layer's
    ``(C_out, C_in, 1, 1)`` weight in the same dtype.  One per-tensor
    activation scale: ``layer.int8_scale`` (a calibrated amax) when set,
    else the tensor's own max; per-output-channel weight scales; codes
    ``clip(round(v / scale), -127, 127)``; the int32 product on the
    ``(B*H*W, C_in)`` view (free for a channels-last activation) dequantized
    to the compute dtype.  While ``layer.int8_amax`` is a dict, the site
    records its observed amax there (calibration).  NOT mask-parity with
    bf16/f32 (about 1e-2 relative).
    """
    b, h, w, c = x.shape
    record, site = layer.int8_amax, layer.jax_name
    seen = x.float().abs().amax() if layer.int8_scale is None or record is not None else None
    if record is not None:  # under TP the shards see one input, maybe on other devices
        record[site] = torch.maximum(record[site], seen.to(record[site].device)) if site in record else seen
    if layer.int8_scale is None:
        sx = seen
    else:
        sx = torch.full((), float(layer.int8_scale), dtype=torch.float32, device=x.device)
    sx = sx.clamp_min(1e-8) / 127.0
    xq = torch.clamp(torch.round(x * (1.0 / sx).to(x.dtype)), -127, 127).to(torch.int8)
    w2 = kernel.float().reshape(kernel.shape[0], c)  # (C_out, C_in)
    sw = w2.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    wq = torch.clamp(torch.round(w2 / sw[:, None]), -127, 127).to(torch.int8)
    acc = int8_matmul(xq.reshape(b * h * w, c), wq.t())
    return (acc.to(x.dtype) * (sx * sw).to(x.dtype)).reshape(b, h, w, -1)


# -- channel tensor parallelism (the runtimes of parallel/tp.py's plans) -----------
Params = Dict[str, Optional[torch.Tensor]]
GroupOp = Callable[[torch.Tensor, Params], torch.Tensor]


class ProcessShards:
    """One sharded parameter group of a layer over the ranks of a model
    group: the layer holds this rank's channel slice of each tensor of the
    group, and ``op`` runs as ``gather_channels(op(copy_to_model(x),
    W_r))``.  A group whose channels are the input's (BatchNorm, the
    depthwise step) takes this rank's slice of the input."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size

    def __call__(self, op: GroupOp, x: torch.Tensor, own: Params, slices_input: bool) -> torch.Tensor:
        x = copy_to_model(x, self.group)
        if slices_input:
            k = x.shape[-1] // self.size
            x = x[..., self.index * k : (self.index + 1) * k]
        return gather_channels(op(x, own), self.group)


class DeviceShards:
    """One sharded parameter group of a layer over the model devices of a
    mesh row in one process: shard ``j``'s tensors live on ``shards[j][0]``;
    ``x`` goes to each of those devices, ``op`` runs there with the shard's
    tensors, and the results come back to ``home`` and are concatenated in
    model order (the single-controller form of GSPMD's channel sharding)."""

    def __init__(self, home: torch.device, shards: Sequence[Tuple[torch.device, Params]]):
        self.home, self.shards = home, list(shards)

    def __call__(self, op: GroupOp, x: torch.Tensor, own: Params, slices_input: bool) -> torch.Tensor:
        k = x.shape[-1] // len(self.shards)
        outs = []
        for j, (device, params) in enumerate(self.shards):
            part = x[..., j * k : (j + 1) * k] if slices_input else x
            outs.append(op(part.to(device, non_blocking=True), params).to(self.home, non_blocking=True))
        return torch.cat(outs, dim=-1)


def sharded(layer: KerasLayer, first: str, op: GroupOp, x: torch.Tensor) -> torch.Tensor:
    """``op(x, params)`` for the parameter group of ``layer`` named by its
    first leaf ``first`` (``layer.TP_GROUPS``): on the layer's own tensors,
    or through the group's TP plan when ``parallel/tp.py`` installed one."""
    leaves, slices_input = layer.TP_GROUPS[first]
    own = {leaf: getattr(layer, leaf) for leaf in leaves}
    plan = layer.tp.get(first) if layer.tp else None
    return op(x, own) if plan is None else plan(op, x, own, slices_input)


class Conv2d(KerasLayer):
    """``keras.layers.Conv2D`` (JAX kernel HWIO, stored OIHW)."""

    TP_GROUPS = {"kernel": (("kernel", "bias"), False)}

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
        return _activate(sharded(self, "kernel", self._conv, x), self.activation)

    def _conv(self, x: torch.Tensor, p: Params) -> torch.Tensor:
        w, bias = self.cast(p["kernel"]), self.cast(p["bias"])
        x = x.to(w.dtype)
        if _use_int8(self, x.shape[-1], w.shape[2:], self.strides, self.dilation):
            y = int8_pointwise_conv(self, x, w)
            return y if bias is None else y + bias
        return _conv_nhwc(x, w, bias, self.strides, self.padding, self.dilation)


class SeparableConv2d(KerasLayer):
    """``keras.layers.SeparableConv2D``: depthwise (multiplier 1), then a
    pointwise 1x1 projection.  Under TP the two steps shard apart: the
    depthwise kernel over its (input) channels, the pointwise one and the
    bias over the out-channels."""

    TP_GROUPS = {
        "depthwise_kernel": (("depthwise_kernel",), True),
        "pointwise_kernel": (("pointwise_kernel", "bias"), False),
    }

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
        y = sharded(self, "depthwise_kernel", self._depthwise, x)
        return _activate(sharded(self, "pointwise_kernel", self._pointwise, y), self.activation)

    def _depthwise(self, x: torch.Tensor, p: Params) -> torch.Tensor:
        dw = self.cast(p["depthwise_kernel"])
        return _conv_nhwc(x.to(dw.dtype), dw, None, self.strides, self.padding, self.dilation, groups=x.shape[-1])

    def _pointwise(self, y: torch.Tensor, p: Params) -> torch.Tensor:
        pw, bias = self.cast(p["pointwise_kernel"]), self.cast(p["bias"])
        if _use_int8(self, y.shape[-1], (1, 1), (1, 1), (1, 1)):
            # the depthwise step stays in the compute dtype; the projection quantizes
            y = int8_pointwise_conv(self, y, pw)
            return y if bias is None else y + bias
        return _conv_nhwc(y, pw, bias, (1, 1), "VALID", (1, 1))


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

    TP_GROUPS = {"kernel": (("kernel", "bias"), False)}

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
        return _activate(sharded(self, "kernel", self._conv_transpose, x), self.activation)

    def _conv_transpose(self, x: torch.Tensor, p: Params) -> torch.Tensor:
        kernel = self.cast(p["kernel"])
        x = x.to(kernel.dtype)
        (sh, sw), (kh, kw) = self.strides, kernel.shape[2:]
        h, w = x.shape[1], x.shape[2]
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), kernel, self.cast(p["bias"]), (sh, sw))
        top, left = _transpose_same_start(kh, sh), _transpose_same_start(kw, sw)
        return y[:, :, top : top + h * sh, left : left + w * sw].permute(0, 2, 3, 1)


class Dense(KerasLayer):
    """``keras.layers.Dense`` over the last axis (JAX kernel ``(in, out)``,
    stored ``(out, in)``)."""

    TP_GROUPS = {"kernel": (("kernel", "bias"), False)}

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
        return _activate(sharded(self, "kernel", self._dense, x), self.activation)

    def _dense(self, x: torch.Tensor, p: Params) -> torch.Tensor:
        w = self.cast(p["kernel"])
        return F.linear(x.to(w.dtype), w, self.cast(p["bias"]))


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
    When :func:`stage` recomputes a segment for the backward,
    ``update_moving`` is off: the moving statistics move once a step.
    Under a data group (:func:`core.module.set_data_group`) the mean and
    variance are the global batch's, all-reduced across the ranks
    (:func:`parallel.collectives.global_moments`), and ``n`` of the Bessel
    factor is the global count.  Under TP each shard normalises its slice
    of the channels with its slice of the statistics.

    For serving below f32 the fused predictor folds each eval-mode BN that
    takes a convolution's output into that convolution's kernel and bias
    (:func:`nn.fold.fold_batchnorm`), so such a BN does not run at all.  An
    f32 model, and every model in training, runs it here: folding reorders
    the roundings, and the f32 parity tests hold this layer to the JAX
    package's.
    """

    TP_GROUPS = {"gamma": (("gamma", "beta", "moving_mean", "moving_variance"), True)}
    update_moving = True

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
        return sharded(self, "gamma", self._normalize, x)

    def _normalize(self, x: torch.Tensor, p: Params) -> torch.Tensor:
        gamma, moving_mean, moving_variance = self.cast(p["gamma"]), p["moving_mean"], p["moving_variance"]
        x = x.to(gamma.dtype)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.data_group is None:
                var, mean = torch.var_mean(x.float(), dim=axes, correction=0)
                n = x.numel() // x.shape[-1]
            else:
                mean, var, n = global_moments(x.float(), axes, self.data_group)
            bessel = n / (n - 1) if x.dim() == 4 and n > 1 else 1.0
            if self.update_moving:
                with torch.no_grad():
                    m = self.momentum
                    moving_mean.copy_(moving_mean * m + mean * (1.0 - m))
                    moving_variance.copy_(moving_variance * m + (var * bessel) * (1.0 - m))
        else:
            mean, var = moving_mean, moving_variance
        inv = torch.rsqrt(var + self.epsilon).to(x.dtype) * gamma
        return (x - mean.to(x.dtype)) * inv + self.cast(p["beta"])


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


# -- rematerialised stages (training opt-in) ------------------------------------
@contextlib.contextmanager
def _moving_stats_frozen(owner: nn.Module):
    """BatchNorms under ``owner`` leave their moving statistics alone (the
    recompute of a stage: its first forward already updated them)."""
    bns = [m for m in owner.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_moving = False
    try:
        yield
    finally:
        for bn in bns:
            del bn.update_moving


def stage(owner: nn.Module, fn: Callable, *args):
    """``fn(*args)``, one stage of ``owner``'s forward: a segment whose
    output the JAX models tag with ``remat_tag``.

    When ``owner.remat`` is set (:func:`core.module.set_remat`) and the call
    builds a graph in train mode, the segment runs under
    ``torch.utils.checkpoint`` (non-reentrant): its inputs are saved and its
    insides recomputed in the backward, as ``jax.checkpoint`` with
    ``save_only_these_names('stage')`` does.  The recompute sees the same
    inputs and parameters, so it takes the same batch statistics, and its
    BatchNorms do not update their moving statistics a second time.  The
    numbers are those of the plain forward.  ``fn`` may only run layers
    under ``owner``.
    """
    if not (getattr(owner, "remat", False) and owner.training and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,  # the models draw no random numbers
        context_fn=lambda: (contextlib.nullcontext(), _moving_stats_frozen(owner)),
    )
