"""Keras auto-names, Keras initialisers and the weight bridge from the JAX package.

The JAX package builds its networks as functions of a ``Scope`` tape whose
auto-namer hands out Keras layer names in call order (``conv2d``,
``conv2d_1``, ..., ``batch_normalization_3``;
``building_detection_tpu/core/module.py:97-102``).  Here every layer is an
``nn.Module`` and the same counter runs while the model is *built*: a
:class:`Namer` is threaded through the constructors, so each layer records
the name its JAX counterpart would have had, as long as the modules are
constructed in the order the JAX function calls its layers.

Every tensor a layer owns is registered under its JAX leaf name
(``kernel``, ``bias``, ``gamma``, ``moving_mean``, ...), so its flat JAX key
is ``f"{layer.jax_name}/{leaf}"``.  :func:`load_jax_variables` fills a model
from the JAX package's flat ``params``/``state`` dicts (as numpy arrays),
strictly: every JAX key is used once and every port tensor is filled.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterable, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

Shape = Tuple[int, ...]
Init = Callable[[Shape, Optional[torch.Generator]], torch.Tensor]


class Namer:
    """Build-time counterpart of ``Scope.auto_name``: one counter per layer
    kind, explicit names taking precedence and not counting."""

    def __init__(self):
        self._counters: Dict[str, int] = {}

    def auto_name(self, kind: str, name: Optional[str] = None) -> str:
        if name is not None:
            return name
        n = self._counters.get(kind, 0)
        self._counters[kind] = n + 1
        return kind if n == 0 else f"{kind}_{n}"


# -- layouts ----------------------------------------------------------------
# Axis order taking a JAX array to the port's layout, by rank:
# * conv HWIO ``(kh, kw, in, out)`` -> OIHW ``(out, in, kh, kw)``;
# * depthwise ``(kh, kw, 1, C)`` -> ``(C, 1, kh, kw)``;
# * ConvT ``(kh, kw, out, in)`` -> ``(in, out, kh, kw)``, torch's
#   ``conv_transpose2d`` weight (the three 4-D cases are one permutation);
# * dense ``(in, out)`` -> ``(out, in)`` for ``F.linear``.
_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}
_TO_JAX = {4: (2, 3, 1, 0), 2: (1, 0)}


def to_torch_layout(a: np.ndarray) -> np.ndarray:
    """JAX layout -> the port's layout (vectors are unchanged)."""
    return a.transpose(_TO_TORCH[a.ndim]) if a.ndim in _TO_TORCH else a


def to_jax_layout(a: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_torch_layout`."""
    return a.transpose(_TO_JAX[a.ndim]) if a.ndim in _TO_JAX else a


def torch_axis(jax_axis: int, ndim: int) -> int:
    """The axis of the port's layout that holds axis ``jax_axis`` of an
    ``ndim``-D JAX array."""
    perm = _TO_TORCH.get(ndim)
    return jax_axis if perm is None else perm.index(jax_axis)


# -- Keras initialisers (drawn in the JAX layout) ---------------------------
def _fans(shape: Shape) -> Tuple[float, float]:
    """``jax.nn.initializers`` fans: in axis -2, out axis -1, the leading
    axes are the receptive field."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def he_normal(shape: Shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``variance_scaling(2, 'fan_in', 'truncated_normal')``: the normal is
    cut at two standard deviations and rescaled to keep the variance."""
    fan_in, _ = _fans(shape)
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    out = torch.empty(shape)
    return nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std, generator=generator)


def glorot_uniform(shape: Shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``variance_scaling(1, 'fan_avg', 'uniform')``."""
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
    out = torch.empty(shape)
    return out.uniform_(-limit, limit, generator=generator)


def zeros(shape: Shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.zeros(shape)


def ones(shape: Shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.ones(shape)


class KerasLayer(nn.Module):
    """A layer whose tensors carry JAX names.

    ``add_param``/``add_state`` register a parameter or a buffer (the BN
    moving statistics) under its JAX leaf name, shaped for the port's layout
    and left uninitialised; :func:`init_layers` or :func:`load_jax_variables`
    fills it.

    ``compute_dtype`` (set by :func:`set_compute_dtype`) is the dtype the
    layer computes in: :meth:`cast` converts each parameter to it where it
    is used, as the JAX ``Scope.param`` does, so the stored parameters stay
    f32 and their gradients land there.  ``None`` computes in the
    parameters' own dtype (serving, after :func:`cast_params`).

    ``int8_pointwise``, ``int8_scale`` and ``int8_amax`` are the int8
    serving opt-in of the conv layers (:func:`set_int8`,
    :func:`calibrate_int8`); they are off unless set.

    ``data_group`` (set by :func:`set_data_group`) is the process group
    whose ranks hold the other rows of a data-parallel batch: train-mode
    BatchNorm takes its statistics over all of them.  ``None`` (one
    process, or world size 1) reduces over the local batch only.

    ``TP_GROUPS`` names, by first leaf, the layer's parameter groups that
    share one out-channel axis, each with whether its channels are the
    input's (BatchNorm, the depthwise step); ``tp`` (set by
    ``parallel/tp.py``) maps a group sharded under channel tensor
    parallelism to its plan (``nn.layers.ProcessShards`` or
    ``DeviceShards``).  ``None``: every group computes whole.
    """

    TP_GROUPS: Dict[str, Tuple[Tuple[str, ...], bool]] = {}
    tp: Optional[Dict[str, Callable]] = None
    compute_dtype: Optional[torch.dtype] = None
    data_group: Optional[Any] = None
    int8_pointwise: Union[bool, int] = False
    int8_scale: Optional[float] = None
    int8_amax: Optional[Dict[str, torch.Tensor]] = None

    def __init__(self, namer: Namer, kind: str, name: Optional[str]):
        super().__init__()
        self.jax_name = namer.auto_name(kind, name)
        self.inits: Dict[str, Tuple[Shape, Init]] = {}  # leaf -> JAX shape, initialiser

    def add_param(self, leaf: str, jax_shape: Shape, init: Init) -> None:
        perm = _TO_TORCH.get(len(jax_shape), range(len(jax_shape)))
        self.register_parameter(leaf, nn.Parameter(torch.empty([jax_shape[i] for i in perm])))
        self.inits[leaf] = (tuple(jax_shape), init)

    def add_state(self, leaf: str, jax_shape: Shape, init: Init) -> None:
        self.register_buffer(leaf, torch.empty(jax_shape))
        self.inits[leaf] = (tuple(jax_shape), init)

    def cast(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``t`` in the layer's compute dtype (``None`` passes through)."""
        if t is None or self.compute_dtype is None:
            return t
        return t.to(self.compute_dtype)

    def jax_tensors(self) -> Iterator[Tuple[str, str, torch.Tensor]]:
        """``(kind, jax key, tensor)`` for every tensor this layer owns;
        ``kind`` is ``'params'`` or ``'state'``."""
        for leaf, p in self.named_parameters(recurse=False):
            yield "params", f"{self.jax_name}/{leaf}", p
        for leaf, b in self.named_buffers(recurse=False):
            yield "state", f"{self.jax_name}/{leaf}", b


def _keyed(model: nn.Module) -> Dict[str, Dict[str, Tuple[KerasLayer, str, torch.Tensor]]]:
    """``{'params'|'state': {jax key: (layer, leaf, tensor)}}`` over the
    model; raises if two tensors claim one key or a tensor has no JAX name."""
    out: Dict[str, Dict[str, Tuple[KerasLayer, str, torch.Tensor]]] = {
        "params": {},
        "state": {},
    }
    for layer in model.modules():
        if not isinstance(layer, KerasLayer):
            continue
        for kind, key, t in layer.jax_tensors():
            if key in out[kind]:
                raise ValueError(f"two port tensors claim the JAX key {key!r}")
            out[kind][key] = (layer, key.rsplit("/", 1)[1], t)
    owned = {id(t) for d in out.values() for _, _, t in d.values()}
    stray = [
        n
        for n, t in list(model.named_parameters()) + list(model.named_buffers())
        if id(t) not in owned
    ]
    if stray:
        raise ValueError(f"port tensors with no JAX name: {stray[:5]}")
    return out


@torch.no_grad()
def init_layers(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Fill every tensor from its Keras initialiser, drawn in the JAX layout
    on the CPU with ``generator``.  The numbers differ from JAX's; the
    distributions do not."""
    for tensors in _keyed(model).values():
        for layer, leaf, t in tensors.values():
            shape, init = layer.inits[leaf]
            t.copy_(torch.from_numpy(to_torch_layout(init(shape, generator).numpy())))
    return model


@torch.no_grad()
def load_jax_variables(
    model: nn.Module,
    params: Mapping[str, np.ndarray],
    state: Mapping[str, np.ndarray],
) -> nn.Module:
    """Fill ``model`` from the JAX package's flat ``(params, state)`` dicts.

    Strict: the key sets must match exactly (every JAX key is used once and
    every port tensor is filled), and every shape must agree after the
    layout transform.  Raises ``ValueError`` naming the first mismatch.
    """
    keyed = _keyed(model)
    for kind, given in (("params", params), ("state", state)):
        ours = keyed[kind]
        missing = sorted(set(ours) - set(given))
        extra = sorted(set(given) - set(ours))
        if missing or extra:
            raise ValueError(
                f"{kind} keys differ: missing {missing[:5]}, unexpected {extra[:5]}"
            )
        for key, (_, _, t) in ours.items():
            value = np.asarray(given[key], np.float32)
            if kind == "params":
                value = to_torch_layout(value)
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(
                    f"{kind} {key}: shape {value.shape} != port {tuple(t.shape)}"
                )
            t.copy_(torch.tensor(np.ascontiguousarray(value)))
    return model


def jax_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The model's trainable parameters keyed by their JAX names, in the
    port's layouts (the optimizer's view of the model)."""
    return {k: t for k, (_, _, t) in _keyed(model)["params"].items()}


def jax_templates(model: nn.Module) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``(params, state)`` keyed as :func:`jax_variables`, each a read-only
    f32 zero array of the tensor's full JAX shape: the templates a loaded
    checkpoint is checked against, also where a tensor-parallel rank holds
    only a slice of the tensor."""
    zero, keyed = np.zeros((), np.float32), _keyed(model)
    params, state = (
        {key: np.broadcast_to(zero, layer.inits[leaf][0]) for key, (layer, leaf, _) in keyed[kind].items()}
        for kind in ("params", "state")
    )
    return params, state


def jax_variables(model: nn.Module) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The model's tensors as the JAX package's flat ``(params, state)``
    dicts of numpy arrays (inverse of :func:`load_jax_variables`)."""
    keyed = _keyed(model)
    params = {
        k: np.ascontiguousarray(to_jax_layout(t.detach().float().cpu().numpy()))
        for k, (_, _, t) in keyed["params"].items()
    }
    state = {k: t.detach().float().cpu().numpy() for k, (_, _, t) in keyed["state"].items()}
    return params, state


def cast_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the trainable parameters to ``dtype`` and keep the buffers (BN
    moving statistics) in f32, as the JAX package keeps its state in the
    storage dtype while params follow ``compute_dtype``.  For serving only:
    training keeps f32 params (:func:`set_compute_dtype`)."""
    for p in model.parameters():
        p.data = p.data.to(dtype)
    return model


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Make every layer compute in ``dtype`` from its f32 params, cast per
    use (the JAX package's ``apply(..., compute_dtype=)``, its training
    form); ``None`` restores computing in the params' own dtype."""
    for layer in model.modules():
        if isinstance(layer, KerasLayer):
            layer.compute_dtype = dtype
    return model


def set_int8(
    model: nn.Module,
    int8_pointwise: Union[bool, int] = False,
    int8_scales: Optional[Mapping[str, float]] = None,
) -> nn.Module:
    """Opt ``model`` into int8 pointwise convs for inference, as the JAX
    package's ``apply(..., int8_pointwise=, int8_scales=)`` does per call.

    ``int8_pointwise`` is ``True`` (every 1x1 conv and separable pointwise
    step) or a minimum input-channel count (``512`` keeps the Xception
    projections only); ``False`` turns it off.  ``int8_scales`` maps site
    names (layer names, so either package's scale JSON serves the other) to
    calibrated activation amax; a site without one takes its tensor's own
    max on every call.  Train mode never quantizes.
    """
    for layer in model.modules():
        if isinstance(layer, KerasLayer):
            layer.int8_pointwise = int8_pointwise
            layer.int8_scale = None if int8_scales is None else int8_scales.get(layer.jax_name)
    return model


@contextlib.contextmanager
def recording_int8_amax(model: nn.Module) -> Iterator[Dict[str, torch.Tensor]]:
    """While open, every active int8 site of ``model`` records the running
    max of its activations' ``|x|`` (a 0-d f32 tensor on the model's device)
    into the dict this yields."""
    amax: Dict[str, torch.Tensor] = {}
    layers = [m for m in model.modules() if isinstance(m, KerasLayer)]
    for layer in layers:
        layer.int8_amax = amax
    try:
        yield amax
    finally:
        for layer in layers:
            del layer.int8_amax


@torch.no_grad()
def calibrate_int8(
    model: nn.Module,
    batches: Iterable[torch.Tensor],
    *,
    int8_pointwise: Union[bool, int] = True,
) -> Dict[str, float]:
    """Per-site activation amax for the int8 pointwise path: the
    counterpart of the JAX ``calibrate_int8``.

    Runs the eval-mode ``model`` over ``batches`` (inputs normalized as
    inference normalizes them, on the model's device and in its compute
    dtype) with int8 on at ``int8_pointwise`` and dynamic scales, and
    returns ``{site: max |activation|}`` over all batches: the
    ``int8_scales`` to serve with.  ``int8_pointwise`` should be the flag
    inference will use, so the recorded sites are the active ones.  The
    model's own int8 settings are restored afterwards.
    """
    layers = [m for m in model.modules() if isinstance(m, KerasLayer)]
    saved = [(m.int8_pointwise, m.int8_scale) for m in layers]
    set_int8(model, int8_pointwise, None)
    try:
        with recording_int8_amax(model) as amax:
            for x in batches:
                model(x)
    finally:
        for m, (flag, scale) in zip(layers, saved):
            m.int8_pointwise, m.int8_scale = flag, scale
    return {site: float(v) for site, v in amax.items()}


def set_data_group(model: nn.Module, group) -> nn.Module:
    """Make train-mode BatchNorm in ``model`` normalise with the statistics
    of the global batch whose rows the ranks of ``group`` hold (the JAX
    step's ``jnp.mean``/``jnp.var`` over the sharded batch); ``None``
    restores the local batch."""
    for layer in model.modules():
        if isinstance(layer, KerasLayer):
            layer.data_group = group
    return model


def set_remat(model: nn.Module, on: bool = True) -> nn.Module:
    """Rematerialise ``model``'s stages in training (the JAX
    ``Trainer(remat=True)``): see :func:`nn.layers.stage`."""
    for m in model.modules():
        m.remat = on
    return model


def param_count(model: nn.Module) -> int:
    """Number of trainable scalars (Keras "Trainable params")."""
    return sum(p.numel() for p in model.parameters())


def state_count(model: nn.Module) -> int:
    return sum(b.numel() for b in model.buffers())
