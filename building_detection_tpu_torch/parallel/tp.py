"""Channel tensor parallelism: every parameter's out-channels sharded over
the mesh's ``model`` axis.

The counterpart of ``building_detection_tpu/parallel/tp.py``.  The JAX
package annotates each parameter with a sharding and lets XLA's SPMD
partitioner place the collectives; here the decision is the same rule on
the same JAX names and shapes (:func:`_spec_for`: a tensor shards its out
dim where the axis divides it, everything else stays replicated, as the
1-channel sSE gates and the 2-class head at ``model`` 4 or 8 do), and the
layers carry it out (their ``TP_GROUPS`` and the plans of ``nn/layers.py``):

* over processes (training, and inference in ``TiledPredictor`` over a
  mesh that spans processes; :func:`tp_shard`): each rank keeps its model
  index's slice of every sharded parameter, Keras Adam moment and
  BatchNorm statistic, and a sharded layer runs ``gather_channels(op(copy_to_model(x), W_r))`` over
  the model group (in eval mode a BatchNorm normalizes its input's slice
  with its slice of the moving statistics; under ``torch.inference_mode``
  ``copy_to_model`` is the identity it is in every forward).
  :func:`gather_checkpoint` puts the slices back together
  for a checkpoint, :func:`local_variables` and :func:`local_opt_state` cut
  a checkpoint into them;
* in one process over the local devices of a mesh (inference,
  :func:`tp_device_replicas`): each data row's replica holds only the
  slices, each on its model device, and a sharded layer runs each slice's
  op on its device and concatenates the results on the row's first device.

The port stores kernels in torch layouts (``Conv2d`` OIHW, the transposed
conv ``(in, out, kh, kw)``, ``Dense`` ``(out, in)``), so a decision taken on
the JAX shape is mapped through :func:`core.module.torch_axis` onto the
stored tensor.  The results equal the single-device program's to float
noise (``tests/test_torch_tp.py``).
"""
from __future__ import annotations

import copy
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from building_detection_tpu_torch.core.module import KerasLayer, jax_templates, jax_variables, torch_axis
from building_detection_tpu_torch.nn.layers import DeviceShards, ProcessShards
from building_detection_tpu_torch.parallel.mesh import Mesh, mesh_devices

Dims = Dict[str, Optional[int]]


def _spec_for(name: str, shape, axis_size: int) -> Optional[int]:
    """The JAX package's rule on a JAX name and shape: the out-channel dim
    (JAX layout) to shard where ``axis_size`` divides it, else ``None``
    (replicated).  Conv kernels ``(kh, kw, in, out)`` shard dim -1, the
    transposed conv's ``(kh, kw, out, in)`` dim -2, dense ``(in, out)``,
    biases and BN scales dim -1, the depthwise kernel ``(kh, kw, 1, in)``
    its channels, dim -1."""
    ndim = len(shape)
    if ndim == 0:
        return None
    if "conv2d_transpose" in name and name.endswith("kernel") and ndim == 4:
        out_dim = ndim - 2
    else:
        out_dim = ndim - 1
    return out_dim if shape[out_dim] % axis_size == 0 and shape[out_dim] >= axis_size else None


def _state_dim(shape, axis_size: int) -> Optional[int]:
    """``tp_replicate_state``'s rule: a 1-D statistic the axis divides shards."""
    return 0 if len(shape) == 1 and shape[0] % axis_size == 0 and shape[0] >= axis_size else None


def tp_dims(model: nn.Module, axis_size: int) -> Dict[str, Dims]:
    """``{'params' | 'state': {JAX key: sharded JAX dim or None}}`` of
    ``model`` at a model axis of ``axis_size``, on the full JAX shapes."""
    params, state = jax_templates(model)
    return {
        "params": {k: _spec_for(k, v.shape, axis_size) for k, v in params.items()},
        "state": {k: _state_dim(v.shape, axis_size) for k, v in state.items()},
    }


def _sharded_groups(model: nn.Module, axis_size: int) -> Iterator[Tuple[str, KerasLayer, str, Dict[str, int]]]:
    """``(module name, layer, first leaf, {leaf: torch dim})`` of every
    parameter group the rule shards.  A group shares one channel axis, so
    its tensors shard together or not at all; anything else raises."""
    dims = tp_dims(model, axis_size)
    every = {**dims["params"], **dims["state"]}
    for name, layer in model.named_modules():
        if not isinstance(layer, KerasLayer):
            continue
        for first, (leaves, _) in layer.TP_GROUPS.items():
            chosen = {leaf: every[f"{layer.jax_name}/{leaf}"] for leaf in leaves if f"{layer.jax_name}/{leaf}" in every}
            if all(d is None for d in chosen.values()):
                continue
            if any(d is None for d in chosen.values()):
                raise ValueError(f"{layer.jax_name}: the tensors {sorted(chosen)} share one channel axis but only "
                                 f"some of them shard at model={axis_size}")
            yield name, layer, first, {leaf: torch_axis(d, len(layer.inits[leaf][0])) for leaf, d in chosen.items()}


def _slice(t: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    k = t.shape[dim] // size
    return t.detach().narrow(dim, index * k, k).clone()


# -- over processes (training and inference) ------------------------------------------
def tp_shard(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's model-index slice of every parameter and 1-D
    BatchNorm statistic the rule shards over ``mesh``'s model axis, in
    place (the JAX ``tp_shard_params`` and ``tp_replicate_state`` in one
    walk), and make the layers compute through the model group.  Call it
    once on every rank of the mesh, with the same full weights, before the
    optimizer takes the parameters (training) or after the cast to the
    compute dtype (inference: the slices keep the tensors' dtype).  A mesh
    with no model group (not from ``make_mesh`` under a process group)
    raises."""
    if mesh.model_group is None:
        raise ValueError(
            f"channel TP over processes at model={mesh.model} needs the mesh's model group: build the mesh with "
            "make_mesh(data=..., model=...) on every rank of the process group (a mesh of this process's local "
            "devices, make_mesh(devices=[...]), runs TP in one process)"
        )
    for _, layer, first, dims in _sharded_groups(model, mesh.model):
        for leaf, dim in dims.items():
            t = getattr(layer, leaf)
            piece = _slice(t, dim, mesh.model_index, mesh.model)
            if leaf in layer._parameters:
                layer.register_parameter(leaf, nn.Parameter(piece, requires_grad=t.requires_grad))
            else:
                layer.register_buffer(leaf, piece)
        layer.tp = {**(layer.tp or {}), first: ProcessShards(mesh.model_group, mesh.model_index, mesh.model)}
    return model


def tp_tensors(model: nn.Module) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``(sharded, replicated)``: the model's tensors that are a rank's
    slice under TP, and the ones every rank holds whole."""
    sharded, replicated = [], []
    for layer in model.modules():
        if not isinstance(layer, KerasLayer):
            continue
        planned = {leaf for first in (layer.tp or {}) for leaf in layer.TP_GROUPS[first][0]}
        for _, key, t in layer.jax_tensors():
            (sharded if key.rsplit("/", 1)[1] in planned else replicated).append(t)
    return sharded, replicated


def _opt_dims(dims: Dims) -> Dims:
    out: Dims = {".count": None}
    for attr in ("mu", "nu"):
        out.update({f".{attr}['{k}']": d for k, d in dims.items()})
    return out


def _gather(flat: Mapping[str, np.ndarray], dims: Dims, mesh: Mesh, device) -> Dict[str, np.ndarray]:
    """The full arrays of ``flat`` (this rank's slices, JAX layout): the
    sharded ones all-gathered over the model group in one flat buffer and
    concatenated along their dims in model order."""
    out = dict(flat)
    keys = [k for k in flat if dims.get(k) is not None]
    if not keys:
        return out
    buf = torch.from_numpy(np.concatenate([np.asarray(flat[k], np.float32).ravel() for k in keys])).to(device)
    parts = [torch.empty_like(buf) for _ in range(mesh.model)]
    dist.all_gather(parts, buf, group=mesh.model_group)
    host = [p.cpu().numpy() for p in parts]
    offset = 0
    for k in keys:
        shape, n = np.shape(flat[k]), int(np.size(flat[k]))
        out[k] = np.concatenate([h[offset : offset + n].reshape(shape) for h in host], axis=dims[k])
        offset += n
    return out


def gather_checkpoint(model: nn.Module, optimizer, mesh: Mesh):
    """``(params, state, optimizer state)`` of a TP model as one process
    would hold them (the JAX ``.npz`` flat dicts), its slices gathered over
    the model group.  Collective: every rank of the model group calls it."""
    device = next(model.parameters()).device
    dims = tp_dims(model, mesh.model)
    params, state = jax_variables(model)
    return (_gather(params, dims["params"], mesh, device), _gather(state, dims["state"], mesh, device),
            _gather(optimizer.jax_state(), _opt_dims(dims["params"]), mesh, device))


def _local(flat: Mapping[str, np.ndarray], dims: Dims, mesh: Mesh) -> Dict[str, np.ndarray]:
    out = {}
    for k, a in flat.items():
        d = dims.get(k)
        if d is not None:
            size = np.shape(a)[d] // mesh.model
            a = np.ascontiguousarray(np.take(a, range(mesh.model_index * size, (mesh.model_index + 1) * size), axis=d))
        out[k] = a
    return out


def local_variables(model: nn.Module, mesh: Mesh, params: Mapping[str, np.ndarray], state: Mapping[str, np.ndarray]):
    """Full ``(params, state)`` flat dicts cut to this rank's slices, for
    :func:`core.module.load_jax_variables` on a TP model."""
    dims = tp_dims(model, mesh.model)
    return _local(params, dims["params"], mesh), _local(state, dims["state"], mesh)


def local_opt_state(model: nn.Module, mesh: Mesh, flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A full Keras Adam state (``.count``, ``.mu[...]``, ``.nu[...]``) cut
    to this rank's slices."""
    return _local(flat, _opt_dims(tp_dims(model, mesh.model)["params"]), mesh)


# -- one process over local devices (inference) ------------------------------------------
def tp_device_replicas(model: nn.Module, mesh: Mesh) -> Dict[torch.device, nn.Module]:
    """``{first device of a data row: replica}`` for a mesh of local devices.

    ``model`` sits on the first row's first device and becomes that row's
    replica; each other row gets a deep copy on its first device.  In every
    replica each sharded parameter group keeps no tensor of its own: slice
    ``j`` lives on the row's ``j``-th device, where the layer runs it
    (:class:`nn.layers.DeviceShards`).  Rows on the same devices share their
    replica, and a slice is stored once per device and model index.  Rows
    that share a first device must share all their devices."""
    devices, size = mesh_devices(mesh), mesh.model
    rows: Dict[torch.device, Tuple[torch.device, ...]] = {}
    for r in range(mesh.data):
        row = devices[r * size : (r + 1) * size]
        if rows.setdefault(row[0], row) != row:
            raise ValueError(f"mesh rows {rows[row[0]]} and {row} share their first device and differ in the others: "
                             "a predictor keeps one replica per first device")
    groups = list(_sharded_groups(model, size))
    slices: Dict[tuple, Dict[str, torch.Tensor]] = {}
    for name, layer, first, dims in groups:
        for row in rows.values():
            for j, device in enumerate(row):
                if (name, first, j, device) not in slices:
                    slices[name, first, j, device] = {
                        leaf: _slice(getattr(layer, leaf), dim, j, size).to(device) for leaf, dim in dims.items()
                    }
    home = next(iter(rows))
    replicas = {h: model if h == home else copy.deepcopy(model).to(h) for h in rows}
    for h, replica in replicas.items():
        layers = dict(replica.named_modules())
        for name, _, first, dims in groups:
            layer = layers[name]
            for leaf in dims:
                if leaf in layer._parameters:
                    layer.register_parameter(leaf, None)
                else:
                    layer.register_buffer(leaf, None)
            plan = DeviceShards(h, [(d, slices[name, first, j, d]) for j, d in enumerate(rows[h])])
            layer.tp = {**(layer.tp or {}), first: plan}
    return replicas
