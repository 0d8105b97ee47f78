"""The benchmark's only door into the program: building its members and
handing them the benchmark's weights.

Each member is built empty on the device with the program's registry and
filled, tensor by tensor, from ``{keras key: f32 tensor in Keras layout}``
through the program's own naming (``KerasLayer.jax_tensors``), strictly:
every key is used once and every tensor of the program is filled.  This is
``core.module.load_jax_variables`` without its round trip through host
numpy arrays, which would copy the five members' 800 MB of weights off the
card and back in every run's set-up.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from benchmark.reference.layers import TO_TORCH

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def program_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{keras key: tensor}`` over the program's model, in its layouts."""
    from building_detection_tpu_torch.core.module import KerasLayer

    out = {}
    for layer in model.modules():
        if isinstance(layer, KerasLayer):
            for _, key, t in layer.jax_tensors():
                if key in out:
                    raise ValueError(f"two program tensors claim {key!r}")
                out[key] = t
    return out


@torch.no_grad()
def fill(model: nn.Module, weights: Dict[str, torch.Tensor]) -> nn.Module:
    ours = program_tensors(model)
    if set(ours) != set(weights):
        missing, extra = sorted(set(ours) - set(weights))[:5], sorted(set(weights) - set(ours))[:5]
        raise ValueError(f"the program's tensors differ from the weights: missing {missing}, unexpected {extra}")
    for key, t in ours.items():
        w = weights[key]
        w = w.permute(TO_TORCH[w.dim()]) if w.dim() in TO_TORCH else w
        if tuple(w.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {tuple(w.shape)} != program {tuple(t.shape)}")
        t.copy_(w)
    return model


def build_member(name: str, device) -> nn.Module:
    """The program's member ``name``, its tensors allocated on ``device`` and
    not yet filled."""
    from building_detection_tpu_torch.models.registry import build_model

    with torch.device(device):
        return build_model(name)
