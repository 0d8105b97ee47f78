"""Model zoo registry: the counterpart of ``building_detection_tpu/models/registry.py``."""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from building_detection_tpu_torch.core.module import init_layers
from building_detection_tpu_torch.models.hrnet import HRNet
from building_detection_tpu_torch.models.res34_unet import Res34UNet
from building_detection_tpu_torch.models.scse_unet import SCSEUNet
from building_detection_tpu_torch.models.xception_deeplab import DeepLabV3P, DeepLabV3PBAM

MODEL_REGISTRY: Dict[str, Callable[[], nn.Module]] = {
    "res34": Res34UNet,
    "hrnet": HRNet,
    "v3plus": DeepLabV3P,
    "scse": SCSEUNet,
    "bam": DeepLabV3PBAM,
}

# Execution order of the reference ensemble.
ENSEMBLE_ORDER = ("res34", "hrnet", "v3plus", "scse", "bam")


def keras_layer_order(name: str) -> list:
    """tf_keras's ``model.layers`` order (its weight-bearing layers) for one
    zoo model built with fresh name counters.

    Keras' positional ``model.load_weights`` pairs an ``.h5``'s layer groups
    with ``model.layers`` by position, and for a functional model that is
    graph depth order, not construction order (a residual block's main-path
    convs come before its shortcut).  ``export_h5_weights`` takes this list
    to write a file the reference's own code loads.  ``keras_layer_order.json``
    beside this file is a byte-for-byte copy of the JAX package's, which was
    extracted from the reference models under tf_keras 2.21.
    """
    with open(os.path.join(os.path.dirname(__file__), "keras_layer_order.json")) as f:
        orders = json.load(f)
    try:
        return orders[name]
    except KeyError:
        raise ValueError(f"no canonical Keras layer order for {name!r}; available: {sorted(orders)}") from None


def build_model(name: str) -> nn.Module:
    """The named model with uninitialised tensors, in eval mode on the CPU."""
    try:
        cls = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}") from None
    return cls().eval()


def init_model(
    name: str,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
) -> nn.Module:
    """The named model with Keras-initialised weights, drawn on the CPU from
    ``generator`` (a CPU generator), then moved to ``device``."""
    model = init_layers(build_model(name), generator)
    return model.to(device) if device is not None else model
