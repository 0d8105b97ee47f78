"""Reader for the JAX package's ``.npz`` checkpoints, with numpy alone.

A checkpoint written by ``building_detection_tpu.train.checkpoint.save_variables``
holds flat keys ``params||<name>``, ``state||<name>``, ``opt||...`` and
``meta||...``.  Serving needs the params and the BN state; the optimizer
state and the Keras ``.h5`` import come with the trainer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SEP = "||"  # flat-key separator inside npz archives


def load_variables(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Read ``(params, state)`` as flat dicts keyed by JAX layer names."""
    params: Dict[str, np.ndarray] = {}
    state: Dict[str, np.ndarray] = {}
    with np.load(path) as z:
        for key in z.files:
            kind, name = key.split(SEP, 1)
            if kind == "params":
                params[name] = z[key]
            elif kind == "state":
                state[name] = z[key]
    return params, state
