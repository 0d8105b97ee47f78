"""``.npz`` checkpoints in the JAX package's format, with numpy alone.

The counterpart of ``building_detection_tpu/train/checkpoint.py`` (its
``.npz`` half).  A checkpoint holds flat keys ``params||<name>`` and
``state||<name>`` (JAX layouts, as :func:`core.module.jax_variables` gives
them), the optimizer state as ``opt||<key>`` in the JAX package's
flattening (``opt||.count``, ``opt||.mu['<name>']``, ``opt||.nu['<name>']``;
:meth:`train.optim.KerasAdam.jax_state`), ``meta||step`` and, optionally,
``meta||json`` as uint8 bytes.  Either package restores what the other
wrote.  The Keras ``.h5`` import and export are not ported.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

SEP = "||"  # flat-key separator inside npz archives

Flat = Dict[str, np.ndarray]


def save_variables(
    path: str,
    params: Mapping[str, np.ndarray],
    state: Mapping[str, np.ndarray],
    opt_state: Optional[Mapping[str, np.ndarray]] = None,
    step: int = 0,
    metadata: Optional[dict] = None,
) -> None:
    """Write a checkpoint atomically (a temporary file, then a rename);
    ``path`` should end in ``.npz``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {f"params{SEP}{k}": np.asarray(v) for k, v in params.items()}
    payload.update({f"state{SEP}{k}": np.asarray(v) for k, v in state.items()})
    for k, v in (opt_state or {}).items():
        payload[f"opt{SEP}{k}"] = np.asarray(v)
    payload[f"meta{SEP}step"] = np.asarray(step)
    if metadata:
        payload[f"meta{SEP}json"] = np.frombuffer(json.dumps(metadata).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_variables(path: str) -> Tuple[Flat, Flat, Flat, int, dict]:
    """Read ``(params, state, opt_state, step, metadata)``; ``opt_state`` is
    the flat ``{'.count': ..., ".mu['<name>']": ...}`` dict (empty when the
    checkpoint has none)."""
    params: Flat = {}
    state: Flat = {}
    opt: Flat = {}
    step, meta = 0, {}
    with np.load(path) as z:
        for key in z.files:
            kind, name = key.split(SEP, 1)
            if kind == "params":
                params[name] = z[key]
            elif kind == "state":
                state[name] = z[key]
            elif kind == "opt":
                opt[name] = z[key]
            elif kind == "meta" and name == "step":
                step = int(z[key])
            elif kind == "meta" and name == "json":
                meta = json.loads(z[key].tobytes().decode())
    return params, state, opt, step, meta


def check_matches_model(
    path: str,
    loaded_params: Mapping[str, np.ndarray],
    loaded_state: Mapping[str, np.ndarray],
    template_params: Mapping[str, np.ndarray],
    template_state: Mapping[str, np.ndarray],
    model_name: str,
) -> None:
    """Key sets and per-key shapes (JAX layouts) must match exactly, so a
    wrong-model ``.npz`` fails loudly instead of half-applying.  Raises
    ``ValueError`` naming the first mismatch."""
    for kind, theirs, ours in (
        ("params", loaded_params, template_params),
        ("state", loaded_state, template_state),
    ):
        if set(theirs) != set(ours):
            missing = sorted(set(ours) - set(theirs))[:3]
            extra = sorted(set(theirs) - set(ours))[:3]
            raise ValueError(
                f"{path} does not match model {model_name!r} ({kind} keys differ; "
                f"missing e.g. {missing}, unexpected e.g. {extra})"
            )
        for k in ours:
            if tuple(np.shape(theirs[k])) != tuple(np.shape(ours[k])):
                raise ValueError(
                    f"{path}: {kind}[{k!r}] shape {tuple(np.shape(theirs[k]))} "
                    f"!= model's {tuple(np.shape(ours[k]))}"
                )
