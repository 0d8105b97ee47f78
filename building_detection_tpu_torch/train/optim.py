"""Keras-exact Adam over named parameters.

The counterpart of ``building_detection_tpu/train/optim.py::keras_adam``.
Keras folds both bias corrections into the step size and adds the raw
epsilon to ``sqrt(v)``::

    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    p   -= lr_t * m / (sqrt(v) + eps)

``torch.optim.Adam`` adds epsilon to the bias-corrected ``sqrt(v_hat)``, as
optax does, which is a ~30x larger effective epsilon on the first step, so
it cannot stand in.  ``learning_rate`` is a float or a schedule evaluated at
the update count *before* the increment.  The moments are kept in f32 beside
the f32 params, keyed by the params' JAX names, so a checkpoint carries them
in the JAX package's ``opt||.count``/``opt||.mu['<name>']``/``opt||.nu[...]``
form (:meth:`jax_state`).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Union

import numpy as np
import torch

from building_detection_tpu_torch.core.module import to_jax_layout, to_torch_layout


class KerasAdam:
    """``tf_keras.optimizers.Adam`` (non-amsgrad) over ``{jax name: param}``."""

    def __init__(
        self,
        params: Mapping[str, torch.nn.Parameter],
        learning_rate: Union[float, Callable[[int], float]],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-7,
    ):
        self.params = dict(params)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0  # updates applied so far
        self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}

    def lr_t(self) -> float:
        """The step size of the next update, in f32 as the JAX version
        computes it."""
        lr = self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate
        t = np.float32(self.count + 1)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        return float(np.float32(lr) * np.sqrt(np.float32(1) - b2**t) / (np.float32(1) - b1**t))

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        """Apply one update from ``{name: grad}`` to the params in place."""
        lr_t = self.lr_t()
        b1, b2 = self.b1, self.b2
        for k, p in self.params.items():
            g = grads[k].float()
            m, v = self.mu[k], self.nu[k]
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * (g * g))
            p.add_(-lr_t * m / (torch.sqrt(v) + self.eps))
        self.count += 1

    def jax_state(self) -> Dict[str, np.ndarray]:
        """The state as the JAX package flattens ``KerasAdamState``: keys
        ``.count``, ``.mu['<name>']``, ``.nu['<name>']``, JAX layouts."""
        out = {".count": np.asarray(self.count, np.int32)}
        for attr in ("mu", "nu"):
            for k, t in getattr(self, attr).items():
                out[f".{attr}['{k}']"] = np.ascontiguousarray(to_jax_layout(t.detach().cpu().numpy()))
        return out

    @torch.no_grad()
    def load_jax_state(self, flat: Mapping[str, np.ndarray]) -> None:
        """Inverse of :meth:`jax_state`; the key sets must match exactly."""
        want = {".count"} | {f".{a}['{k}']" for a in ("mu", "nu") for k in self.params}
        if set(flat) != want:
            missing, extra = sorted(want - set(flat))[:3], sorted(set(flat) - want)[:3]
            raise ValueError(f"optimizer structure mismatch: missing {missing}, unexpected {extra}")
        for attr in ("mu", "nu"):
            for k, t in getattr(self, attr).items():
                value = to_torch_layout(np.asarray(flat[f".{attr}['{k}']"], np.float32))
                if tuple(value.shape) != tuple(t.shape):
                    raise ValueError(f"optimizer {attr}[{k!r}]: shape {value.shape} != {tuple(t.shape)}")
                t.copy_(torch.from_numpy(np.ascontiguousarray(value)))
        self.count = int(flat[".count"])
