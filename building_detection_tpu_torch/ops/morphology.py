"""Binary morphology on tensors: flat erosion and dilation with cv2 semantics.

The counterpart of ``building_detection_tpu/ops/morphology.py``.  A flat
``(kh, kw)`` kernel applied ``n`` times is one pass of width ``n*(k-1)+1``;
the border contributes the identity (+inf for erosion, -inf for dilation),
so the image border never erodes inward.  Arrays are ``(..., H, W)`` floats.

:func:`edge_weight_maps` is the training target's edge band; on a CUDA
tensor it runs the hand-written kernel of
:mod:`building_detection_tpu_torch.kernels.edge_weights`.
:func:`majority_vote` and :func:`fill_holes` are the device forms of the
ensemble vote and the hole filling, off the serving path (its fusion runs
the host code in ``building_detection_tpu_torch.post``), as in the JAX
package.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _effective_kernel(kernel: IntPair, iterations: int) -> Tuple[int, int]:
    kh, kw = _pair(kernel)
    return (iterations * (kh - 1) + 1, iterations * (kw - 1) + 1)


def _window_max(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Centred ``(kh, kw)`` max filter over the last two axes, -inf outside
    (the first ``(k - 1) // 2`` of the window before the pixel)."""
    if not x.dtype.is_floating_point:
        raise TypeError(f"morphology takes floating tensors, got {x.dtype}")
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    y = x.reshape(-1, 1, h, w)
    pad = ((kw - 1) // 2, kw - 1 - (kw - 1) // 2, (kh - 1) // 2, kh - 1 - (kh - 1) // 2)
    y = F.max_pool2d(F.pad(y, pad, value=float("-inf")), (kh, kw), stride=1)
    return y.reshape(*lead, h, w)


def erode(x: torch.Tensor, kernel: IntPair, iterations: int = 1) -> torch.Tensor:
    """Min filter == ``cv2.erode(x, np.ones(kernel), iterations=n)``."""
    return -_window_max(-x, *_effective_kernel(kernel, iterations))


def dilate(x: torch.Tensor, kernel: IntPair, iterations: int = 1) -> torch.Tensor:
    """Max filter == ``cv2.dilate(x, np.ones(kernel), iterations=n)``."""
    return _window_max(x, *_effective_kernel(kernel, iterations))


def edge_weight_maps(
    label: torch.Tensor,
    kernel: int = 3,
    iterations: int = 5,
    weight: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-band weights for the edge focal loss, ``(f_edge, p_edge)``.

    The inner band (``label - erode == 1``) and the outer band (``dilate -
    label == 1``) of a {0,1} label get ``weight``, everything else 1.0.
    ``label`` is ``(..., H, W)``; it is computed as f32 ``(N, H, W)``.
    """
    from building_detection_tpu_torch.kernels import edge_weights as K

    label = label.to(torch.float32)
    shape = label.shape
    flat = label.reshape(-1, *shape[-2:]).contiguous()
    f_edge, p_edge = K.edge_weight_maps(flat, kernel, iterations, weight)
    return f_edge.reshape(shape), p_edge.reshape(shape)


def majority_vote(masks: torch.Tensor, threshold: int = 3) -> torch.Tensor:
    """Ensemble vote over binary {0,1} masks stacked on axis 0: 255 where
    at least ``threshold`` of them are set, else 0 (uint8), on the masks'
    device."""
    votes = torch.sum(masks.to(torch.int32), dim=0)
    return torch.where(votes >= threshold, 255, 0).to(torch.uint8)


def fill_holes_counted(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """:func:`fill_holes` and the number of grow steps it took (the last of
    them the one that changed nothing)."""
    mask = mask.to(torch.uint8)
    free = 1 - mask  # complement: background and holes (uint8, wrapping as the JAX function's)

    def grow(cur: torch.Tensor) -> torch.Tensor:
        return torch.minimum(dilate(cur.to(torch.float32), 3).to(torch.uint8), free)

    seed = torch.zeros_like(free)
    for rows, cols in ((0, slice(None)), (-1, slice(None)), (slice(None), 0), (slice(None), -1)):
        seed[..., rows, cols] = free[..., rows, cols]
    cur, steps = grow(seed), 1
    while True:  # the JAX while_loop: grow until a step changes nothing
        grown, steps = grow(cur), steps + 1
        if torch.equal(grown, cur):
            return 1 - cur, steps
        cur = grown


def fill_holes(mask: torch.Tensor, max_iters: int = 0) -> torch.Tensor:
    """Fill the interior holes of a binary {0,1} ``(..., H, W)`` mask on its
    device: the background grown from the border by masked 3x3 dilations
    (geodesic reconstruction) until a step changes nothing, inverted.  The
    reference fills the polygons of the external contours
    (``model_fuse.py:9-25``), which is the same set.

    ``max_iters`` is accepted and not read, as in the JAX function, whose
    ``while_loop`` runs to convergence whatever it is; the host pipelines
    use ``post.geometry``."""
    del max_iters
    return fill_holes_counted(mask)[0]
