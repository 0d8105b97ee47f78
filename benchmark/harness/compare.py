"""The numbers that decide ``correct``: the program's outputs against the reference's.

Masks (one number of each kind over every member and every sampled scene):

* ``flip_share``: the largest share, over the members, of the pixels whose
  bit differs from the reference's (``margin > 0``);
* ``far_flip_share``: the largest share of the pixels whose bit differs
  although the reference's margin is at least ``FAR`` times the median
  ``|margin|`` of that member's pixels.  Rounding flips pixels near their
  boundary; a tile left out or a bit altered flips pixels wherever they lie;
* ``flip_gap`` (reported, not compared): the widest margin among the flipped
  pixels over that median.

Training (three steps from the same weights on the same batches):

* ``loss_gap``: the largest ``|loss - reference loss| / |reference loss|``
  over the steps;
* ``grad_gap``: the worst leaf's ``|‖g‖ - ‖g_ref‖|``, over the larger of
  ``‖g_ref‖`` and the median leaf's ``‖g_ref‖``, for the first step's
  gradient; ``grad_median_gap`` the median leaf's;
* ``change_gap`` and ``change_median_gap``: the same for the change of
  every tensor after the steps (parameters, and apart from them the BN
  moving statistics).

Leaves whose reference gradient is under a thousandth of the median leaf's
(a conv bias right before a train-mode BN, which the normalization cancels)
move under Adam by round-off alone, and are left out of both gradient and
change.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Set

import numpy as np
import torch

NEGLIGIBLE = 1e-3  # of the median leaf's reference gradient norm
FAR = 0.5  # of the median |margin|


def mask_numbers(program: List[Dict[str, np.ndarray]], margins: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """``program``: per sampled scene, ``{member: (H, W) uint8 mask}``;
    ``margins``: per scene, ``{member: (H, W) reference margins}``."""
    share, far, gap = 0.0, 0.0, 0.0
    for member in margins[0]:
        d = torch.cat([m[member].flatten().float().cpu() for m in margins])
        bits = torch.cat([torch.from_numpy(np.ascontiguousarray(p[member])).flatten() > 0 for p in program])
        flips = bits != (d > 0)
        scale = float(d.abs().median().clamp_min(1e-30))
        share = max(share, float(flips.float().mean()))
        far = max(far, float((flips & (d.abs() >= FAR * scale)).float().mean()))
        if bool(flips.any()):
            gap = max(gap, float(d[flips].abs().max()) / scale)
    return {"flip_share": share, "far_flip_share": far, "flip_gap": gap}


def kept_leaves(ref_grad_norms: Dict[str, float]) -> Set[str]:
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= NEGLIGIBLE * med}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float], keys: Iterable[str]) -> Dict[str, float]:
    """``|program - reference|`` of each leaf's norm over the larger of the
    reference's norm and the median leaf's."""
    keys = list(keys)
    if not keys:
        return {}
    med = statistics.median(reference[k] for k in keys)
    return {k: abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in keys}


def train_numbers(
    program_loss: np.ndarray,
    program_grad_norms: Dict[str, float],
    program_change_norms: Dict[str, float],
    reference_loss: np.ndarray,
    reference_grad_norms: Dict[str, float],
    reference_change_norms: Dict[str, float],
    state_keys: Optional[Set[str]] = None,
    worst: Optional[Dict[str, str]] = None,
) -> Dict[str, float]:
    """The loss, gradient and change gaps; ``*_median_gap`` is the median
    leaf's gap where ``*_gap`` is the worst leaf's.  ``worst``, if given,
    gets the worst leaves' names."""
    keep = sorted(kept_leaves(reference_grad_norms))
    state_keys = sorted(state_keys or ())
    ref_loss = np.asarray(reference_loss, np.float64)
    loss = np.abs(np.asarray(program_loss, np.float64) - ref_loss) / np.abs(ref_loss)
    grad = leaf_gaps(program_grad_norms, reference_grad_norms, keep)
    change = leaf_gaps(program_change_norms, reference_change_norms, keep)
    change_state = leaf_gaps(program_change_norms, reference_change_norms, state_keys)
    both = {**change, **change_state}
    if worst is not None:
        worst.update(grad=max(grad, key=grad.get), change=max(both, key=both.get))
    return {
        "loss_gap": float(loss.max()),
        "grad_gap": max(grad.values()),
        "grad_median_gap": statistics.median(grad.values()),
        "change_gap": max(both.values()),
        "change_median_gap": max(statistics.median(change.values()),
                                 statistics.median(change_state.values()) if change_state else 0.0),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing or non-finite number fails)."""
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= lim for k, lim in limits.items())
