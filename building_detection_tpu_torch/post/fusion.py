"""Ensemble mask fusion: morphological vote over the 5 model masks.

Behavioural rebuild of ``model_confuse`` (`reference/model_fuse.py:271-376`)
as pure array functions — masks flow in memory, not through PNG files:

* :func:`clean_mask` == ``fill_and_delete`` (`model_fuse.py:9-32`): keep
  top-level components with polygon area > ``min_area``, holes filled;
* :func:`split_touching` == ``eroede_dilate_process`` (`model_fuse.py:173-218`):
  per component, erode with 1x5 / 5x1 kernels x5 iterations to split
  horizontally/vertically touching buildings, drop sub-500 fragments, dilate
  the pieces back (`model_fuse.py:35-117`);
* :func:`fuse_masks` == the full pipeline: per-mask cleanup, 3-of-5 majority
  vote (`model_fuse.py:315-323`), final cleanup pass, fused mask out
  (`model_fuse.py:339-350`).

The port's own copy of ``building_detection_tpu/post/fusion.py``.  Pixel
parity with a cv2 transcription of the reference is asserted for that
package in ``tests/test_fusion.py``, and this copy is held bit-equal to it in
``tests/test_torch_shared.py``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

from building_detection_tpu_torch.core.config import FuseConfig
from building_detection_tpu_torch.post import geometry as G

Mask = np.ndarray
Region = Tuple[np.ndarray, np.ndarray]  # (contour, filled raster uint8 {0,1})


def regions(mask: Mask) -> List[Region]:
    """(contour, hole-filled raster) per top-level component, label order."""
    contours = G.find_contours(mask)
    rasters = G.components_filled(mask)
    assert len(contours) == len(rasters)
    return list(zip(contours, rasters))


def clean_mask(mask: Mask, min_area: float) -> List[Region]:
    """``fill_and_delete``: drop components with polygon area <= min_area,
    fill holes of the survivors (`model_fuse.py:9-32`)."""
    return [
        (c, r) for c, r in regions(mask) if G.contour_area(c) > min_area
    ]


def _erode_split(
    raster: Mask, kernel: Tuple[int, int], iterations: int, frag_area: float
) -> Union[None, bool, List[Mask]]:
    """``erode_process``/``erode_process1`` (`model_fuse.py:65-117`).

    Returns None (no split), False (everything eroded away), or the list of
    hole-filled, re-dilated piece rasters.
    """
    img = raster * np.uint8(255)
    eroded = G.erode_np(img, kernel, iterations)
    pieces = regions(eroded)
    if len(pieces) == 1:
        return None
    # fill_small_target: delete fragments with polygon area <= 500
    kept = [(c, r) for c, r in pieces if G.contour_area(c) > frag_area]
    if len(kept) < len(pieces) and not kept:
        return False
    out = []
    for _, r in kept:
        dilated = G.dilate_np(r * np.uint8(255), kernel, iterations)
        out.append((dilated > 0).astype(np.uint8))
    return out


def split_touching(
    region_list: Sequence[Region], cfg: FuseConfig = FuseConfig()
) -> List[Mask]:
    """``eroede_dilate_process``: per component, try horizontal and vertical
    erosion splits; combine per the reference's tri-state logic
    (`model_fuse.py:183-215`)."""
    k, it, frag = cfg.split_kernel, cfg.split_iterations, cfg.fragment_min_area
    out: List[Mask] = []
    for contour, raster in region_list:
        horiz = _erode_split(raster, (1, k), it, frag)
        vert = _erode_split(raster, (k, 1), it, frag)
        if horiz is False or vert is False:
            continue  # component vanished under erosion: dropped entirely
        if horiz is None and vert is None:
            out.append(raster)
        elif horiz is not None and vert is not None:
            out.extend(horiz)
            out.extend(vert)
        elif horiz is not None:
            out.extend(horiz)
        else:
            out.extend(vert)
    return out


def process_mask(mask: Mask, cfg: FuseConfig = FuseConfig()) -> Mask:
    """Cleanup + split for one model mask; {0,255} out (`model_fuse.py:285-289`).

    Dispatches to the C++ fast path (``bd_process_mask``) when the native
    library is available: identical semantics, but the per-component
    erode-splits run on bbox-cropped windows instead of full-size canvases —
    the NumPy path costs O(components x H x W) in scipy passes (measured
    51 s for one dense 2048^2 mask), the native path milliseconds.
    Equivalence is fuzzed in ``tests/test_fusion.py``.
    """
    nat = G.native()
    if nat is not None:
        binarized = np.ascontiguousarray(
            (np.asarray(mask) != 0).astype(np.uint8)
        )
        return nat.process_mask(
            binarized,
            cfg.min_area,
            cfg.split_kernel,
            cfg.split_iterations,
            cfg.fragment_min_area,
        )
    return _process_mask_py(mask, cfg)


def _process_mask_py(mask: Mask, cfg: FuseConfig = FuseConfig()) -> Mask:
    """Pure NumPy/scipy implementation of :func:`process_mask` (the
    reference algorithm the native path is fuzzed against)."""
    kept = clean_mask(mask, cfg.min_area)
    pieces = split_touching(kept, cfg)
    out = np.zeros(mask.shape[:2], np.uint8)
    for p in pieces:
        np.maximum(out, p, out=out)
    return out * np.uint8(255)


def fuse_masks(
    masks: Sequence[Mask], cfg: FuseConfig = FuseConfig()
) -> Mask:
    """Full 5-mask fusion -> final {0,255} result mask (`model_fuse.py:271-350`).

    ``masks`` order is irrelevant to the vote; the reference reads them in
    glob (alphabetical) order (`model_fuse.py:278`).
    """
    if len(masks) != cfg.num_models:
        raise ValueError(
            f"expected {cfg.num_models} masks, got {len(masks)} "
            "(the reference aborts on any other count, model_fuse.py:281)"
        )
    # per-mask processing stays sequential: a thread pool over the 5 members
    # was measured twice and never paid — round 2's NumPy path convoyed on
    # the GIL, and the native path (which releases the GIL) is
    # memory-latency-bound in its flood fills, 0.96x with 5 threads
    processed = [process_mask(m, cfg) for m in masks]
    votes = np.zeros(masks[0].shape[:2], np.int32)
    for p in processed:
        votes += p // 255
    voted = np.where(votes >= cfg.vote_threshold, 255, 0).astype(np.uint8)

    # final cleanup pass on the voted mask (`model_fuse.py:339-345`) — the
    # same per-mask cleanup+split as above
    return process_mask(voted, cfg)
