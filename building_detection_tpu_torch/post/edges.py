"""Contour refinement and polygon corner extraction.

Behavioural rebuild of ``_detection`` (`reference/edge_3.py:310-387`):

1. clean the fused mask (fill holes, drop polygon area <= 100,
   `edge_3.py:323-329`);
2. detect buildings merged corner-to-corner by comparing contour counts
   before/after 1x7 and 7x1 erosion, matching pre/post contours by bbox
   IoU > 0.5, replacing disappeared contours and adding the split pieces
   (`edge_3.py:26-47,159-262`);
3. per contour, area-classed polygon simplification with the reference's
   epsilon table, including its 300..3000 gap that falls through to the
   default epsilon (`edge_3.py:357-378`), the quadrilateral-seeking
   ``small_target`` loop with minAreaRect fallback (`edge_3.py:265-286`),
   and the m00 <= 10 moment skip (`edge_3.py:359-362`);
4. rings are closed by re-appending the first point (`edge_3.py:379-385`).

Returns ``(corners, height)`` where corners is ``[[x_list, y_list], ...]`` —
the exact structure the serving layer stringifies (`buildAPI.py:128-143`).

The port's own copy of ``building_detection_tpu/post/edges.py``, held equal
to it in ``tests/test_torch_shared.py``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from building_detection_tpu_torch.core.config import EdgeConfig
from building_detection_tpu_torch.post import geometry as G

Mask = np.ndarray
BBox = List[int]  # [xmin, ymin, xmax, ymax, contour_index]


def _bbox_of(contour: np.ndarray, idx: int) -> BBox:
    x, y, w, h = G.bounding_rect(contour)
    return [x, y, x + w, y + h, idx]


def _iou_match(bbox: BBox, others: List[BBox], thresh: float) -> Optional[int]:
    """Index of the best IoU>thresh match in ``others`` (`edge_3.py:26-47`)."""
    if not others:
        return None
    a = np.asarray(bbox[:4], np.float64)
    b = np.asarray([o[:4] for o in others], np.float64)
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:4], b[:, 2:4])
    wh = np.maximum(rb - lt, 0)
    inter = wh[:, 0] * wh[:, 1]
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / (area_a + area_b - inter)
    if np.any(iou > thresh):
        return int(np.argmax(iou))
    return None


def _match_sets(
    initial: List[Optional[np.ndarray]],
    eroded: List[np.ndarray],
    thresh: float,
) -> Tuple[List[BBox], List[BBox]]:
    """``process_td``/``process_rl``: (disappeared initial, added eroded)
    bboxes (`edge_3.py:50-121`).  None entries get a zero bbox, as in
    ``process_rl`` (`edge_3.py:91-93`)."""
    init_bbox = [
        [0, 0, 0, 0, j] if c is None else _bbox_of(c, j)
        for j, c in enumerate(initial)
    ]
    ero_bbox = [_bbox_of(c, j) for j, c in enumerate(eroded)]
    matched = []
    disappeared = []
    for b in init_bbox:
        res = _iou_match(b, ero_bbox, thresh)
        if res is None:
            disappeared.append(b)
        else:
            matched.append(res)
    added = [ero_bbox[i] for i in range(len(eroded)) if i not in matched]
    return disappeared, added


def _eroded_contours(
    mask: Mask, kernel: Tuple[int, int], cfg: EdgeConfig
) -> List[np.ndarray]:
    """Erode, drop fragments with area < 50 (`edge_3.py:124-144`)."""
    eroded = G.erode_np(mask, kernel, cfg.split_iterations)
    contours = G.find_contours(eroded)
    return [c for c in contours if G.contour_area(c) >= cfg.erode_fragment_area]


def detect_overlaps(
    mask: Mask, cfg: EdgeConfig = EdgeConfig()
) -> List[Optional[np.ndarray]]:
    """``detction_overlap_building`` (`edge_3.py:159-262`): the working
    contour set after splitting corner-merged buildings."""
    res1: List[Optional[np.ndarray]] = list(G.find_contours(mask))
    target_num = len(res1)

    contours_h = _eroded_contours(mask, (1, cfg.split_kernel), cfg)
    contours_v = _eroded_contours(mask, (cfg.split_kernel, 1), cfg)

    if len(contours_h) == target_num and len(contours_v) == target_num:
        return res1

    dis = add = dis1 = add1 = None
    if len(contours_h) != target_num:
        dis, add = _match_sets(res1, contours_h, cfg.bbox_iou_threshold)
    if len(contours_v) != target_num:
        dis1, add1 = _match_sets(res1, contours_v, cfg.bbox_iou_threshold)

    if dis is not None:
        for b in dis:
            res1[b[4]] = None
    if dis1 is not None:
        for b in dis1:
            res1[b[4]] = None

    # merge the added pieces (`edge_3.py:231-260`)
    if add is not None and add1 is not None:
        if len(add) >= 1 and len(add1) >= 1:
            matched_in_add1 = []
            for b in add:
                res = _iou_match(b, add1, cfg.bbox_iou_threshold)
                res1.append(contours_h[b[4]])
                if res is not None:
                    matched_in_add1.append(res)
            for i in range(len(add1)):
                if i in matched_in_add1:
                    continue
                res1.append(contours_v[add1[i][4]])
        elif len(add) >= 1:
            for b in add:
                res1.append(contours_h[b[4]])
        else:
            for b in add1:
                res1.append(contours_v[b[4]])
    elif add is not None:
        for b in add:
            res1.append(contours_h[b[4]])
    elif add1 is not None:
        for b in add1:
            res1.append(contours_v[b[4]])
    return res1


def _small_target(contour: np.ndarray, epsilon: float) -> np.ndarray:
    """Iterate toward a quadrilateral; fall back to the minimum-area
    rectangle (`edge_3.py:265-286`)."""
    points = G.approx_poly_dp(contour, epsilon, True).reshape(-1, 2)
    rate = 0.002
    count = 0
    while len(points) != 4:
        epsilon = rate * G.arc_length(contour, True)
        rate += 0.002
        points = G.approx_poly_dp(contour, epsilon, True).reshape(-1, 2)
        count += 1
        if count > 10:
            break
    if len(points) != 4:
        points = G.box_points(G.min_area_rect(contour))
    return points


def extract_polygons(
    mask: Mask, cfg: EdgeConfig = EdgeConfig()
) -> Tuple[List[List[list]], int]:
    """``_detection``: fused mask -> list of closed corner rings + height."""
    # step 1: fill holes, drop area <= 100 (`edge_3.py:323-329`)
    nat = G.native()
    if nat is not None:
        # native clean-only pass (split disabled): hole-filled components
        # with traced-polygon area > min_area, {0,255}
        cleaned = nat.process_mask(
            np.ascontiguousarray((np.asarray(mask) != 0).astype(np.uint8)),
            cfg.min_area,
            1,
            1,
            0.0,
            do_split=False,
        )
    else:
        kept = [
            (c, r)
            for c, r in zip(G.find_contours(mask), G.components_filled(mask))
            if G.contour_area(c) > cfg.min_area
        ]
        cleaned = np.zeros(mask.shape[:2], np.uint8)
        for _, r in kept:
            np.maximum(cleaned, r, out=cleaned)
        cleaned *= np.uint8(255)

    contours = detect_overlaps(cleaned, cfg)

    corners: List[List[list]] = []
    for c in contours:
        if c is None:
            continue
        area = G.contour_area(c)
        epsilon = cfg.default_rate * G.arc_length(c, True)
        if G.moments_m00(c) <= cfg.moment_min_m00:
            continue
        b0, b1, b2 = cfg.big_areas
        r0, r1, r2 = cfg.big_rates
        if area < cfg.small_area:
            points = _small_target(c, epsilon)
        elif cfg.small_area < area < cfg.mid_area:
            points = G.approx_poly_dp(c, 5 * epsilon, True).reshape(-1, 2)
        elif b0 < area < b1:
            points = G.approx_poly_dp(c, r0 * G.arc_length(c, True), True).reshape(-1, 2)
        elif b1 < area <= b2:
            points = G.approx_poly_dp(c, r1 * G.arc_length(c, True), True).reshape(-1, 2)
        elif area > b2:
            points = G.approx_poly_dp(c, r2 * G.arc_length(c, True), True).reshape(-1, 2)
        else:
            # the reference's 300..3000 gap (and boundary values) fall here
            points = G.approx_poly_dp(c, epsilon, True).reshape(-1, 2)
        xs = list(points[:, 0])
        xs.append(points[0, 0])
        ys = list(points[:, 1])
        ys.append(points[0, 1])
        corners.append([xs, ys])
    return corners, mask.shape[0]
