"""Host-side contour/polygon geometry — the framework's replacement for the
reference's OpenCV C++ dependency.

The reference leans on ``cv2`` for all mask analytics
(`reference/model_fuse.py`, `reference/edge_3.py`): border
following, polygon area/perimeter, Douglas-Peucker simplification, minimum
area rectangles, hole filling.  These are sequential, branchy, small-data
algorithms, host-shaped rather than accelerator-shaped (SURVEY.md section
2), so this module implements them for the final masks on the host.

The port's own copy of ``building_detection_tpu/post/geometry.py``:

* the hot paths (`find_contours` tracing, `fill_holes`, the flat
  morphology) run the repository's C++ source ``native/src/geometry.cc``,
  built and loaded by :mod:`._native` (:func:`native`), with the NumPy/scipy
  code here as the always-available path where it cannot be built;
* semantics are pinned to OpenCV's by the JAX package's test suite
  (``tests/test_geometry.py``), and this copy to that package's by
  ``tests/test_torch_shared.py``, on both paths.

Contours are (N, 2) int32 arrays of (x, y) points, traced like
``cv2.findContours(mode=RETR_EXTERNAL, method=CHAIN_APPROX_NONE)`` —
Suzuki-Abe border following of 8-connected components, all border pixels.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
from scipy import ndimage

# 8-connectivity structure for foreground labeling (background is implicitly
# 4-connected, matching findContours' topology).
_STRUCT8 = np.ones((3, 3), np.int32)

# Moore neighbourhood in clockwise order starting from "west":
# (dy, dx) for directions W, NW, N, NE, E, SE, S, SW
_NEIGHBORS = np.array(
    [(0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1)],
    np.int32,
)


@functools.lru_cache(maxsize=None)
def native():
    """The C++ fast path (:mod:`._native`, built from ``native/src`` on first
    use), or None where it cannot be built: the NumPy/scipy code here is
    then the path, with the same results."""
    from building_detection_tpu_torch.post import _native

    try:
        _native.load()
    except (OSError, RuntimeError):
        return None
    return _native


# ---------------------------------------------------------------------------
# Border following
# ---------------------------------------------------------------------------
def _trace_border(mask: np.ndarray, start: Tuple[int, int]) -> np.ndarray:
    """Suzuki-Abe outer-border following from the raster-first border pixel.

    ``start`` is (row, col) of a foreground pixel whose west neighbour is
    background.  Returns the border pixels as (N, 2) (x, y), in the order
    cv2's CHAIN_APPROX_NONE emits them.
    """
    h, w = mask.shape
    i, j = start

    def pixel(y, x):
        return 0 <= y < h and 0 <= x < w and mask[y, x]

    # step 3.1: from the west neighbour, search CLOCKWISE around (i, j) for
    # the first foreground pixel
    first_dir = None
    for k in range(8):
        dy, dx = _NEIGHBORS[k % 8]
        if pixel(i + dy, j + dx):
            first_dir = k
            break
    if first_dir is None:  # isolated pixel
        return np.array([[j, i]], np.int32)

    i1, j1 = i + _NEIGHBORS[first_dir][0], j + _NEIGHBORS[first_dir][1]
    i2, j2 = i1, j1
    i3, j3 = i, j
    points = []
    while True:
        # step 3.3: search counterclockwise around (i3, j3), starting from
        # the next direction after (i2, j2)
        d2 = _dir_of(i2 - i3, j2 - j3)
        found = None
        for step in range(1, 9):
            k = (d2 - step) % 8  # counterclockwise
            dy, dx = _NEIGHBORS[k]
            if pixel(i3 + dy, j3 + dx):
                found = k
                break
        points.append((j3, i3))  # (x, y)
        i4, j4 = i3 + _NEIGHBORS[found][0], j3 + _NEIGHBORS[found][1]
        # step 3.5: stop when we return to the start in the initial config
        if (i4, j4) == (i, j) and (i3, j3) == (i1, j1):
            break
        i2, j2 = i3, j3
        i3, j3 = i4, j4
    return np.array(points, np.int32)


_DIR_LOOKUP = {(int(dy), int(dx)): k for k, (dy, dx) in enumerate(_NEIGHBORS)}


def _dir_of(dy: int, dx: int) -> int:
    return _DIR_LOOKUP[(dy, dx)]


def find_contours(mask: np.ndarray) -> List[np.ndarray]:
    """External contours of all top-level 8-connected components.

    Equivalent to ``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_NONE)``
    for binary masks: components nested inside holes of other components are
    not reported.  Point sequences match cv2's border following, and the
    LIST ORDER matches cv2 too: reverse raster order of discovery (cv2
    head-inserts each new top-level contour; verified exactly against cv2 on
    400 randomized masks incl. dense noise and checkerboards).  The ring
    order is user-visible through ``extract_polygons`` -> the points dict
    (`buildAPI.py:128-143`), so it is part of the parity contract.
    """
    mask = np.ascontiguousarray((np.asarray(mask) != 0).astype(np.uint8))
    nat = native()
    found = nat.find_contours(mask) if nat is not None else _find_contours_py(mask)
    return found[::-1]


def _find_contours_py(mask: np.ndarray) -> List[np.ndarray]:
    """Pure NumPy/scipy fallback for :func:`find_contours` (raster order;
    the public wrapper reverses into cv2 order)."""
    # top-level components: label the hole-filled mask
    filled = ndimage.binary_fill_holes(mask)
    labels, n = ndimage.label(filled, structure=_STRUCT8)
    contours = []
    for lbl in range(1, n + 1):
        region = labels == lbl
        ys, xs = np.nonzero(region)
        # raster-first border pixel: topmost row, leftmost column
        top = ys.min()
        left = xs[ys == top].min()
        contours.append(_trace_border(region, (int(top), int(left))))
    return contours


# ---------------------------------------------------------------------------
# Contour analytics (cv2 semantics)
# ---------------------------------------------------------------------------
def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea``: |Green's formula| over the point polygon."""
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    x, y = pts[:, 0], pts[:, 1]
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    return abs(float(np.sum(x * y1 - x1 * y)) / 2.0)


def signed_area(contour: np.ndarray) -> float:
    """Green's formula with sign (== ``cv2.moments(c)['m00']`` for contours)."""
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    x, y = pts[:, 0], pts[:, 1]
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    return float(np.sum(x * y1 - x1 * y)) / 2.0


def bounding_rect(contour: np.ndarray) -> Tuple[int, int, int, int]:
    """``cv2.boundingRect``: (x, y, w, h) with inclusive +1 extents."""
    pts = np.asarray(contour).reshape(-1, 2)
    x0, y0 = pts[:, 0].min(), pts[:, 1].min()
    x1, y1 = pts[:, 0].max(), pts[:, 1].max()
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    """``cv2.arcLength``: polyline length, optionally closing the ring."""
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(pts) < 2:
        return 0.0
    if closed:
        pts = np.concatenate([pts, pts[:1]], axis=0)
    seg = pts[1:] - pts[:-1]
    # cv2 rounds each segment length to float32 before accumulating
    lengths = np.sqrt((seg**2).sum(axis=1)).astype(np.float32)
    return float(lengths.astype(np.float64).sum())


def moments_m00(contour: np.ndarray) -> float:
    """``cv2.moments(c)['m00']`` (contour moments are polygon integrals)."""
    return abs(signed_area(contour))


# ---------------------------------------------------------------------------
# Polygon simplification (cv2.approxPolyDP semantics)
# ---------------------------------------------------------------------------
def approx_poly_dp(contour: np.ndarray, epsilon: float, closed: bool = True) -> np.ndarray:
    """Douglas-Peucker reproducing ``cv2.approxPolyDP`` decisions exactly.

    OpenCV's algorithm for closed curves (validated point-for-point against
    cv2 in ``tests/test_geometry.py``):

    1. three iterations of farthest-point search pick the initial chord
       (from point 0 -> F1, F1 -> F2, F2 -> F3; slices are (F2,F3), (F3,F2));
    2. recursive splitting keeps each slice's start point when the max
       point-to-SEGMENT distance satisfies ``d^2 <= eps^2``; the far point is
       the first max in scan order of the UNNORMALISED score ``d^2 *
       |chord|^2`` (cross^2 for interior projections, endpoint distance^2 *
       |chord|^2 for clamped ones) — exact in float64 on pixel grids, so
       ties resolve deterministically;
    3. one final cleanup pass drops a point when it lies within
       ``sqrt(0.5) * eps`` of its neighbours' chord, the chord is not
       axis-aligned, and the successive inner product is non-negative —
       including OpenCV's in-place circular-buffer aliasing at the ring wrap.

    Matches the installed OpenCV (5.0) bit-for-bit: adversarial fuzz over
    64,954 contours x 5 epsilon rates (dense noise, blobs, checkerboards,
    1-px line webs — heavily self-touching) shows ZERO divergence
    (``tests/test_geometry.py::TestApproxPolyDP``).  Note cv2 4.x used the
    unnormalised CROSS distance in step 2 (no projection clamp); 5.x
    measures true segment distance.
    """
    pts = np.asarray(contour, np.int64).reshape(-1, 2)
    n = len(pts)
    if n <= 2 or epsilon < 0:
        return pts.astype(np.int32)
    eps2 = float(epsilon) * float(epsilon)

    if not closed:
        # Open curves are not used by the reference pipelines but kept
        # cv2-exact anyway: plain DP over [0, n-1] with the same
        # segment-distance scoring, then cv2's open-mode cleanup pass.
        # Duplicated closing points are trimmed first (cv2 behaviour; for
        # such ring-like "open" inputs cv2 actually reroutes to closed-curve
        # processing — a path no consumer uses, so after trimming we proceed
        # as a plain open curve and document the residual divergence).
        while n > 2 and (pts[0] == pts[-1]).all():
            pts = pts[:-1]
            n -= 1
        if n <= 2:
            return pts.astype(np.int32)
        stack = [(0, n - 1)]
        out = []
        while stack:
            a, b = stack.pop()
            if b - a <= 1:
                out.append(pts[a])
                continue
            pa, pb = pts[a], pts[b]
            dx, dy = float(pb[0] - pa[0]), float(pb[1] - pa[1])
            chord2 = dx * dx + dy * dy
            seg = pts[a + 1 : b].astype(np.float64)
            rx = seg[:, 0] - float(pa[0])
            ry = seg[:, 1] - float(pa[1])
            if chord2 == 0.0:
                score = rx * rx + ry * ry
                thresh = eps2
            else:
                cross = rx * dy - ry * dx
                t = rx * dx + ry * dy
                ex = seg[:, 0] - float(pb[0])
                ey = seg[:, 1] - float(pb[1])
                score = np.where(
                    t <= 0.0,
                    (rx * rx + ry * ry) * chord2,
                    np.where(
                        t >= chord2, (ex * ex + ey * ey) * chord2, cross * cross
                    ),
                )
                thresh = eps2 * chord2
            k = int(np.argmax(score))
            if float(score[k]) <= thresh:
                out.append(pts[a])
            else:
                far = a + 1 + k
                stack.append((far, b))
                stack.append((a, far))
        out.append(pts[n - 1])
        return _cleanup_pass(np.array(out, np.int64), eps2, closed=False)

    # -- stage 1: initial chord via 3 farthest-point iterations ------------
    pos = 0
    rs_start = 0
    le_eps = False
    for _ in range(3):
        pos = (pos + rs_start) % n
        start = pts[pos]
        order = (np.arange(1, n) + pos) % n
        d = pts[order] - start
        dist = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
        j = int(np.argmax(dist))  # first max (strict >)
        rs_start = j + 1  # offset from start
        le_eps = float(dist[j]) <= eps2
    if le_eps:
        return np.array([pts[pos]], np.int32)

    s_start = pos
    s_end = (pos + rs_start) % n
    # push right_slice (s_end -> s_start) first, then slice: pop order keeps
    # output in traversal order from s_start
    stack = [(s_end, s_start), (s_start, s_end)]
    out = []
    while stack:
        a, b = stack.pop()
        interior_start = (a + 1) % n
        if interior_start == b:
            out.append(pts[a])
            continue
        pa, pb = pts[a], pts[b]
        dx, dy = float(pb[0] - pa[0]), float(pb[1] - pa[1])
        chord2 = dx * dx + dy * dy
        count = (b - interior_start) % n
        order = (np.arange(count) + interior_start) % n
        seg = pts[order].astype(np.float64)
        rx = seg[:, 0] - float(pa[0])
        ry = seg[:, 1] - float(pa[1])
        if chord2 == 0.0:
            # degenerate chord (self-touching ring): plain point distance
            score = rx * rx + ry * ry
            thresh = eps2
        else:
            cross = rx * dy - ry * dx
            t = rx * dx + ry * dy
            ex = seg[:, 0] - float(pb[0])
            ey = seg[:, 1] - float(pb[1])
            score = np.where(
                t <= 0.0,
                (rx * rx + ry * ry) * chord2,
                np.where(t >= chord2, (ex * ex + ey * ey) * chord2, cross * cross),
            )
            thresh = eps2 * chord2
        k = int(np.argmax(score))
        if float(score[k]) <= thresh:
            out.append(pts[a])
        else:
            far = int(order[k])
            stack.append((far, b))
            stack.append((a, far))
    out = np.array(out, np.int64)

    # -- stage 3: single cleanup pass (cv2's exact semantics) --------------
    return _cleanup_pass(out, eps2, closed=True)


def _cleanup_pass(out: np.ndarray, eps2: float, closed: bool) -> np.ndarray:
    """cv2's final straight-line cleanup, both curve modes.

    OpenCV rewrites the output buffer IN PLACE while reading ahead of the
    write cursor; at the ring wrap the reads see already-cleaned points.
    That aliasing is part of the observable behaviour (verified against
    cv2 on dense noise contours), so the circular buffer is reproduced
    literally.
    """
    count = len(out)
    if count <= 2:
        return out.astype(np.int32)
    dst = [p.copy() for p in out]
    pos = count - 1 if closed else 0
    start_pt = dst[pos]
    pos = (pos + 1) % count
    wpos = pos
    pt = dst[pos]
    pos = (pos + 1) % count
    new_count = count
    i = 0 if closed else 1
    i_end = count if closed else count - 1
    while i < i_end and new_count > 2:
        end_pt = dst[pos]
        pos = (pos + 1) % count
        dx, dy = float(end_pt[0] - start_pt[0]), float(end_pt[1] - start_pt[1])
        dist = abs(
            float(pt[0] - start_pt[0]) * dy - float(pt[1] - start_pt[1]) * dx
        )
        sip = float(pt[0] - start_pt[0]) * float(end_pt[0] - pt[0]) + float(
            pt[1] - start_pt[1]
        ) * float(end_pt[1] - pt[1])
        if (
            dist * dist <= 0.5 * eps2 * (dx * dx + dy * dy)
            and dx != 0
            and dy != 0
            and sip >= 0
        ):
            new_count -= 1
            dst[wpos] = start_pt = end_pt
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start_pt = pt
        wpos = (wpos + 1) % count
        pt = end_pt
        i += 1
    if not closed:
        dst[wpos] = pt
    return np.array(dst[:new_count], np.int32)


# ---------------------------------------------------------------------------
# Minimum-area rectangle
# ---------------------------------------------------------------------------
def _sklansky(ptr: list, pts: list, start: int, end: int, stack: list,
              nsign: int, sign2: int) -> int:
    """One quadrant pass of OpenCV's Sklansky'82 hull scan over the sorted
    index array ``ptr``; writes hull indices into ``stack``, returns count.
    Behaviour (including degenerate/collinear handling) is pinned bit-for-bit
    against ``cv2.convexHull`` by the fuzz in tests/test_geometry.py."""
    incr = 1 if end > start else -1
    if start == end or pts[ptr[start]] == pts[ptr[end]]:
        stack[0] = start
        return 1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack[0] = pprev
    stack[1] = pcur
    stack[2] = pnext
    stacksize = 3
    end += incr

    def sign(v):
        return 1 if v > 0 else (-1 if v < 0 else 0)

    while pnext != end:
        cury = pts[ptr[pcur]][1]
        by = pts[ptr[pnext]][1] - cury
        if sign(by) != nsign:
            ax = pts[ptr[pcur]][0] - pts[ptr[pprev]][0]
            bx = pts[ptr[pnext]][0] - pts[ptr[pcur]][0]
            ay = cury - pts[ptr[pprev]][1]
            convexity = ay * bx - ax * by
            if sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur, pnext = pcur, pnext, pnext + incr
                stack[stacksize] = pnext
                stacksize += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[stacksize - 2] = pnext
                pcur = pprev
                pprev = stack[stacksize - 4]
                stacksize -= 1
        else:
            pnext += incr
            stack[stacksize - 1] = pnext
    return stacksize - 1


def convex_hull_cv2(points: np.ndarray, clockwise: bool = False) -> np.ndarray:
    """``cv2.convexHull(returnPoints=True)`` including its OUTPUT ORDER.

    The point ORDER matters downstream: ``min_area_rect``'s caliper tie
    resolution (and therefore ``box_points``' corner phase on exact-tie
    rectangles) depends on where the hull starts, and cv2's hull starts at a
    position determined by its four Sklansky quadrant passes plus a final
    cyclic rotation that re-aligns the hull to ascending/descending ORIGINAL
    point indices when possible.  A plain monotone chain would give the same
    cyclic polygon but not the same phase; this replica is bit-order-exact
    (0 divergence over a 20k adversarial fuzz vs cv2, including duplicate
    points and collinear strips)."""
    pts = [tuple(map(int, p)) for p in np.asarray(points).reshape(-1, 2)]
    total = len(pts)
    ptr = sorted(range(total), key=lambda i: (pts[i][0], pts[i][1], i))
    miny_ind = 0
    maxy_ind = 0
    for i in range(1, total):
        y = pts[ptr[i]][1]
        if pts[ptr[miny_ind]][1] > y:
            miny_ind = i
        if pts[ptr[maxy_ind]][1] < y:
            maxy_ind = i
    if pts[ptr[0]] == pts[ptr[total - 1]]:
        return np.array([pts[ptr[0]]], np.int64)

    stack = [0] * (total + 2)
    stack2 = [0] * (total + 2)
    hullbuf: list = []
    tl_count = _sklansky(ptr, pts, 0, maxy_ind, stack, -1, 1)
    tl_stack = stack[:tl_count]
    tr_count = _sklansky(ptr, pts, total - 1, maxy_ind, stack2, -1, -1)
    tr_stack = stack2[:tr_count]
    if not clockwise:
        tl_stack, tr_stack = tr_stack, tl_stack
        tl_count, tr_count = tr_count, tl_count
    hullbuf += [ptr[tl_stack[i]] for i in range(tl_count - 1)]
    hullbuf += [ptr[tr_stack[i]] for i in range(tr_count - 1, 0, -1)]
    stop_idx = (tr_stack[1] if tr_count > 2 else
                (tl_stack[tl_count - 2] if tl_count > 2 else -1))
    bl_count = _sklansky(ptr, pts, 0, miny_ind, stack, 1, -1)
    bl_stack = stack[:bl_count]
    br_count = _sklansky(ptr, pts, total - 1, miny_ind, stack2, 1, 1)
    br_stack = stack2[:br_count]
    if clockwise:
        bl_stack, br_stack = br_stack, bl_stack
        bl_count, br_count = br_count, bl_count
    if stop_idx >= 0:
        check_idx = (bl_stack[1] if bl_count > 2 else
                     (br_stack[2 - bl_count] if bl_count + br_count > 2 else -1))
        if (check_idx == stop_idx or
                (check_idx >= 0 and pts[ptr[check_idx]] == pts[ptr[stop_idx]])):
            # all points on one line: bottom is the mirrored top
            bl_count = min(bl_count, 2)
            br_count = min(br_count, 2)
    hullbuf += [ptr[bl_stack[i]] for i in range(bl_count - 1)]
    hullbuf += [ptr[br_stack[i]] for i in range(br_count - 1, 0, -1)]
    # cv2's final cyclic rotation: start the hull where the original input
    # indices form an ascending/descending run, when they do
    nout = len(hullbuf)
    if nout >= 3:
        min_idx = max_idx = 0
        lt = 0
        for i in range(1, nout):
            idx = hullbuf[i]
            lt += hullbuf[i - 1] < idx
            if hullbuf[min_idx] > idx:
                min_idx = i
            if hullbuf[max_idx] < idx:
                max_idx = i
        mmdist = abs(max_idx - min_idx)
        if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
            ascending = (max_idx + 1) % nout == min_idx
            i0 = min_idx if ascending else max_idx
            if i0 > 0:
                j = i0
                tmp = [0] * nout
                ok = True
                for i in range(nout):
                    curr_idx = tmp[i] = hullbuf[j]
                    next_j = j + 1 if j + 1 < nout else 0
                    if i < nout - 1 and (ascending != (curr_idx < hullbuf[next_j])):
                        ok = False
                        break
                    j = next_j
                if ok:
                    hullbuf = tmp
    return np.array([pts[i] for i in hullbuf], np.int64)


def _rotating_calipers_f32(hull_f32: np.ndarray):
    """OpenCV ``rotatingCalipers(CALIPERS_MINAREARECT)`` in single precision.

    Every arithmetic step is chained float32 (products and sums each rounded
    to f32, as SSE2 code without FMA contraction computes them), because
    cv2's results are reproducible only at that precision: the round-2
    residual (~1e-4 px on ``small_target`` fallback rings, `edge_3.py:282-285`)
    came from running these calipers in f64.  Returns
    ``((cx, cy), (w, h), (vx, vy))`` with the raw width-direction vector for
    :func:`min_area_rect`'s angle normalisation.
    """
    f = np.float32
    n = len(hull_f32)
    px_ = hull_f32[:, 0]
    py_ = hull_f32[:, 1]
    vect = np.empty((n, 2), f)
    inv_len = np.empty(n, f)
    left = right = top = bottom = 0
    left_x = right_x = px_[0]
    top_y = bottom_y = py_[0]
    pt0x, pt0y = px_[0], py_[0]
    for i in range(n):
        if pt0x < left_x:
            left_x = pt0x
            left = i
        if pt0x > right_x:
            right_x = pt0x
            right = i
        if pt0y > top_y:
            top_y = pt0y
            top = i
        if pt0y < bottom_y:
            bottom_y = pt0y
            bottom = i
        j = i + 1 if i + 1 < n else 0
        dx = float(px_[j]) - float(pt0x)
        dy = float(py_[j]) - float(pt0y)
        vect[i, 0] = f(dx)
        vect[i, 1] = f(dy)
        inv_len[i] = f(1.0 / math.sqrt(dx * dx + dy * dy))
        pt0x, pt0y = px_[j], py_[j]
    ax, ay = float(vect[n - 1, 0]), float(vect[n - 1, 1])
    orientation = 0.0
    for i in range(n):
        bx, by = float(vect[i, 0]), float(vect[i, 1])
        conv = ax * by - ay * bx
        if conv != 0:
            orientation = 1.0 if conv > 0 else -1.0
            break
        ax, ay = bx, by
    base_a = f(orientation)
    base_b = f(0.0)
    seq = [bottom, right, top, left]
    minarea = np.finfo(np.float32).max
    buf = None
    for _k in range(n):
        dp0 = f(f(base_a * vect[seq[0], 0]) + f(base_b * vect[seq[0], 1]))
        dp1 = f(f(f(-base_b) * vect[seq[1], 0]) + f(base_a * vect[seq[1], 1]))
        dp2 = f(f(f(-base_a) * vect[seq[2], 0]) + f(f(-base_b) * vect[seq[2], 1]))
        dp3 = f(f(base_b * vect[seq[3], 0]) + f(f(-base_a) * vect[seq[3], 1]))
        dp = (dp0, dp1, dp2, dp3)
        maxcos = f(dp[0] * inv_len[seq[0]])
        main = 0
        for i in range(1, 4):
            cosalpha = f(dp[i] * inv_len[seq[i]])
            if cosalpha > maxcos:
                main = i
                maxcos = cosalpha
        pindex = seq[main]
        lead_x = f(vect[pindex, 0] * inv_len[pindex])
        lead_y = f(vect[pindex, 1] * inv_len[pindex])
        if main == 0:
            base_a, base_b = lead_x, lead_y
        elif main == 1:
            base_a, base_b = lead_y, f(-lead_x)
        elif main == 2:
            base_a, base_b = f(-lead_x), f(-lead_y)
        else:
            base_a, base_b = f(-lead_y), lead_x
        seq[main] += 1
        if seq[main] == n:
            seq[main] = 0
        dx = f(px_[seq[1]] - px_[seq[3]])
        dy = f(py_[seq[1]] - py_[seq[3]])
        width = f(f(dx * base_a) + f(dy * base_b))
        dx = f(px_[seq[2]] - px_[seq[0]])
        dy = f(py_[seq[2]] - py_[seq[0]])
        height = f(f(f(-dx) * base_b) + f(dy * base_a))
        area = f(width * height)
        if area <= minarea:  # <=: the LAST tie wins, like cv2
            minarea = area
            buf = (seq[3], base_a, width, base_b, height, seq[0])
    li, A1, w, B1, h, bi = buf
    A2 = f(-B1)
    B2 = A1
    C1 = f(f(A1 * px_[li]) + f(py_[li] * B1))
    C2 = f(f(A2 * px_[bi]) + f(py_[bi] * B2))
    idet = f(1.0 / float(f(f(A1 * B2) - f(A2 * B1))))
    out0x = f(f(f(C1 * B2) - f(C2 * B1)) * idet)
    out0y = f(f(f(A1 * C2) - f(A2 * C1)) * idet)
    out1x = f(A1 * w)
    out1y = f(B1 * w)
    out2x = f(A2 * h)
    out2y = f(B2 * h)
    cx = f(out0x + f(out1x + out2x) * f(0.5))
    cy = f(out0y + f(out1y + out2y) * f(0.5))
    wd = f(math.sqrt(float(out2x) ** 2 + float(out2y) ** 2))
    ht = f(math.sqrt(float(out1x) ** 2 + float(out1y) ** 2))
    vx = f(B1 * w)
    vy = f(-f(A1 * w))
    return (float(cx), float(cy)), (float(wd), float(ht)), (vx, vy)


def _cv2_angle(vx, vy, w: float, h: float) -> Tuple[float, float, float]:
    """cv2's angle convention: rotate the direction by exact 90-degree
    component swaps until atan2 lands in [-90, 0); each rotation swaps w/h
    (and therefore ``box_points``' corner phase — user-visible ring order)."""
    f = np.float32
    a = f(math.atan2(float(vy), float(vx)) * 180.0 / math.pi)
    for _ in range(4):
        if -90.0 <= float(a) < 0.0:
            break
        if float(a) >= 0.0:
            vx, vy = vy, f(-vx)
        else:
            vx, vy = f(-vy), vx
        w, h = h, w
        a = f(math.atan2(float(vy), float(vx)) * 180.0 / math.pi)
    return float(w), float(h), float(a)


def min_area_rect(contour: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """``cv2.minAreaRect``: ((cx, cy), (w, h), angle), cv2-bit-faithful.

    Pipeline: cv2-ORDERED hull (:func:`convex_hull_cv2`) -> f32 rotating
    calipers (:func:`_rotating_calipers_f32`) -> angle normalisation into
    [-90, 0) (:func:`_cv2_angle`).  Fuzzed against cv2 over 30k adversarial
    contours (grids, 4000px coords, 3px strips, collinear sets): every angle
    and corner phase identical; center/size bit-equal in 99.75% of cases,
    the rest ~1 ulp apart on exact-area ties, where cv2's compiled binary
    picks a different equal-area caliper support sequence (verified by
    exhausting every FMA-contraction variant of the published algorithm:
    none reproduces it — build-dependent, unreproducible portably;
    documented in docs/QUIRKS.md).  Feeds ``box_points`` in ``small_target``'s fallback
    (`edge_3.py:282-285`)."""
    f = np.float32
    hull = convex_hull_cv2(contour, clockwise=False)
    n = len(hull)
    if n == 1:
        # cv2 (5.x) reports a single point with its angle already normalised
        return ((float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), -90.0)
    hf = hull.astype(np.float32)
    if n == 2:
        cx = f((hf[0, 0] + hf[1, 0]) * f(0.5))
        cy = f((hf[0, 1] + hf[1, 1]) * f(0.5))
        dx = float(hf[0, 0]) - float(hf[1, 0])
        dy = float(hf[0, 1]) - float(hf[1, 1])
        wd = float(f(math.sqrt(dx * dx + dy * dy)))
        w, h, a = _cv2_angle(f(dx), f(dy), wd, 0.0)
        return ((float(cx), float(cy)), (w, h), a)
    (cx, cy), (w, h), (vx, vy) = _rotating_calipers_f32(hf)
    w, h, a = _cv2_angle(vx, vy, w, h)
    return ((cx, cy), (w, h), a)


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints``: the 4 rectangle corners as float32 (4, 2).

    Reproduces ``cv::RotatedRect::points`` exactly — same corner ORDER
    (cv2 emits its first corner at ``center + (-a*h - b*w, +b*h - a*w)``
    with ``b = cos*0.5, a = sin*0.5``, then reflects through the center)
    and the same single-precision arithmetic (trig in double, cast to f32,
    then f32 multiply-adds).  The order is user-visible: ``small_target``'s
    minAreaRect fallback (`edge_3.py:282-285`) feeds these points straight
    into the output ring.
    """
    (cx, cy), (w, h), angle = rect
    f = np.float32
    cx, cy, w, h = f(cx), f(cy), f(w), f(h)
    rad = math.radians(float(angle))
    b = f(f(math.cos(rad)) * f(0.5))
    a = f(f(math.sin(rad)) * f(0.5))
    # cv2 5.x computes ALL FOUR corners directly (p2/p3 are NOT center
    # reflections of p0/p1 — the reflection formula differs at ~1 ulp and
    # failed the bit-exact fuzz); chained f32, left-to-right
    ah, bw = f(a * h), f(b * w)
    bh, aw = f(b * h), f(a * w)
    p0x = f(f(cx - ah) - bw)
    p0y = f(f(cy + bh) - aw)
    p1x = f(f(cx + ah) - bw)
    p1y = f(f(cy - bh) - aw)
    p2x = f(f(cx + ah) + bw)
    p2y = f(f(cy - bh) + aw)
    p3x = f(f(cx - ah) + bw)
    p3y = f(f(cy + bh) + aw)
    return np.array(
        [[p0x, p0y], [p1x, p1y], [p2x, p2y], [p3x, p3y]], np.float32
    )


# ---------------------------------------------------------------------------
# Rasterisation / components
# ---------------------------------------------------------------------------
def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Component pixels + interior holes (== fillPoly over the external
    contour for pixel-chain contours, `model_fuse.py:18`)."""
    m = np.asarray(mask) != 0
    nat = native()
    if nat is not None:
        return nat.fill_holes(np.ascontiguousarray(m.astype(np.uint8)))
    return ndimage.binary_fill_holes(m).astype(np.uint8)


def components_filled(mask: np.ndarray) -> List[np.ndarray]:
    """One hole-filled boolean raster per top-level component.

    The workhorse behind the reference's draw-one-contour-filled idiom
    (`model_fuse.py:177-178`): each returned raster is what
    ``cv2.drawContours(blank, contours, i, 255, FILLED)`` paints.  List
    order matches :func:`find_contours` (cv2's reverse-raster order) so the
    two zip together per component.
    """
    m = np.asarray(mask) != 0
    filled = ndimage.binary_fill_holes(m)
    labels, n = ndimage.label(filled, structure=_STRUCT8)
    return [(labels == lbl).astype(np.uint8) for lbl in range(n, 0, -1)]


def erode_np(mask: np.ndarray, kernel: Tuple[int, int], iterations: int = 1) -> np.ndarray:
    """Host-side ``cv2.erode`` (flat kernel, default border = max)."""
    nat = native()
    if nat is not None and getattr(mask, "dtype", None) == np.uint8 and mask.ndim == 2:
        return nat.erode(mask, kernel, iterations)
    kh, kw = kernel
    size = (iterations * (kh - 1) + 1, iterations * (kw - 1) + 1)
    return ndimage.minimum_filter(mask, size=size, mode="constant", cval=255)


def dilate_np(mask: np.ndarray, kernel: Tuple[int, int], iterations: int = 1) -> np.ndarray:
    """Host-side ``cv2.dilate`` (flat kernel, default border = 0)."""
    nat = native()
    if nat is not None and getattr(mask, "dtype", None) == np.uint8 and mask.ndim == 2:
        return nat.dilate(mask, kernel, iterations)
    kh, kw = kernel
    size = (iterations * (kh - 1) + 1, iterations * (kw - 1) + 1)
    return ndimage.maximum_filter(mask, size=size, mode="constant", cval=0)


def draw_contours_filled(shape: Tuple[int, int], contours: List[np.ndarray]) -> np.ndarray:
    """OR of hole-filled polygons, like repeated drawContours(..., FILLED).

    For our pixel-chain contours the filled polygon equals the traced
    component plus its holes, so we rasterise by scanline polygon fill and
    include all boundary pixels.
    """
    out = np.zeros(shape, np.uint8)
    for c in contours:
        fill_polygon_(out, c, 255)
    return out


def fill_polygon_(img: np.ndarray, contour: np.ndarray, value: int) -> None:
    """In-place scanline even-odd polygon fill incl. boundary (cv2.fillPoly
    semantics for integer-vertex polygons)."""
    pts = np.asarray(contour, np.int64).reshape(-1, 2)
    if len(pts) == 0:
        return
    if len(pts) <= 2:
        for x, y in pts:
            if 0 <= y < img.shape[0] and 0 <= x < img.shape[1]:
                img[y, x] = value
        if len(pts) == 2:
            _draw_line_(img, pts[0], pts[1], value)
        return
    h, w = img.shape[:2]
    ymin = max(int(pts[:, 1].min()), 0)
    ymax = min(int(pts[:, 1].max()), h - 1)
    x0s = pts[:, 0].astype(np.float64)
    y0s = pts[:, 1].astype(np.float64)
    x1s = np.roll(x0s, -1)
    y1s = np.roll(y0s, -1)
    for y in range(ymin, ymax + 1):
        # even-odd rule at scanline center y
        cond = ((y0s <= y) & (y1s > y)) | ((y1s <= y) & (y0s > y))
        if cond.any():
            xs = x0s[cond] + (y - y0s[cond]) / (y1s[cond] - y0s[cond]) * (
                x1s[cond] - x0s[cond]
            )
            xs = np.sort(xs)
            for i in range(0, len(xs) - 1, 2):
                a = int(np.ceil(xs[i]))
                b = int(np.floor(xs[i + 1]))
                if b >= a:
                    img[y, max(a, 0) : min(b, w - 1) + 1] = value
    # boundary pixels
    for i in range(len(pts)):
        _draw_line_(img, pts[i], pts[(i + 1) % len(pts)], value)


def _draw_line_(img: np.ndarray, p0, p1, value: int) -> None:
    """Bresenham segment (8-connected), like cv2.line thickness 1."""
    x0, y0 = int(p0[0]), int(p0[1])
    x1, y1 = int(p1[0]), int(p1[1])
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx - dy
    h, w = img.shape[:2]
    while True:
        if 0 <= y0 < h and 0 <= x0 < w:
            img[y0, x0] = value
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x0 += sx
        if e2 < dx:
            err += dx
            y0 += sy
