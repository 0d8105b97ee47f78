"""Image and corner-text I/O at the edges of the pipeline.

The port's own copy of ``building_detection_tpu/utils/io.py``.  The
reference does all image I/O through OpenCV (BGR, `predict.py:91`,
`model_fuse.py:285`); this uses PIL and keeps everything RGB internally, so
in-memory arrays never need channel swaps.  PIL is imported inside the
functions that read or write an image, so the module imports without it.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB (the reference reads BGR then converts,
    `predict.py:91-92`)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def imread_gray(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


def imwrite(path: str, array: np.ndarray) -> None:
    """PNG writer (the reference writes with compression 0, `predict.py:115`;
    compression level changes bytes, not pixels)."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(array).save(path)


def write_points(corners, path: str) -> None:
    """Corner txt writer, one ring per line as ``x,y x,y ...``
    (reference `predict.py:119-132`)."""
    with open(path, "w", encoding="utf-8") as f:
        for xs, ys in corners:
            f.write("".join(f"{x},{y} " for x, y in zip(xs, ys)))
            f.write("\n")


def points_dict(corners) -> Dict[str, str]:
    """The serving JSON's ``points`` payload (`buildAPI.py:128-143`)."""
    out = {}
    for i, (xs, ys) in enumerate(corners):
        out[str(i)] = "".join(f"{x},{y} " for x, y in zip(xs, ys))
    return out
