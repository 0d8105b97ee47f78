"""ctypes loader for the C++ geometry fast path, the port's own build of it.

The counterpart of ``building_detection_tpu/post/_native.py``.  It compiles
the repository's C++ source ``native/src/geometry.cc`` with ``g++`` on first
use into ``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that hashes the source and the flags, and
loads it with ``ctypes``.  Each process compiles into a temporary name of
its own and renames it into place, so processes that build at once (test
workers) all end with the same library.  :func:`load` raises where ``g++``
is missing or fails; :func:`building_detection_tpu_torch.post.geometry.native`
catches that and uses the NumPy/scipy code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "src" / "geometry.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32PP = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once per source and flags) and load the geometry library."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"bdgeometry_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{done.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders race safely
    lib = ctypes.CDLL(str(so))
    lib.bd_fill_holes.restype = ctypes.c_int
    lib.bd_fill_holes.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U8P]
    lib.bd_find_contours.restype = ctypes.c_int
    lib.bd_find_contours.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _I32PP, _I32PP]
    lib.bd_free.restype = None
    lib.bd_free.argtypes = [ctypes.c_void_p]
    lib.bd_morph.restype = ctypes.c_int
    lib.bd_morph.argtypes = [_U8P] + [ctypes.c_int] * 6 + [_U8P]
    lib.bd_process_mask.restype = ctypes.c_int
    lib.bd_process_mask.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, _U8P,
    ]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    out = np.empty((h, w), np.uint8)
    if load().bd_fill_holes(_ptr(mask), h, w, _ptr(out)) != 0:
        raise RuntimeError("bd_fill_holes failed")
    return out


def find_contours(mask: np.ndarray) -> List[np.ndarray]:
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    lib = load()
    pts_p = ctypes.POINTER(ctypes.c_int32)()
    off_p = ctypes.POINTER(ctypes.c_int32)()
    n = lib.bd_find_contours(_ptr(mask), h, w, ctypes.byref(pts_p), ctypes.byref(off_p))
    if n < 0:
        raise RuntimeError("bd_find_contours failed")
    try:
        offsets = np.ctypeslib.as_array(off_p, shape=(n + 1,)).copy()
        total = int(offsets[-1])
        if total:
            flat = np.ctypeslib.as_array(pts_p, shape=(total * 2,)).copy()
        else:
            flat = np.zeros((0,), np.int32)
    finally:
        lib.bd_free(ctypes.cast(pts_p, ctypes.c_void_p))
        lib.bd_free(ctypes.cast(off_p, ctypes.c_void_p))
    pts = flat.reshape(-1, 2)
    return [pts[offsets[i] : offsets[i + 1]] for i in range(n)]


def _morph(img: np.ndarray, kernel, iterations: int, is_dilate: bool) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    out = np.empty((h, w), np.uint8)
    rc = load().bd_morph(
        _ptr(img), h, w, int(kernel[0]), int(kernel[1]), int(iterations), 1 if is_dilate else 0, _ptr(out)
    )
    if rc != 0:
        raise RuntimeError("bd_morph failed")
    return out


def erode(img: np.ndarray, kernel, iterations: int = 1) -> np.ndarray:
    return _morph(img, kernel, iterations, is_dilate=False)


def dilate(img: np.ndarray, kernel, iterations: int = 1) -> np.ndarray:
    return _morph(img, kernel, iterations, is_dilate=True)


def process_mask(
    mask: np.ndarray,
    min_area: float,
    split_kernel: int,
    split_iterations: int,
    fragment_min_area: float,
    do_split: bool = True,
) -> np.ndarray:
    """Fusion per-mask morphology; {0,255} out (see bd_process_mask)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    out = np.empty((h, w), np.uint8)
    rc = load().bd_process_mask(
        _ptr(mask), h, w, float(min_area), int(split_kernel), int(split_iterations),
        float(fragment_min_area), 1 if do_split else 0, _ptr(out),
    )
    if rc != 0:
        raise RuntimeError("bd_process_mask failed")
    return out
