"""Edge-band weight maps: the hand-written CUDA kernel and its plain twin.

Replaces ``building_detection_tpu/kernels/pallas_morphology.py::
edge_weight_maps_pallas``.  :func:`edge_weight_maps` takes an ``(N, H, W)``
f32 contiguous label: on a CUDA tensor it launches the kernel of
``csrc/edge_weights.cu`` (bound by device memory: 4 bytes read and 8
written per pixel; row strips, register taps and 16-byte accesses, see the
source note), on a CPU tensor it runs
:func:`edge_weight_maps_plain`, the ±inf-padded ``max_pool2d`` version the
tests and ``chip_smoke.py`` hold the kernel against.  There is no fallback
from one to the other.

The kernel is compiled with ``nvcc`` for ``sm_90a`` on first use, into
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that hashes the source and the flags, and is
loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

from building_detection_tpu_torch.ops.morphology import dilate, erode

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "edge_weights.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# --split-compile=0 runs the device optimizer on every host core: the 33
# window instantiations take most of the build, which chip_smoke.py's
# [build] line read at 19.3 s with it and 69.0 s without, on 8-core H100
# hosts with CUDA 12.9.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
)
MAX_WINDOW = 33  # the kernel is instantiated for every window 1..33 (kMaxWindow)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source and flags) and load the kernel library."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"edge_weights_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{done.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders race safely
    lib = ctypes.CDLL(str(so))
    lib.bdt_edge_weight_maps.restype = ctypes.c_int
    lib.bdt_edge_weight_maps.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def edge_weight_maps_plain(
    label: torch.Tensor, kernel: int = 3, iterations: int = 5, weight: float = 2.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``(f_edge, p_edge)``."""
    p_edge = torch.where(label - erode(label, kernel, iterations) == 1.0, weight, 1.0)
    f_edge = torch.where(dilate(label, kernel, iterations) - label == 1.0, weight, 1.0)
    return f_edge, p_edge


def edge_weight_maps(
    label: torch.Tensor, kernel: int = 3, iterations: int = 5, weight: float = 2.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(N, H, W)`` f32 contiguous {0,1} labels -> ``(f_edge, p_edge)``.

    A CUDA tensor launches the kernel (counted in ``edge_weight_maps.launches``);
    a CPU tensor runs :func:`edge_weight_maps_plain`; anything else raises.
    """
    if label.dtype != torch.float32 or label.dim() != 3 or not label.is_contiguous():
        raise ValueError(
            f"edge_weight_maps takes a contiguous (N, H, W) float32 tensor, got "
            f"{label.dtype} {tuple(label.shape)} contiguous={label.is_contiguous()}"
        )
    win = iterations * (kernel - 1) + 1
    if not 1 <= win <= MAX_WINDOW:
        raise ValueError(f"window {win} outside 1..{MAX_WINDOW}")
    if label.device.type == "cpu":
        return edge_weight_maps_plain(label, kernel, iterations, weight)
    if label.device.type != "cuda":
        raise ValueError(f"edge_weight_maps runs on CPU or CUDA tensors, got {label.device}")
    f_edge, p_edge = torch.empty_like(label), torch.empty_like(label)
    n, h, w = label.shape
    if label.numel() == 0:
        return f_edge, p_edge
    rc = load_library().bdt_edge_weight_maps(
        label.data_ptr(), f_edge.data_ptr(), p_edge.data_ptr(), n, h, w, win,
        float(weight), label.device.index, torch.cuda.current_stream(label.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"edge_weight_maps kernel launch failed: CUDA error {rc}")
    edge_weight_maps.launches += 1
    return f_edge, p_edge


edge_weight_maps.launches = 0
