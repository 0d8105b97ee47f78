"""Keep the JAX package, JAX and Flax out of the benchmark's process.

The program under test is the PyTorch port, ``building_detection_tpu_torch``;
the JAX package beside it (``building_detection_tpu``) is its reference in
the repository's CPU tests and is never measured.  Names are compared by
their whole top-level part (the text before the first dot), so the port,
whose name begins with the JAX package's, is not caught.
"""
from __future__ import annotations

import importlib.abc
import sys
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "building_detection_tpu"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if top(fullname) in FORBIDDEN:
            raise ImportError(f"the benchmark refuses to import {fullname!r}: it measures the PyTorch port only")
        return None


def install() -> None:
    """Refuse every later import of a forbidden module in this process."""
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse())


def loaded() -> List[str]:
    """The forbidden modules already in ``sys.modules``."""
    return sorted(name for name in sys.modules if top(name) in FORBIDDEN)
