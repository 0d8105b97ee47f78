"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for the tests.

The members keep their widths; tiles shrink to 64 (stride 48), scenes to
96 and training tiles to 32, with fewer buildings and fewer scenes."""
from __future__ import annotations

import copy

from benchmark.harness import spec


def cell(name: str, **config) -> dict:
    c = copy.deepcopy(spec.cell(name))
    if c["entry"] == "masks":
        c["config"].update(tile=64, stride=48, calibration_tiles=4)
        c["traffic"].update(scene_px=96, pool=3, per_call=2)
        c["traffic"]["scene"].update(buildings=3, half_side_px=[3.0, 10.0], ground_cell_px=32)
        c["check"].update(sample_scenes=2)
    else:
        c["traffic"].update(tile_px=32, tiles=48, batch=4, chunk_steps=2, trace_steps=2, host_trace_steps=1)
        c["traffic"]["scene"].update(buildings=2, half_side_px=[3.0, 8.0], ground_cell_px=16)
    c["config"].update(config)
    return c
