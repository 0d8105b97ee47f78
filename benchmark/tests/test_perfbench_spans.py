"""The per-layer readers of the program's own spans and counters (CPU).

Each reads its number from a registry planted in
``building_detection_tpu_torch.utils.profiling`` and reads nothing from an
empty one, from a run without a trace, or from a program without the
registry."""
from __future__ import annotations

import pytest

from benchmark.harness import flops, spec
from building_detection_tpu_torch.utils import profiling

MASKS, TRAIN = spec.cell("ensemble5.masks-1024"), spec.cell("res34.train-512-b8")
TRACE = {"window_s": 1.0, "busy_s": 0.9, "ops": {}, "gaps": {}}
READERS = ["dispatch_fill.masks", "dispatch_overhead.masks", "forward_peak_share.masks", "optimizer_share.train"]


def planted(counters=None, device=None) -> profiling.Registry:
    reg = profiling.Registry()
    reg.counters.update(counters or {})
    for name, seconds in (device or {}).items():
        for s in seconds:
            reg.device.setdefault(name, profiling.Series()).add(s)
    return reg


def ctx(cell, trace=TRACE):
    return {"cell": cell, "window": {"seconds": 1.0, "done": {}}, "trace": trace}


@pytest.fixture
def plant(monkeypatch):
    def put(reg):
        monkeypatch.setattr(profiling, "REGISTRY", reg)
    return put


@pytest.mark.parametrize("tiles,slots,want", [(144, 192, 75.0), (64, 64, 100.0)], ids=["1024", "512"])
def test_dispatch_fill_is_tiles_over_slots(plant, tiles, slots, want):
    plant(planted({"fused.tiles": tiles, "fused.tile_slots": slots}))
    assert spec.reader("dispatch_fill.masks")(ctx(MASKS)) == want


def test_dispatch_overhead_reads_the_medians_of_forward_and_dispatch(plant):
    # one chunk a dispatch; the outlier of each ring moves no median
    plant(planted({"fused.chunks": 3, "fused.dispatches": 3},
                  {"fused.forward": [0.36, 0.38, 5.0], "fused.dispatch": [0.40, 0.40, 9.0]}))
    assert spec.reader("dispatch_overhead.masks")(ctx(MASKS)) == pytest.approx(5.0)


def test_dispatch_overhead_counts_every_chunk_of_a_dispatch(plant):
    plant(planted({"fused.chunks": 4, "fused.dispatches": 2},
                  {"fused.forward": [0.1, 0.1, 0.1, 0.1], "fused.dispatch": [0.25, 0.25]}))
    assert spec.reader("dispatch_overhead.masks")(ctx(MASKS)) == pytest.approx(20.0)


def test_forward_peak_share_is_counted_operations_over_forward_seconds(plant):
    plant(planted({"fused.tiles": 144}, {"fused.forward": [0.5, 0.5, 1.0]}))
    per_tile = sum(MASKS["config"]["flops"]["forward_per_tile"].values())
    want = 100.0 * per_tile * 144 / 2.0 / flops.PEAK_BF16_FLOPS
    assert spec.reader("forward_peak_share.masks")(ctx(MASKS)) == pytest.approx(want)
    assert 0 < want < 100


def test_optimizer_share_is_the_median_optimizer_over_the_median_step(plant):
    plant(planted({"train.steps": 12}, {"train.optimizer": [0.02] * 10 + [0.2, 0.2],
                                        "train.step": [0.16] * 10 + [0.5, 0.5]}))
    assert spec.reader("optimizer_share.train")(ctx(TRAIN)) == pytest.approx(12.5)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_from_nothing(plant, monkeypatch, name):
    cell = TRAIN if name.endswith(".train") else MASKS
    read = spec.reader(name)
    plant(profiling.Registry())
    assert read(ctx(cell)) is None  # nothing recorded
    plant(planted({"fused.tiles": 9, "fused.tile_slots": 32, "train.steps": 1}))
    if name != "dispatch_fill.masks":
        assert read(ctx(cell)) is None  # counters alone, no device span
    assert read(ctx(cell, trace=None)) is None  # no trace
    monkeypatch.delattr(profiling, "REGISTRY")
    assert read(ctx(cell)) is None  # a program without the registry
