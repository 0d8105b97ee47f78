"""The benchmark's reference and counts against the program, on the CPU at small sizes."""
from __future__ import annotations

import pytest
import torch

from benchmark.entries import train as train_entry
from benchmark.harness import flops, program, spec, traffic, weights as W
from benchmark.reference import layers as RL, models as RM, tiler as RT
from benchmark.tests import tiny

ENSEMBLE = spec.load_json(spec.BENCH / "configs" / "whu-ensemble5.json")
RES34 = spec.load_json(spec.BENCH / "configs" / "whu-res34.json")
SCENE = spec.load_json(spec.BENCH / "traffic" / "masks-1024.json")["scene"]


@pytest.mark.parametrize("member", RM.MODELS)
def test_frozen_forward_counts_equal_a_fresh_count(member):
    assert ENSEMBLE["flops"]["forward_per_tile"][member] == flops.forward_flops(member, ENSEMBLE["tile"])


def test_frozen_train_count_equals_a_fresh_count():
    tile = spec.load_json(spec.BENCH / "traffic" / "train-512-b8.json")["tile_px"]
    assert RES34["flops"]["train_per_image"] == flops.train_flops(RES34["member"], tile)


def test_edge_bytes_are_one_read_and_two_writes_in_f32():
    assert flops.edge_bytes(8, 512, 512) == 8 * 512 * 512 * 4 * 3
    assert flops.edge_bytes(8, 512, 512) / flops.PEAK_HBM_BYTES_PER_S == pytest.approx(7.512e-6, rel=1e-3)


@pytest.mark.parametrize("member", RM.MODELS)
def test_the_reference_member_computes_what_the_program_computes_in_f32(member):
    torch.manual_seed(0)
    ref = RM.build(member)
    calib = RT.normalize(traffic.scenes(SCENE, 3, 2, 64, "cpu")[0])
    w = W.calibrate_bn(ref, W.make(ref, 2**40 + 9, "cpu"), calib)
    RL.set_logits(ref, False)
    port = program.fill(program.build_member(member, "cpu"), w).eval()
    x = RT.normalize(traffic.scenes(SCENE, 4, 2, 64, "cpu")[0])
    with torch.no_grad():
        want, got = ref(x), port(x)
    assert got.shape == want.shape == (2, 64, 64, 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("h,w", [(512, 512), (1024, 1024), (600, 1000), (100, 100), (1400, 900)])
def test_the_reference_tiling_is_the_programs(h, w):
    from building_detection_tpu_torch.ops.tiling import plan_tiles

    plan = plan_tiles(h, w)
    assert list(plan.origins) == RT.origins(h, w, 512, 360)
    assert (plan.canvas_h, plan.canvas_w) == (RT.axis(h, 512, 360)[0], RT.axis(w, 512, 360)[0])


def test_the_reference_train_steps_follow_the_programs_in_f32():
    session = train_entry.Session(tiny.cell("res34.train-512-b8", compute_dtype="float32"), 2**35 + 1, "cpu", steps=3)
    session.release()
    numbers = session.check()
    assert numbers["loss_gap"] < 1e-4 and numbers["grad_gap"] < 1e-3 and numbers["change_gap"] < 2e-2, numbers
