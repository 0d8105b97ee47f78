"""The port's spans and counters (``utils/profiling.py``) and where the fused
predictor and the trainer record them.

* With recording off nothing is recorded and ``record_function`` is never
  entered; ``recording()`` records host spans with their parents and one id
  a root span, and counters.
* A span lies on the profiler's clock: its start and end fall within 0.5 ms
  of its ``record_function`` event in a CPU ``torch.profiler`` run.
* ``device_trace`` writes the registry's summary beside the trace.
* A tiny CPU ``FusedEnsemblePredictor`` over 16 scenes of a 9-tile plan at
  ``batch_tiles`` 32 counts 6 dispatches and chunks, 144 tiles and 192
  slots; a tiny CPU ``train_epoch_staged`` records each ``train.*`` host
  span once a step.
* On a card (marker ``cuda``): the device spans resolve, the members' spans
  sum to about the forward's, which is within the dispatch's, and Keras
  Adam's span is within the step's.

The file imports neither JAX nor the JAX package, so it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch import nn
from torch.profiler import ProfilerActivity, profile

from building_detection_tpu_torch.core.config import TilerConfig, TrainConfig
from building_detection_tpu_torch.core.module import Namer
from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.ops import tiling as T
from building_detection_tpu_torch.train.trainer import Trainer
from building_detection_tpu_torch.utils import profiling
from test_torch_cuda import NAMES, scenes, tiny_members

torch.set_num_threads(2)

CFG = TilerConfig(tile=32, stride=24, overlap=8)
SCENE = 64  # a 3x3 plan at CFG, as a 1024^2 scene is at 512 / 360
STEP_SPANS = ("train.step", "train.targets", "train.forward", "train.backward", "train.optimizer", "train.metrics")


class TinyUNet(nn.Module):
    """A conv and a softmax head: enough of a model for the train step."""

    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 4, 3, activation="relu")
        self.conv2 = L.Conv2d(n, 4, 2, 1, activation="softmax")

    def forward(self, x):
        return self.conv2(self.conv1(x))


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.REGISTRY.clear()
    yield
    profiling.REGISTRY.clear()


def predict_16(device="cpu", batch_tiles=32):
    fused = FusedEnsemblePredictor(tiny_members(), CFG, batch_tiles, torch.float32, device)
    assert T.plan_tiles(SCENE, SCENE, CFG).num_tiles == 9
    return fused.predict_masks_many(scenes(3, [(SCENE, SCENE)] * 16))


def train_3(device="cpu", **kw):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    labs = np.where(rng.rand(6, 32, 32) < 0.3, 255, 0).astype(np.uint8)
    tr = Trainer(TinyUNet, TrainConfig(batch_size=2, warmup_epochs=0), device=device, **kw)
    imgs_dev, labs_dev = tr.stage_dataset(imgs, labs)
    return tr.train_epoch_staged(imgs_dev, labs_dev)


def test_with_recording_off_nothing_is_recorded_and_no_annotation_entered(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with recording off")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not profiling.on()
    predict_16()
    train_3()
    with profiling.span("x", root=True), profiling.device_span("y", torch.device("cpu")):
        profiling.count("z")
    assert profiling.REGISTRY.empty() and not profiling.REGISTRY.spans


def test_recording_keeps_spans_parents_ids_and_counters():
    with profiling.recording() as reg:
        for _ in range(2):
            with profiling.span("outer", root=True):
                with profiling.span("inner"):
                    profiling.count("things", 3)
                with profiling.span("inner"):
                    pass
        with profiling.span("alone"):
            pass
    assert not profiling.on()
    spans = [dict(zip(("name", "start", "end", "parent", "id"), s)) for s in reg.spans]
    assert [s["name"] for s in spans] == ["inner", "inner", "outer"] * 2 + ["alone"]
    assert [s["parent"] for s in spans] == ["outer", "outer", None] * 2 + [None]
    ids = [s["id"] for s in spans]
    assert ids[0] == ids[1] == ids[2] and ids[3] == ids[4] == ids[5] and len({ids[0], ids[3], ids[6]}) == 3
    assert all(s["start"] <= s["end"] for s in spans)
    assert spans[2]["start"] <= spans[0]["start"] and spans[1]["end"] <= spans[2]["end"]
    assert reg.counters == {"things": 6}
    assert reg.host["inner"].count == 4 and reg.host["outer"].count == 2
    assert reg.median("host", "outer") >= reg.median("host", "inner") >= 0


def test_a_span_lies_on_the_profilers_clock():
    with profiling.span("warm"):  # recording off: nothing; the first annotation's set-up happens below
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.on()
        with profiling.span("tracing.warm", root=True):
            torch.ones(8) + 1
        for _ in range(3):
            with profiling.span("tracing.probe", root=True):
                torch.ones(64, 64) @ torch.ones(64, 64)
                time.sleep(0.002)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "tracing.probe"]
    ours = [s for s in profiling.REGISTRY.spans if s[0] == "tracing.probe"]
    assert len(events) == len(ours) == 3
    for e, (_, start, end, _, _) in zip(sorted(events, key=lambda e: e.start_ns()), ours):
        assert abs(start - e.start_ns()) < 500_000 and abs(end - (e.start_ns() + e.duration_ns())) < 500_000


def test_device_trace_writes_the_summary_beside_the_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        predict_16(batch_tiles=32)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2 and files[0].endswith(".pt.trace.json") and files[1].endswith(".spans.json"), files
    assert files[0][: -len(".pt.trace.json")] == files[1][: -len(".spans.json")]
    with open(tmp_path / files[1]) as f:
        summary = json.load(f)
    assert summary["counters"]["fused.tiles"] == 144
    assert {"fused.call", "fused.plan", "fused.stage", "fused.launch", "fused.unpack"} <= set(summary["host"])
    assert summary["host"]["fused.call"]["count"] == 1
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"fused.call", "fused.launch", "fused.unpack"} <= names


def test_fused_predictor_counts_dispatches_chunks_tiles_and_slots():
    with profiling.recording() as reg:
        masks = predict_16()
    assert len(masks) == 16 and all(set(m) == set(NAMES) for m in masks)
    # 16 scenes of 9 tiles in groups of 32 // 9 = 3: 3, 3, 3, 3, 3, 1
    assert reg.counters == {"fused.dispatches": 6, "fused.chunks": 6, "fused.tiles": 144, "fused.tile_slots": 192,
                            "fused.scenes": 16}
    assert reg.host["fused.call"].count == 1 and reg.host["fused.stage"].count == 6
    assert reg.host["fused.unpack"].count == 6 and reg.host["fused.plan"].count == 1
    call_id = next(s[4] for s in reg.spans if s[0] == "fused.call")
    assert all(s[4] == call_id for s in reg.spans)
    assert {s[3] for s in reg.spans if s[0] != "fused.call"} == {"fused.call"}
    assert not reg.device  # the CPU has no device spans


def test_train_epoch_staged_records_each_step_span_once_a_step():
    with profiling.recording() as reg:
        train_3()
    assert reg.counters == {"train.steps": 3, "train.images": 6}
    assert {name: reg.host[name].count for name in STEP_SPANS} == dict.fromkeys(STEP_SPANS, 3)
    steps = [s for s in reg.spans if s[0] == "train.step"]
    assert len({s[4] for s in steps}) == 3
    for name, _, _, parent, _ in reg.spans:
        assert parent == (None if name == "train.step" else "train.step")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_spans_resolve_on_the_card(cuda):
    with profiling.recording() as reg:
        predict_16(cuda)
        train_3(cuda)
    assert not reg._pending  # resolved where the program waited
    dev = reg.device
    assert dev["fused.dispatch"].count == dev["fused.forward"].count == 6 and dev["fused.h2d"].count == 6
    members = sum(dev[f"fused.member.{n}"].seconds for n in NAMES)
    forward, dispatch = dev["fused.forward"].seconds, dev["fused.dispatch"].seconds
    assert 0.8 * forward <= members <= forward <= dispatch
    assert all(dev[name].count == 3 for name in STEP_SPANS)
    assert 0 < dev["train.optimizer"].seconds < dev["train.step"].seconds
