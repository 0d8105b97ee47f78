"""PyTorch port, the glue fuzz: the port's ``Pipeline`` against the JAX
``Pipeline`` and the reference oracle over seeded random configurations.

The JAX side and the oracle are ``scripts/pipeline_fuzz.py``'s ``Harness``
(imported as ``tests/test_pipeline_fuzz.py`` imports it, with the JAX model
registry snapshotted and restored the same way): five tiny members,
``tiny_fn`` under each zoo name, saved as ``.npz``; the numpy re-enactment
of the reference's tiling loop and the cv2 transcription of its fusion and
polygons.  The port builds a ``Pipeline(device="cpu",
compute_dtype=torch.float32, weights=harness.weights, ...)`` over
:class:`TinyFn`, the port's counterpart of ``tiny_fn``, registered in the
port's registry for the module (and restored after), with the tiler,
``batch_tiles=12`` and ``max_scene_tiles`` of ``Harness.pipeline``.

Each seed draws its configuration exactly as ``Harness.one_iteration``
does (:func:`draw`, a copy; ``test_draw_is_the_scripts`` holds it to the
script's own draw): bug-mode tiling, ``bucket_sizes``, blocked scenes
under a tiny ``max_scene_tiles``, and one to four scenes of random shape
(degenerate, single-tile, multi-tile and very non-square).  Per scene the
port's per-member masks, fused mask and corners (``points_dict``, or the
script's ``_rings_match_ulp`` for a float ring) must equal both the JAX
``Pipeline``'s and the oracle's; in bug mode a tall scene must raise the
same "tall scene" ``ValueError`` in both packages.  Seeds: the JAX test's
9, 22, 170 and 0, and twelve more that cover each mode (see ``SEEDS``).
"""
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu_torch.core.config import Config, TilerConfig
from building_detection_tpu_torch.core.module import Namer
from building_detection_tpu_torch.infer.pipeline import Pipeline
from building_detection_tpu_torch.models import registry as port_registry
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.utils.io import points_dict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))

import pipeline_fuzz  # noqa: E402

torch.set_num_threads(2)

CFG = pipeline_fuzz.CFG
# The JAX test's seeds, then twelve whose draws add: bug mode with a tall
# scene (7, 19) and with a wide one only (21); buckets (2, 10); buckets and
# blocks (15, 29); blocks (1, 3, 12, 28); degenerate scenes among others (6,
# 12).  ``test_seeds_cover_every_mode`` checks the cover.
SEEDS = [9, 22, 170, 0, 1, 2, 3, 6, 7, 10, 12, 15, 19, 21, 28, 29]


class TinyFn(nn.Module):
    """The port's ``pipeline_fuzz.tiny_fn``: a stride-2 conv, a 2x2
    transposed conv and a softmax conv, with its parameter names."""

    def __init__(self):
        super().__init__()
        n = Namer()
        self.down = L.Conv2d(n, 3, 8, 3, strides=2, activation="relu")
        self.up = L.Conv2dTranspose(n, 8, 8, 2, strides=2, activation="relu")
        self.out = L.Conv2d(n, 8, 2, 3, activation="softmax")

    def forward(self, x):
        return self.out(self.up(self.down(x)))


def draw(seed):
    """``Harness.one_iteration``'s draw: ``(bug, bucket, max_scene_tiles,
    scenes)``."""
    rng = np.random.RandomState(seed)
    bug = rng.rand() < 0.15
    bucket = (not bug) and rng.rand() < 0.3
    blocked = (not bug) and rng.rand() < 0.3
    max_scene_tiles = int(rng.randint(4, 10)) if blocked else None
    n_scenes = int(rng.randint(1, 5))
    scenes = []
    for _ in range(n_scenes):
        kind = rng.rand()
        if kind < 0.08:  # degenerate (<= overlap in one dim)
            h, w = int(rng.randint(1, CFG.overlap + 1)), int(rng.randint(1, 60))
            if rng.rand() < 0.5:
                h, w = w, h
        elif kind < 0.4:  # small, single-or-few tiles
            h, w = int(rng.randint(9, 70)), int(rng.randint(9, 70))
        else:  # multi-tile, possibly very non-square
            h, w = int(rng.randint(40, 260)), int(rng.randint(40, 260))
        scenes.append(
            pipeline_fuzz.synthetic_scene(rng, h, w)
            if rng.rand() < 0.7
            else rng.randint(0, 256, (h, w, 3), np.uint8)
        )
    return bug, bucket, max_scene_tiles, scenes


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The script's harness, with both registries restored afterwards; the
    construction sits inside the ``try`` because it mutates the JAX
    registry before anything can fail."""
    from building_detection_tpu.models import registry

    saved, port_saved = dict(registry.MODEL_REGISTRY), dict(port_registry.MODEL_REGISTRY)
    try:
        for name in port_registry.ENSEMBLE_ORDER:
            port_registry.MODEL_REGISTRY[name] = TinyFn
        yield pipeline_fuzz.Harness(str(tmp_path_factory.mktemp("fuzz_weights")))
    finally:
        registry.MODEL_REGISTRY.clear()
        registry.MODEL_REGISTRY.update(saved)
        port_registry.MODEL_REGISTRY.clear()
        port_registry.MODEL_REGISTRY.update(port_saved)


@pytest.fixture(scope="module")
def port_pipeline(harness):
    """``port_pipeline(bucket, bug, max_scene_tiles)``: the port's
    counterpart of ``Harness.pipeline``, cached the same way."""
    pipes = {}

    def get(bucket, bug, max_scene_tiles):
        key = (bucket, bug, max_scene_tiles)
        if key not in pipes:
            tiler = TilerConfig(tile=CFG.tile, stride=CFG.stride, overlap=CFG.overlap, bucket_sizes=bucket,
                                fix_nonsquare_bug=not bug)
            pipes[key] = Pipeline(weights=harness.weights, cfg=Config(tiler=tiler), batch_tiles=12,
                                  compute_dtype=torch.float32, max_scene_tiles=max_scene_tiles, device="cpu")
        return pipes[key]

    return get


def tall_scene_error(pipe, scenes) -> str:
    with pytest.raises(ValueError, match="tall scene") as e:
        pipe.predict_images(scenes)
    return str(e.value)


def test_draw_is_the_scripts(harness, monkeypatch):
    """The copy draws what ``Harness.one_iteration`` draws: its pipeline key
    and the scenes it passes first, caught before any forward runs."""

    class Drawn(Exception):
        pass

    seen = []

    class Probe:
        def predict_images(self, scenes):
            seen.append(scenes)
            raise Drawn

    for seed in SEEDS:
        monkeypatch.setattr(harness, "pipeline", lambda *key: seen.append(key) or Probe())
        with pytest.raises(Drawn):
            harness.one_iteration(seed)
        bug, bucket, mst, scenes = draw(seed)
        key, got = seen[-2:]
        assert key == (bucket, bug, mst)
        assert len(got) == len(scenes) and all(np.array_equal(a, b) for a, b in zip(got, scenes))


def test_seeds_cover_every_mode():
    modes = [draw(s)[:3] for s in SEEDS]
    assert any(bug for bug, _, _ in modes) and any(bucket for _, bucket, _ in modes)
    assert any(mst is not None for _, _, mst in modes)
    assert any(bug and any(pipeline_fuzz._bug_overruns(*s.shape[:2]) for s in draw(seed)[3])
               for seed, (bug, _, _) in zip(SEEDS, modes))
    assert any(min(s.shape[:2]) <= CFG.overlap for seed in SEEDS for s in draw(seed)[3])  # a degenerate scene


@pytest.mark.parametrize("seed", SEEDS)
def test_port_pipeline_matches_jax_and_the_oracle(harness, port_pipeline, seed):
    bug, bucket, max_scene_tiles, scenes = draw(seed)
    jax_pipe = harness.pipeline(bucket, bug, max_scene_tiles)
    port = port_pipeline(bucket, bug, max_scene_tiles)
    if bug:
        overruns = [pipeline_fuzz._bug_overruns(*s.shape[:2]) for s in scenes]
        if any(overruns):
            assert tall_scene_error(port, scenes) == tall_scene_error(jax_pipe, scenes)
            scenes = [s for s, o in zip(scenes, overruns) if not o]
            if not scenes:
                return
    got, want = port.predict_images(scenes), jax_pipe.predict_images(scenes)
    for idx, (scene, res, jres) in enumerate(zip(scenes, got, want)):
        ctx = f"seed={seed} scene={idx} hw={scene.shape[:2]} bug={bug} bucket={bucket} max_scene_tiles={max_scene_tiles}"
        ref_masks, ref_fused, ref_points = harness.oracle(scene, bug)
        assert list(res.masks) == list(jres.masks) == harness.names, ctx
        for n in harness.names:
            assert np.array_equal(res.masks[n], jres.masks[n]), f"mask {n} differs from JAX: {ctx}"
            assert np.array_equal(res.masks[n], ref_masks[n]), f"mask {n} differs from the oracle: {ctx}"
        assert np.array_equal(res.fused, jres.fused), f"fused differs from JAX: {ctx}"
        assert np.array_equal(res.fused, ref_fused), f"fused differs from the oracle: {ctx}"
        assert res.height == jres.height, ctx
        ours = points_dict(res.corners)
        assert ours == points_dict(jres.corners) or pipeline_fuzz._rings_match_ulp(res.corners, jres.corners), ctx
        theirs = {str(i): "".join(f"{x},{y} " for x, y in zip(xs, ys)) for i, (xs, ys) in enumerate(ref_points)}
        assert ours == theirs or pipeline_fuzz._rings_match_ulp(res.corners, ref_points), ctx

