"""PyTorch port, ``Pipeline`` and serving, held against the JAX package.

The pipelines run tiny members whose class-1 logit follows brightness (two
convs, weights from numpy with a seed), so the scenes' bright rectangles
come out as masks, a fused mask and polygons; f32 on the CPU.
``serve.server.DetectionService`` answers the same ``/photo`` payloads with
the same JSON over the JAX ``Pipeline`` and over the port's.
"""
import dataclasses
import io as _io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_detection_tpu.infer.fused_ensemble import FusedEnsemblePredictor as JaxFused
from building_detection_tpu.infer.pipeline import Pipeline as JaxPipeline
from building_detection_tpu.infer.pipeline import discover_weights as jax_discover_weights
from building_detection_tpu.nn import layers as JL
from building_detection_tpu.serve.server import DetectionService
from building_detection_tpu.train.checkpoint import save_variables
from building_detection_tpu_torch.core.module import jax_variables
from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
from building_detection_tpu_torch.infer.pipeline import Pipeline, discover_weights
from building_detection_tpu_torch.models.registry import init_model
from test_golden import CFG
from test_torch_cuda import NAMES, scenes, tiny_members, tiny_variables

torch.set_num_threads(2)

def tiny_member(s, x):
    """The JAX twin of ``test_torch_cuda.TinyMember``."""
    x = JL.conv2d(s, x, 4, 3, activation="relu")
    return JL.conv2d(s, x, 2, 1, activation="softmax")


def port_pipeline(cfg=CFG):
    pipe = Pipeline(models=(), cfg=cfg, compute_dtype=torch.float32, device="cpu")
    pipe.ensemble = FusedEnsemblePredictor(tiny_members(), cfg.tiler, 4, torch.float32, "cpu")
    return pipe


def jax_pipeline(cfg=CFG):
    pipe = JaxPipeline(models=(), cfg=cfg, compute_dtype=jnp.float32)
    members = {n: (tiny_member, *tiny_variables(i)) for i, n in enumerate(NAMES)}
    pipe.ensemble = JaxFused(members, cfg.tiler, 4, jnp.float32)
    return pipe


@pytest.fixture(scope="module")
def port():
    return port_pipeline()


def png(img):
    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def test_serving_json_matches_jax_pipeline(port, tmp_path):
    answers = {}
    for label, pipe in (("jax", jax_pipeline()), ("port", port)):
        service = DetectionService(pipe, CFG, root_dir=str(tmp_path / label))
        answers[label] = [
            service.handle_photo("10_0_0_1", f"scene{i}.png", png(img))
            for i, img in enumerate(scenes(1, [(200, 260)] * 3))
        ]
    for got, want in zip(answers["port"], answers["jax"]):
        assert got["status"] == "success", got["error"]
        assert got["points"]  # the rectangles come back as polygons
        assert got == want


def test_predict_images_groups_and_degenerate(port):
    imgs = scenes(2, [(200, 260), (200, 260), (120, 170), (10, 12)])
    batch = port.predict_images(imgs)
    for img, res in zip(imgs, batch):
        one = port.predict_image(img)
        assert list(res.masks) == NAMES
        for name, mask in res.masks.items():
            assert mask.shape == img.shape[:2] and mask.dtype == np.uint8
            assert set(np.unique(mask)) <= {0, 255}
            np.testing.assert_array_equal(mask, one.masks[name])
        np.testing.assert_array_equal(res.fused, one.fused)
        assert res.corners == one.corners and res.height == one.height
    assert batch[0].corners
    blank = batch[3]
    assert not any(m.any() for m in blank.masks.values())
    assert not blank.fused.any() and blank.corners == []
    assert {"ensemble_forward", "fusion", "polygons"} <= set(port.timer.summary())


def test_bucketed_plan_gives_the_same_masks(port):
    cfg = dataclasses.replace(CFG, tiler=dataclasses.replace(CFG.tiler, bucket_sizes=True))
    bucketed = port_pipeline(cfg)
    imgs = scenes(3, [(200, 260), (150, 140), (150, 140)])
    for a, b in zip(bucketed.predict_images(imgs), port.predict_images(imgs)):
        for name in NAMES:
            np.testing.assert_array_equal(a.masks[name], b.masks[name])


def test_loads_jax_checkpoints(tmp_path):
    params, state = jax_variables(init_model("hrnet", torch.Generator().manual_seed(1)))
    path = str(tmp_path / "hrnet.npz")
    save_variables(path, params, state)
    pipe = Pipeline({"hrnet": path}, cfg=CFG, models=("hrnet",), compute_dtype=torch.float32, device="cpu")
    got_p, got_s = jax_variables(pipe.ensemble.models["hrnet"])
    for want, got in ((params, got_p), (state, got_s)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_later_features_are_refused(port, tmp_path):
    """Nothing here is refused any more: int8 pointwise convs and ``.h5``
    weights load (``test_torch_int8.py``, ``test_torch_h5.py`` hold them
    against the JAX package), and ``fused=False`` (the per-model engine) and
    scenes over ``max_scene_tiles`` (the blocked path) give the fused
    whole-scene masks."""
    int8 = Pipeline(models=(), int8_pointwise=True, int8_scales={}, device="cpu")
    assert int8.int8_scales == {}
    from building_detection_tpu_torch.train.checkpoint import export_h5_weights

    params, state = jax_variables(init_model("scse", torch.Generator().manual_seed(2)))
    export_h5_weights(str(tmp_path / "scse.h5"), params, state)
    h5 = Pipeline({"scse": str(tmp_path / "scse.h5")}, models=("scse",), compute_dtype=torch.float32, device="cpu")
    got_p, got_s = jax_variables(h5.ensemble.models["scse"])
    assert set(got_p) == set(params) and not got_s and not state
    for k in params:
        np.testing.assert_array_equal(got_p[k], params[k])
    from building_detection_tpu_torch.infer.engine import EnsemblePredictor

    engine = Pipeline(models=("scse",), cfg=CFG, compute_dtype=torch.float32, device="cpu", fused=False)
    assert isinstance(engine.ensemble, EnsemblePredictor) and engine.ensemble.names == ["scse"]
    imgs = scenes(4, [(200, 260)])
    (want,) = port.predict_images(imgs)
    port.max_scene_tiles, port.batch_tiles = 4, 4  # blocks of 4 of the scene's 24 tiles
    try:
        assert port._needs_blocking(imgs[0])
        (got,) = port.predict_images(imgs)
    finally:
        port.max_scene_tiles, port.batch_tiles = 1024, 32
    for name in NAMES:
        np.testing.assert_array_equal(got.masks[name], want.masks[name])
    assert got.corners == want.corners


def test_discover_weights_matches_jax(tmp_path):
    for fname in ("res34.npz", "deep.h5", "hrnet.h5", "bam.npz", "bam.h5", "other.npz"):
        (tmp_path / fname).write_bytes(b"")
    assert discover_weights(str(tmp_path)) == jax_discover_weights(str(tmp_path))
