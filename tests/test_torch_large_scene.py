"""PyTorch port, blocked large scenes (``infer/large_scene.py``) and the
auto-blocking ``Pipeline``, held against the JAX package.

``plan_blocks`` equals the JAX one over a grid of scene shapes and budgets,
partitions the global tile grid exactly and keeps both refusals.  Blocked
masks equal whole-scene masks, bit for bit, for one ``TiledPredictor``, for
the per-model ``EnsemblePredictor`` and for the ``FusedEnsemblePredictor``,
and equal the JAX package's blocked masks on the same weights (f32, CPU,
``TilerConfig(tile=32, stride=24, overlap=8)``).  ``Pipeline`` with
``fused=False`` and with scenes over ``max_scene_tiles`` answers mixed big
and small scenes in input order, equal to the JAX ``Pipeline``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_detection_tpu.core.config import Config as JaxConfig
from building_detection_tpu.core.config import TilerConfig as JaxTilerConfig
from building_detection_tpu.infer import large_scene as JLS
from building_detection_tpu.infer.engine import EnsemblePredictor as JaxEnsemble
from building_detection_tpu.infer.fused_ensemble import FusedEnsemblePredictor as JaxFused
from building_detection_tpu.infer.pipeline import Pipeline as JaxPipeline
from building_detection_tpu_torch.core.config import Config, TilerConfig
from building_detection_tpu_torch.infer import large_scene as LS
from building_detection_tpu_torch.infer.engine import EnsemblePredictor, TiledPredictor
from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
from building_detection_tpu_torch.infer.pipeline import Pipeline
from building_detection_tpu_torch.ops import tiling as T
from test_engine import tiny_model
from test_torch_cuda import NAMES, scenes, tiny_members, tiny_variables
from test_torch_engine import jax_variables_np, port_model
from test_torch_pipeline import tiny_member

torch.set_num_threads(2)

CFG = TilerConfig(tile=32, stride=24, overlap=8)
JCFG = JaxTilerConfig(tile=32, stride=24, overlap=8)


# three members keep the JAX engine's per-member, per-shape compiles few
MEMBERS = NAMES[:3]
FUSE = dataclasses.replace(Config().fuse, num_models=3, vote_threshold=2)
JFUSE = dataclasses.replace(JaxConfig().fuse, num_models=3, vote_threshold=2)


def port_members():
    return {n: m for n, m in tiny_members().items() if n in MEMBERS}


def jax_members():
    return {n: (tiny_member, *tiny_variables(i)) for i, n in enumerate(MEMBERS)}


# -- plan_blocks ---------------------------------------------------------------
PLAN_SHAPES = [(200, 200), (123, 310), (80, 500), (500, 80), (40, 40), (8, 300), (1000, 37), (301, 299)]


@pytest.mark.parametrize("budget", [1, 6, 30])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[f"{h}x{w}" for h, w in PLAN_SHAPES])
def test_plan_blocks_matches_jax_and_partitions_the_grid(shape, budget):
    h, w = shape
    blocks = LS.plan_blocks(h, w, CFG, budget)
    want = JLS.plan_blocks(h, w, JCFG, budget)
    plan = T.plan_tiles(h, w, CFG)
    if want is None:
        assert blocks is None
        assert plan.num_tiles <= budget or plan.num_tiles == 0
        return
    assert [dataclasses.astuple(b) for b in blocks] == [dataclasses.astuple(b) for b in want]
    seen = []
    for b in blocks:
        local = T.plan_tiles(b.rows, b.cols, CFG)
        assert 0 < local.num_tiles <= budget
        seen += [(r + b.r0, c + b.c0) for r, c in local.origins]
    assert sorted(seen) == sorted(plan.origins)  # every tile once: a partition


@pytest.mark.parametrize(
    "cfg,jcfg,match",
    [
        (dataclasses.replace(CFG, fix_nonsquare_bug=False), dataclasses.replace(JCFG, fix_nonsquare_bug=False),
         "fix_nonsquare_bug"),
        (TilerConfig(tile=40, stride=24, overlap=8), JaxTilerConfig(tile=40, stride=24, overlap=8),
         "tile <= stride"),
    ],
    ids=["bug_mode", "tile_over_stride_plus_overlap"],
)
def test_plan_blocks_refusals_match_jax(cfg, jcfg, match):
    with pytest.raises(ValueError, match=match):
        LS.plan_blocks(500, 500, cfg, 4)
    with pytest.raises(ValueError, match=match):
        JLS.plan_blocks(500, 500, jcfg, 4)


# -- one model -----------------------------------------------------------------
@pytest.fixture(scope="module")
def variables():
    return jax_variables_np()


@pytest.mark.parametrize("shape,budget", [((150, 150), 4), ((123, 210), 4), ((40, 300), 4), ((100, 100), 1)])
def test_blocked_single_model_equals_whole_and_jax(variables, shape, budget):
    from building_detection_tpu.infer.engine import TiledPredictor as JaxTiled

    params, state = variables
    pred = TiledPredictor(port_model(params, state), CFG, 3, torch.float32, "cpu")
    jax_pred = JaxTiled(tiny_model, params, state, JCFG, batch_tiles=3, compute_dtype=jnp.float32)
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape + (3,), np.uint8)
    assert LS.plan_blocks(*shape, CFG, budget) is not None
    got = LS.predict_mask_blocked(pred, img, max_block_tiles=budget)
    np.testing.assert_array_equal(got, pred.predict_mask(img))
    np.testing.assert_array_equal(got, JLS.predict_mask_blocked(jax_pred, img, max_block_tiles=budget))


def test_blocks_in_flight_are_bounded(variables):
    """At most ``max_in_flight`` blocks are dispatched and not fetched."""
    pred = TiledPredictor(port_model(*variables), CFG, 3, torch.float32, "cpu")
    live = {"now": 0, "peak": 0}
    real_dispatch, real_fetch = pred.dispatch, pred.fetch

    def dispatch(img):
        live["now"] += 1
        live["peak"] = max(live["peak"], live["now"])
        return real_dispatch(img)

    def fetch(d):
        live["now"] -= 1
        return real_fetch(d)

    pred.dispatch, pred.fetch = dispatch, fetch
    img = np.random.RandomState(3).randint(0, 256, (300, 300, 3), np.uint8)
    blocked = LS.predict_mask_blocked(pred, img, max_block_tiles=2, max_in_flight=3)
    pred.dispatch, pred.fetch = real_dispatch, real_fetch
    assert live["peak"] == 3 and live["now"] == 0
    assert len(LS.plan_blocks(300, 300, CFG, 2)) > 3
    np.testing.assert_array_equal(blocked, pred.predict_mask(img))


# -- ensembles -------------------------------------------------------------------
@pytest.mark.parametrize("bucket", [False, True], ids=["plain", "bucketed"])
@pytest.mark.parametrize("kind", ["fused", "engine"])
def test_blocked_ensemble_equals_whole_and_jax(kind, bucket):
    cfg = dataclasses.replace(CFG, bucket_sizes=bucket)
    jcfg = dataclasses.replace(JCFG, bucket_sizes=bucket)
    if kind == "fused":
        ens = FusedEnsemblePredictor(port_members(), cfg, 8, torch.float32, "cpu")
        jax_ens = JaxFused(jax_members(), jcfg, 8, jnp.float32)
    else:
        ens = EnsemblePredictor(port_members(), cfg, 3, torch.float32, "cpu")
        jax_ens = JaxEnsemble(jax_members(), jcfg, 3, jnp.float32)
    (img,) = scenes(11, [(170, 250)])
    whole = ens.predict_masks(img)
    got = LS.predict_masks_blocked(ens, img, max_block_tiles=6)
    want = JLS.predict_masks_blocked(jax_ens, img, max_block_tiles=6)
    assert list(got) == MEMBERS
    assert any(m.any() for m in got.values())
    for n in MEMBERS:
        np.testing.assert_array_equal(got[n], whole[n], err_msg=n)
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


# -- Pipeline ----------------------------------------------------------------------
def port_pipeline(fused, max_scene_tiles, cfg=Config(tiler=CFG, fuse=FUSE)):
    pipe = Pipeline(models=(), cfg=cfg, batch_tiles=8, compute_dtype=torch.float32, device="cpu",
                    max_scene_tiles=max_scene_tiles)
    make = FusedEnsemblePredictor if fused else EnsemblePredictor
    pipe.ensemble = make(port_members(), cfg.tiler, 8, torch.float32, "cpu")
    return pipe


def jax_pipeline(fused, max_scene_tiles, cfg=JaxConfig(tiler=JCFG, fuse=JFUSE)):
    pipe = JaxPipeline(models=(), cfg=cfg, batch_tiles=8, compute_dtype=jnp.float32,
                       max_scene_tiles=max_scene_tiles)
    make = JaxFused if fused else JaxEnsemble
    pipe.ensemble = make(jax_members(), cfg.tiler, 8, jnp.float32)
    return pipe


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "engine"])
def test_pipeline_mixed_big_and_small_scenes_match_jax(fused):
    """Scenes over ``max_scene_tiles`` go through the blocked path, the rest
    through one batch; results come back in input order and equal both the
    unblocked port pipeline and the JAX pipeline."""
    # the big scenes' blocks (budget batch_tiles = 8) are 104x56 and 56x56:
    # shapes the small scenes share, so the JAX side compiles few programs
    imgs = scenes(12, [(56, 56), (152, 152), (40, 40), (10, 12), (104, 104), (56, 56)])
    pipe = port_pipeline(fused, max_scene_tiles=6)
    assert [pipe._needs_blocking(i) for i in imgs] == [False, True, False, False, True, False]
    got = pipe.predict_images(imgs)
    whole = port_pipeline(fused, max_scene_tiles=None).predict_images(imgs)
    want = jax_pipeline(fused, max_scene_tiles=6).predict_images(imgs)
    assert len(got) == len(imgs)
    for img, g, h, w in zip(imgs, got, whole, want):
        assert g.fused.shape == img.shape[:2] and g.height == img.shape[0]
        for ref in (h, w):
            assert list(g.masks) == list(ref.masks)
            for n in g.masks:
                np.testing.assert_array_equal(g.masks[n], ref.masks[n], err_msg=n)
            np.testing.assert_array_equal(g.fused, ref.fused)
            assert g.corners == ref.corners
    assert got[1].corners  # the big scene's rectangles come back as polygons


def test_pipeline_big_scene_in_bug_mode_raises_like_jax():
    cfg = Config(tiler=dataclasses.replace(CFG, fix_nonsquare_bug=False), fuse=FUSE)
    jcfg = JaxConfig(tiler=dataclasses.replace(JCFG, fix_nonsquare_bug=False), fuse=JFUSE)
    (img,) = scenes(13, [(150, 150)])
    with pytest.raises(ValueError, match="fix_nonsquare_bug"):
        port_pipeline(True, 6, cfg).predict_images([img])
    with pytest.raises(ValueError, match="fix_nonsquare_bug"):
        jax_pipeline(True, 6, jcfg).predict_images([img])
