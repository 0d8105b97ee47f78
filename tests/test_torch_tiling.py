"""PyTorch port, the tiler and the bitplane packing held against the JAX
package: plans equal on a grid of scene sizes, ``normalize`` bit-exact on all
256 uint8 values, the gather and OR-scatter equal, bitplanes in
``np.packbits`` order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_detection_tpu.core.config import TilerConfig
from building_detection_tpu.infer import fused_ensemble as JFE
from building_detection_tpu.ops import tiling as JT
from building_detection_tpu_torch.infer import fused_ensemble as FE
from building_detection_tpu_torch.ops import tiling as T

torch.set_num_threads(2)

SIZES = [1, 100, 152, 153, 360, 512, 513, 700, 872, 1024, 1300, 2000]
CONFIGS = {
    "default": TilerConfig(),
    "bug_mode": TilerConfig(fix_nonsquare_bug=False),
    "small": TilerConfig(tile=32, stride=24, overlap=8),
}


def plan_or_error(module, h, w, cfg):
    try:
        return module.plan_tiles(h, w, cfg)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_plan_tiles_matches_jax(cfg_name):
    cfg = CONFIGS[cfg_name]
    for h in SIZES:
        for w in SIZES:
            want = plan_or_error(JT, h, w, cfg)
            got = plan_or_error(T, h, w, cfg)
            if isinstance(want, str):
                assert got == want
                continue
            assert (got.height, got.width, got.canvas_h, got.canvas_w, got.origins) == (
                want.height, want.width, want.canvas_h, want.canvas_w, want.origins
            )
            bw, bg = JT.bucket_plan(want, cfg), T.bucket_plan(got, cfg)
            assert (bg.canvas_h, bg.canvas_w, bg.origins) == (bw.canvas_h, bw.canvas_w, bw.origins)
            np.testing.assert_array_equal(T.origins_array(got), np.asarray(JT.origins_array(want)))


def test_bug_mode_tall_scene_raises():
    with pytest.raises(ValueError, match="fix_nonsquare_bug=False"):
        T.plan_tiles(2000, 600, TilerConfig(fix_nonsquare_bug=False))


def test_normalize_bit_exact_on_all_uint8():
    v = np.arange(256, dtype=np.uint8)
    want = (v.astype(np.float64) / 127.5 - 1.0).astype(np.float32)
    got = T.normalize(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got, np.asarray(JT.normalize(jnp.asarray(v))))


def test_normalize_casts_to_compute_dtype():
    v = torch.arange(256, dtype=torch.uint8)
    got = T.normalize(v, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, T.normalize(v).to(torch.bfloat16))


def test_extract_and_scatter_match_jax():
    rng = np.random.RandomState(0)
    canvas = rng.uniform(-1, 1, (80, 104, 3)).astype(np.float32)
    plan = JT.plan_tiles(70, 100, CONFIGS["small"])
    origins = np.asarray(JT.origins_array(plan))
    want = np.asarray(JT.extract_tiles(jnp.asarray(canvas), jnp.asarray(origins), 32))
    got = T.extract_tiles(torch.from_numpy(canvas), torch.tensor(origins, dtype=torch.int64), 32).numpy()
    np.testing.assert_array_equal(got, want)
    masks = (rng.rand(len(origins), 32, 32) < 0.3).astype(np.uint8)
    want = np.asarray(JT.scatter_or(jnp.asarray(masks), jnp.asarray(origins), (80, 104)))
    got = T.scatter_or(torch.from_numpy(masks), origins, (80, 104)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,n_bits", [((2, 5, 16), 5), ((1, 3, 13), 5), ((3, 2, 7), 3)])
def test_pack_bitplanes_in_packbits_order(shape, n_bits):
    canvas = np.random.RandomState(1).randint(0, 2 ** n_bits, shape).astype(np.uint8)
    got = FE._pack_bitplanes(torch.from_numpy(canvas), n_bits).numpy()
    want = np.stack([np.packbits((canvas >> b) & 1, axis=-1) for b in range(n_bits)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(JFE._pack_bitplanes(jnp.asarray(canvas), n_bits)))
    np.testing.assert_array_equal(FE._unpack_bitplanes(got, shape[-1]), (canvas[None] >> np.arange(n_bits)[:, None, None, None]) & 1)


def test_split_group_matches_jax():
    jax_pred = JFE.FusedEnsemblePredictor({}, batch_tiles=128)
    port = FE.FusedEnsemblePredictor({}, batch_tiles=128, device="cpu")
    for count in range(1, 70):
        for cap in (1, 2, 5, 14, 32, 128):
            assert port._split_group(count, cap) == jax_pred._split_group(count, cap)
    assert port._group_size(9) == 14
