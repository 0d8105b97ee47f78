"""PyTorch port on a CUDA card: the edge-weight kernel against its plain twin,
``normalize``, the fused predictor, the per-model engine and the blocked
path on the card against the CPU, the fused predictor on a mesh of cards
(``cuda:0`` twice, and every card) against one card, a full-width
``Trainer`` step, which launches the kernel once, ``torch._int_mm`` and the
int8 predictor against the CPU, a ``remat`` step against a plain one, a
data-parallel step (NCCL, world size 1, in a child process) against a plain
one, ``TiledPredictor(tp=True)`` on ``cuda:0`` twice (and on every card
when there are more) against one card, a ``Trainer(tp=True)`` step of two
Gloo ranks sharing the card against one process, and ``majority_vote`` and
``fill_holes`` on the card against the CPU.

Every test here needs a card (marker ``cuda``) and skips without one.  The
file imports neither JAX nor the JAX package, so it also runs on a machine
with the card and no JAX;
there the suite's ``conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The tiny members and scenes below are shared with ``test_torch_pipeline.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu_torch.core.config import TilerConfig, TrainConfig
from building_detection_tpu_torch.core.module import Namer, load_jax_variables
from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
from building_detection_tpu_torch.kernels import edge_weights as K
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.ops import tiling as T
from building_detection_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

NAMES = ["m0", "m1", "m2", "m3", "m4"]


class TinyMember(nn.Module):
    """Two convs; with :func:`tiny_variables` its class 1 follows brightness."""

    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 4, 3, activation="relu")
        self.conv2 = L.Conv2d(n, 4, 2, 1, activation="softmax")

    def forward(self, x):
        return self.conv2(self.conv1(x))


def tiny_variables(i):
    """JAX-format weights: centre tap ~ mean brightness, class 1 where it is
    high, per-member noise from the seed.  The logit margins are wide, so
    the argmax does not hang on rounding."""
    rng = np.random.RandomState(50 + i)
    k1 = 0.05 * rng.standard_normal((3, 3, 3, 4))
    k1[1, 1] += 1.0 / 3.0
    k2 = 0.2 * rng.standard_normal((1, 1, 4, 2))
    k2[0, 0, :, 1] += 2.0
    k2[0, 0, :, 0] -= 2.0
    b2 = np.array([0.6, -0.6]) + 0.1 * rng.standard_normal(2)
    params = {"conv2d/kernel": k1, "conv2d/bias": np.zeros(4), "conv2d_1/kernel": k2, "conv2d_1/bias": b2}
    return {k: v.astype(np.float32) for k, v in params.items()}, {}


def tiny_members():
    return {n: load_jax_variables(TinyMember().eval(), *tiny_variables(i)) for i, n in enumerate(NAMES)}


def scenes(seed, shapes):
    """Bright rectangles on a darker noisy ground."""
    rng = np.random.RandomState(seed)
    out = []
    for h, w in shapes:
        img = rng.randint(0, 90, (h, w, 3)).astype(np.uint8)
        for _ in range(3):
            y, x = rng.randint(0, max(h - 40, 1)), rng.randint(0, max(w - 40, 1))
            img[y : y + rng.randint(35, 70), x : x + rng.randint(35, 70)] = rng.randint(150, 256, 3)
        out.append(img)
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,args",
    [((8, 512, 512), ()), ((3, 77, 131), (2, 4, 3.0)), ((2, 40, 33), (5, 2, 1.5)), ((1, 1, 1), ()),
     ((2, 64, 96), (2, 3)), ((1, 37, 1030), (4, 3)), ((2, 70, 600), (3, 16))],
    ids=["train_shape", "odd_even_kernel", "kernel5", "one_pixel", "even_window", "wide_ragged", "window33"],
)
def test_kernel_bit_equal_to_plain(cuda, shape, args):
    lab = torch.from_numpy(np.random.RandomState(2).rand(*shape) < 0.3).float().to(cuda)
    before = K.edge_weight_maps.launches
    got = K.edge_weight_maps(lab, *args)
    want = K.edge_weight_maps_plain(lab, *args)
    torch.cuda.synchronize()
    assert K.edge_weight_maps.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_normalize_bit_exact_on_card(cuda):
    v = np.arange(256, dtype=np.uint8)
    want = (v.astype(np.float64) / 127.5 - 1.0).astype(np.float32)
    got = T.normalize(torch.from_numpy(v).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.cuda
def test_fused_predictor_on_card_matches_cpu(cuda):
    cfg = TilerConfig(tile=64, stride=48, overlap=16)
    imgs = scenes(6, [(200, 260), (200, 260), (150, 140), (10, 12)])
    want = FusedEnsemblePredictor(tiny_members(), cfg, 4, torch.float32, "cpu").predict_masks_many(imgs)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = FusedEnsemblePredictor(tiny_members(), cfg, 4, torch.float32, cuda).predict_masks_many(imgs, max_in_flight=2)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for g, w in zip(got, want):
        for name in NAMES:
            np.testing.assert_array_equal(g[name], w[name])


@pytest.mark.cuda
def test_fused_predictor_on_a_mesh_matches_one_device(cuda):
    """Tile data parallelism on the card, f32 with TF32 off and deterministic
    cuDNN, one tile a forward (equal per-forward batch shapes on every
    layout): the fused predictor on ``["cuda:0", "cuda:0"]``, and on every
    card when there are more, gives the one-device masks."""
    from building_detection_tpu_torch.parallel.mesh import make_mesh

    cfg = TilerConfig(tile=64, stride=48, overlap=16)
    imgs = scenes(8, [(200, 260), (200, 260), (150, 140), (10, 12)])
    layouts = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() > 1:
        layouts.append([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        False, True, False)
    try:
        want = FusedEnsemblePredictor(tiny_members(), cfg, 1, torch.float32, cuda).predict_masks_many(imgs)
        for devices in layouts:
            pred = FusedEnsemblePredictor(tiny_members(), cfg, 1, torch.float32, mesh=make_mesh(devices=devices))
            assert pred.batch_tiles == len(devices)
            assert [str(d) for d in pred.replicas] == sorted(set(devices))
            for g, w in zip(pred.predict_masks_many(imgs, max_in_flight=2), want):
                for name in NAMES:
                    np.testing.assert_array_equal(g[name], w[name], err_msg=f"{devices} {name}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.cuda
def test_engine_and_blocked_path_on_card_match_cpu(cuda):
    """The per-model engine and the blocked path on the card, f32 with TF32
    off, against the engine on the CPU: every dispatch runs one tile, so
    batch shapes are equal everywhere."""
    from building_detection_tpu_torch.infer import large_scene as LS
    from building_detection_tpu_torch.infer.engine import EnsemblePredictor

    cfg = TilerConfig(tile=64, stride=48, overlap=16)
    imgs = scenes(7, [(200, 260), (150, 140), (10, 12)])
    want = EnsemblePredictor(tiny_members(), cfg, 1, torch.float32, "cpu")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = EnsemblePredictor(tiny_members(), cfg, 1, torch.float32, cuda)
        for img in imgs:
            w = want.predict_masks(img)
            for g in (got.predict_masks(img), LS.predict_masks_blocked(got, img, max_block_tiles=4)):
                for name in NAMES:
                    np.testing.assert_array_equal(g[name], w[name])
        np.testing.assert_array_equal(
            LS.predict_mask_blocked(got.predictors["m0"], imgs[0], max_block_tiles=2, max_in_flight=3),
            want.predictors["m0"].predict_mask(imgs[0]),
        )
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_full_width_train_step_on_card(cuda, dtype):
    """res34 at 512x512, batch 8: finite loss, f32 params on the card, one
    edge-kernel launch per step."""
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (8, 512, 512, 3)).astype(np.uint8)
    labs = np.where(rng.rand(8, 512, 512) < 0.3, 255, 0).astype(np.uint8)
    tr = Trainer("res34", TrainConfig(warmup_epochs=0), compute_dtype=dtype, device=cuda)
    before = K.edge_weight_maps.launches
    losses = [tr.train_on_batch(imgs, labs)["loss"] for _ in range(2)]
    assert K.edge_weight_maps.launches == before + 2
    assert all(np.isfinite(losses))
    assert all(p.dtype == torch.float32 and p.is_cuda for p in tr.model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(32768, 728, 728), (8, 2048, 256), (1024, 728, 45), (1024, 512, 1), (5, 3, 2)],
                         ids=["xception_site", "pool_rows", "bam_45", "scse_1", "all_padded"])
def test_int8_matmul_on_card_is_int_mm_and_exact(cuda, mkn):
    """``torch._int_mm`` (padded where the shape needs it) equals the int32
    twin bit for bit, and is what runs: one counted launch a call."""
    m, k, n = mkn
    rng = np.random.RandomState(m + k + n)
    a = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    before = L.int8_matmul.calls
    got = L.int8_matmul(a.to(cuda), wq.to(cuda).t())
    assert L.int8_matmul.calls == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), L.int8_matmul_plain(a, wq.t()))


@pytest.mark.cuda
def test_int8_predictor_on_card_matches_cpu(cuda):
    """The tiny members' 1x1 heads quantized with fixed scales: the card's
    masks equal the CPU's (f32, TF32 off), and every chunk went through
    ``_int_mm``."""
    cfg = TilerConfig(tile=64, stride=48, overlap=16)
    imgs = scenes(12, [(200, 260), (150, 140)])
    scales = {n: {"conv2d_1": 1.0 + 0.25 * i} for i, n in enumerate(NAMES)}
    want = FusedEnsemblePredictor(tiny_members(), cfg, 4, torch.float32, "cpu", int8_pointwise=True,
                                  int8_scales=scales).predict_masks_many(imgs)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    before = L.int8_matmul.calls
    try:
        got = FusedEnsemblePredictor(tiny_members(), cfg, 4, torch.float32, cuda, int8_pointwise=True,
                                     int8_scales=scales).predict_masks_many(imgs)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert L.int8_matmul.calls > before and (L.int8_matmul.calls - before) % len(NAMES) == 0
    for g, w in zip(got, want):
        for name in NAMES:
            np.testing.assert_array_equal(g[name], w[name])


@pytest.mark.cuda
def test_remat_train_step_on_card_equals_plain(cuda):
    """scse at 256x256, batch 2, f32 with TF32 off and deterministic cuDNN:
    a remat step equals a plain one bit for bit."""
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (2, 256, 256, 3)).astype(np.uint8)
    labs = np.where(rng.rand(2, 256, 256) < 0.3, 255, 0).astype(np.uint8)
    cfg = TrainConfig(batch_size=2, image_size=256, warmup_epochs=0)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        False, True, False)
    try:
        runs = []
        for remat in (False, True):
            tr = Trainer("scse", cfg, device=cuda, remat=remat)
            runs.append((tr.train_on_batch(imgs, labs), [p.detach().cpu() for p in tr.model.parameters()]))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    (m0, p0), (m1, p1) = runs
    assert m0 == m1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def nccl_world_one_worker(port: int) -> None:
    """Child of :func:`test_nccl_world_one_step_equals_plain`: a tiny
    conv-BN-conv model, f32 with TF32 off and deterministic cuDNN, one step
    under an NCCL mesh of world size 1 and one plain step, bit-equal."""
    from building_detection_tpu_torch.parallel import distributed as pdist
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from test_torch_distributed import TorchTiny

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    pdist.init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh()
        assert (mesh.data, mesh.group, mesh.backend, mesh.device.type) == (1, None, "nccl", "cuda"), mesh
        rng = np.random.RandomState(2)
        imgs = rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8)
        labs = np.where(rng.rand(4, 64, 64) < 0.3, 255, 0).astype(np.uint8)
        cfg = TrainConfig(batch_size=4, image_size=64, warmup_epochs=0)
        runs = []
        for m in (mesh, None):
            tr = Trainer(TorchTiny, cfg, mesh=m)
            before = K.edge_weight_maps.launches
            metrics = tr.train_on_batch(imgs, labs)
            assert K.edge_weight_maps.launches == before + 1
            runs.append((metrics, [t.detach().cpu() for t in tr.model.state_dict().values()]))
        (m0, v0), (m1, v1) = runs
        assert m0 == m1, (m0, m1)
        assert all(torch.equal(a, b) for a, b in zip(v0, v1))
    finally:
        pdist.destroy()
    print("nccl world one: bit-equal", flush=True)


@pytest.mark.cuda
def test_nccl_world_one_step_equals_plain(cuda):
    from building_detection_tpu_torch.parallel import dryrun

    here = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, os.path.join(here, "test_torch_cuda.py"), "nccl-worker", str(dryrun.free_port())]
    ((rc, out),) = dryrun.run_processes([argv], dryrun.port_env(), 300, cwd=here)
    assert rc == 0 and "bit-equal" in out, out[-6000:]


if __name__ == "__main__" and sys.argv[1:2] == ["nccl-worker"]:
    nccl_world_one_worker(int(sys.argv[2]))


@pytest.mark.cuda
def test_tp_predictor_on_card_matches_one_device(cuda):
    """Channel TP in f32 with TF32 off and deterministic cuDNN:
    ``TiledPredictor(tp=True)`` over ``cuda:0`` twice (``model=2``), and over
    every card when there are more, on ``test_torch_distributed.LayerZoo``
    (every layer class the rule shards): softmax within 1e-5 of one card,
    masks equal."""
    import copy

    from building_detection_tpu_torch.core.module import init_layers
    from building_detection_tpu_torch.infer.engine import TiledPredictor
    from building_detection_tpu_torch.parallel.mesh import make_mesh
    from test_torch_distributed import LayerZoo

    cfg = TilerConfig(tile=32, stride=24, overlap=8)
    base = init_layers(LayerZoo(), torch.Generator().manual_seed(7))
    layouts = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() > 1:
        layouts.append([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    (img,) = scenes(9, [(90, 130)])
    tiles = torch.rand((5, 32, 32, 3), device=cuda) * 2 - 1
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        False, True, False)
    try:
        one = TiledPredictor(copy.deepcopy(base), cfg, 4, torch.float32, cuda)
        want = one.predict_mask(img)
        for devices in layouts:
            tp = TiledPredictor(copy.deepcopy(base), cfg, 4, torch.float32, tp=True,
                                mesh=make_mesh(devices=devices, data=1, model=len(devices)))
            assert tp.tp and tp.devices == (torch.device("cuda:0"),)
            np.testing.assert_array_equal(tp.predict_mask(img), want, err_msg=str(devices))
            with torch.inference_mode():
                err = float((tp.replicas[tp.device](tiles) - one.model(tiles)).abs().max())
            assert err <= 1e-5, (devices, err)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.cuda
def test_morphology_on_card_matches_cpu(cuda):
    from building_detection_tpu_torch.ops import morphology as morph

    rng = np.random.RandomState(10)
    masks = torch.from_numpy((rng.rand(5, 300, 400) < 0.5).astype(np.uint8))
    assert torch.equal(morph.majority_vote(masks.to(cuda)).cpu(), morph.majority_vote(masks))
    mask = torch.from_numpy((rng.rand(2, 120, 90) < 0.6).astype(np.uint8))
    got, steps = morph.fill_holes_counted(mask.to(cuda))
    want, want_steps = morph.fill_holes_counted(mask)
    assert torch.equal(got.cpu(), want) and steps == want_steps


@pytest.mark.cuda
def test_tp_train_step_of_two_gloo_ranks_on_card_matches_one_process(cuda, tmp_path):
    """``test_torch_distributed.LayerZoo`` (BatchNorm 4-D and 2-D, every
    sharded layer class) over two Gloo ranks sharing the card at ``data=1 x
    model=2``, f32 with TF32 off: one step within loss rel 2e-4 and params
    rtol 1e-3 / atol 1e-4 and Adam moments within ``MOMENT_RTOL`` of one
    process on the card; inside the ranks,
    save/restore and ``remat=True`` bit-equal."""
    from test_torch_distributed import (LayerZoo, assert_moments_close, assert_step_close, one_process_step, run_tp,
                                        zoo_weights)

    step, (params, _, opt, n, _) = run_tp(tmp_path, 1, 2, "zoo", *zoo_weights(), device="cuda")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        False, True, False)
    try:
        one, (one_params, _), one_opt = one_process_step(LayerZoo, str(tmp_path / "init.npz"), device="cuda")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    assert n == 1
    assert_step_close(step, params, one, one_params)
    assert_moments_close(opt, one_opt)
