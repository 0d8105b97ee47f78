"""PyTorch port, morphology, the edge-weight kernel's plain twin and
``make_targets``, held against the JAX package bit for bit: the JAX
``ops.morphology.edge_weight_maps`` and the Pallas kernel
``edge_weight_maps_pallas`` run in interpret mode, as ``tests/test_kernels.py``
runs it.  The CUDA kernel itself is tested in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from building_detection_tpu.core.config import TrainConfig
from building_detection_tpu.kernels.pallas_morphology import edge_weight_maps_pallas
from building_detection_tpu.ops import morphology as JM
from building_detection_tpu.train.trainer import make_targets as jax_make_targets
from building_detection_tpu_torch.kernels import edge_weights as K
from building_detection_tpu_torch.ops import morphology as MO
from building_detection_tpu_torch.train.trainer import make_targets
from test_kernels import labels

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "kernel,iterations",
    [(3, 1), (3, 5), ((1, 5), 5), ((5, 1), 2), (2, 3), ((2, 4), 1)],
    ids=["3x1", "3x5", "1x5_x5", "5x1_x2", "2x3_even", "2x4_even"],
)
def test_erode_dilate_match_jax(kernel, iterations):
    x = np.random.RandomState(0).uniform(-1, 1, (2, 23, 31)).astype(np.float32)
    for port, ref in ((MO.erode, JM.erode), (MO.dilate, JM.dilate)):
        got = port(torch.from_numpy(x), kernel, iterations).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref(jnp.asarray(x), kernel, iterations)))


@pytest.mark.parametrize("seed", range(4))
def test_edge_weight_maps_bit_equal_to_jax_and_pallas(seed):
    lab = labels(seed)
    f_ref, p_ref = JM.edge_weight_maps(jnp.asarray(lab))
    f_pl, p_pl = edge_weight_maps_pallas(jnp.asarray(lab), interpret=True)
    f_got, p_got = MO.edge_weight_maps(torch.from_numpy(lab))
    for got, ref, pl in ((f_got, f_ref, f_pl), (p_got, p_ref, p_pl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pl))
    f_plain, p_plain = K.edge_weight_maps_plain(torch.from_numpy(lab))
    assert torch.equal(f_plain, f_got) and torch.equal(p_plain, p_got)


@pytest.mark.parametrize("kernel,iterations,weight", [(3, 2, 3.0), (5, 3, 1.5), (2, 5, 2.0)])
def test_edge_weight_maps_other_settings(kernel, iterations, weight):
    lab = labels(11, n=3, hw=40)
    want = JM.edge_weight_maps(jnp.asarray(lab), kernel, iterations, weight)
    got = MO.edge_weight_maps(torch.from_numpy(lab), kernel, iterations, weight)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_edge_weight_maps_any_leading_shape():
    lab = labels(3, n=4, hw=24).reshape(2, 2, 24, 24)
    want = JM.edge_weight_maps(jnp.asarray(lab))
    got = MO.edge_weight_maps(torch.from_numpy(lab))
    for g, w in zip(got, want):
        assert g.shape == (2, 2, 24, 24)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("smooth", [None, (0.9, 0.1)], ids=["plain", "smoothed"])
def test_make_targets_bit_equal_to_jax(smooth):
    lab = (labels(5, n=3, hw=48) * 255).astype(np.uint8)
    want = np.asarray(jax_make_targets(jnp.asarray(lab), TrainConfig(), smooth))
    got = make_targets(torch.from_numpy(lab), TrainConfig(), smooth).numpy()
    assert got.shape == (3, 48, 48, 4)
    np.testing.assert_array_equal(got, want)


def test_wrapper_checks_its_input():
    lab = torch.from_numpy(labels(0, n=2, hw=16))
    with pytest.raises(ValueError, match="float32"):
        K.edge_weight_maps(lab.double())
    with pytest.raises(ValueError, match="float32"):
        K.edge_weight_maps(lab[0])
    with pytest.raises(ValueError, match="float32"):
        K.edge_weight_maps(lab.transpose(1, 2))
    with pytest.raises(ValueError, match="window"):
        K.edge_weight_maps(lab, kernel=3, iterations=20)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        K.edge_weight_maps(lab.to("meta"))


def test_cpu_tensor_takes_the_plain_path():
    before = K.edge_weight_maps.launches
    K.edge_weight_maps(torch.from_numpy(labels(1, n=1, hw=16)))
    assert K.edge_weight_maps.launches == before
