"""PyTorch port, ``Trainer(remat=True)``: rematerialised stages.

The JAX ``Trainer(remat=True)`` saves only the stage outputs the models tag
with ``remat_tag`` and recomputes the rest in the backward.  The port runs
the same segments under ``torch.utils.checkpoint`` (``nn.layers.stage``).
What must hold, on the CPU in f32:

* for each member at 32 px, three steps with ``remat=True`` give the loss,
  the metrics, the params and the BN moving statistics of ``remat=False``
  bit for bit (the recompute sees the same inputs and weights);
* the moving statistics move once a step: a staged BatchNorm's buffers
  after one remat step equal one Keras update from the batch statistics;
* remat saves fewer activations for the backward (the bytes packed by
  autograd's saved-tensor hooks during the forward), so it does something;
* outside training (eval, or no graph) a stage is a plain call.
"""
import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu_torch.core.config import TrainConfig
from building_detection_tpu_torch.core.module import Namer, init_layers, jax_variables, set_remat
from building_detection_tpu_torch.models.registry import init_model
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

MEMBERS = ["res34", "hrnet", "v3plus", "scse", "bam"]
CFG = TrainConfig(batch_size=2, image_size=32, epochs=1, warmup_epochs=1)


def data(seed, n=2, size=32):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, size, size, 3), np.uint8)
    labels = np.zeros((n, size, size), np.uint8)
    labels[:, 8:20, 6:26] = 255
    return images, labels


@pytest.mark.parametrize("name", MEMBERS)
def test_remat_steps_equal_plain_steps(name):
    runs = {}
    for remat in (False, True):
        tr = Trainer(name, CFG, steps_per_epoch=3, seed=1, remat=remat, device="cpu")
        metrics = [tr.train_on_batch(*data(10 + i)) for i in range(3)]
        runs[remat] = metrics, jax_variables(tr.model)
    (m_plain, (p_plain, s_plain)), (m_remat, (p_remat, s_remat)) = runs[False], runs[True]
    assert m_remat == m_plain  # loss and metrics, every step, exactly
    for want, got in ((p_plain, p_remat), (s_plain, s_remat)):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class Staged(nn.Module):
    """conv -> BN -> conv, the first two one stage."""

    def __init__(self):
        super().__init__()
        n = Namer()
        self.conv1 = L.Conv2d(n, 3, 4, 3)
        self.bn = L.BatchNorm(n, 4)
        self.conv2 = L.Conv2d(n, 4, 2, 1)

    def forward(self, x):
        return self.conv2(L.stage(self, lambda v: L.relu(self.bn(self.conv1(v))), x))


def test_moving_statistics_move_once_a_step():
    model = set_remat(init_layers(Staged(), torch.Generator().manual_seed(2)).train())
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32))
    with torch.no_grad():
        h = model.conv1(x)
    var, mean = torch.var_mean(h, dim=(0, 1, 2), correction=0)
    n = h.numel() // h.shape[-1]
    want_mean = model.bn.moving_mean * 0.99 + mean * 0.01
    want_var = model.bn.moving_variance * 0.99 + var * (n / (n - 1)) * 0.01
    loss = model(x).square().sum()
    loss.backward()  # recomputes the stage
    assert model.conv1.kernel.grad is not None
    torch.testing.assert_close(model.bn.moving_mean, want_mean, rtol=0, atol=0)
    torch.testing.assert_close(model.bn.moving_variance, want_var, rtol=0, atol=0)
    assert "update_moving" not in vars(model.bn)  # the recompute's switch is gone again


def saved_bytes(model, x):
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x).sum()
    return total[0]


@pytest.mark.parametrize("name", MEMBERS)
def test_remat_saves_fewer_activations(name):
    model = init_model(name, torch.Generator().manual_seed(4)).train()
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 32, 32, 3).astype(np.float32))
    plain = saved_bytes(set_remat(model, False), x)
    remat = saved_bytes(set_remat(model, True), x)
    assert remat < plain / 2, (remat, plain)


def test_stage_is_a_plain_call_outside_training():
    model = set_remat(init_layers(Staged(), torch.Generator().manual_seed(6)))
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 8, 8, 3).astype(np.float32))
    model.eval()
    assert saved_bytes(model, x) == saved_bytes(set_remat(model, False), x)
    model.train()
    set_remat(model, True)
    with torch.no_grad():
        y = model(x)
    before = model.bn.moving_mean.clone()
    with torch.no_grad():
        model(x)
    assert not torch.equal(before, model.bn.moving_mean)  # no graph: a plain train-mode call
    assert y.shape == (1, 8, 8, 2)
