"""PyTorch port, ``parallel/`` in one process (no process group is started).

* ``make_mesh``'s gcd rule at world sizes 1, 2 and 8 and batches 2, 8 and
  12 (the cases of ``tests/test_parallel.py``), its refusals: a rank left
  out of the mesh, a data axis wider than the run or that the batch does
  not divide, a model axis in one process; several devices in one process
  make a data axis of them (``test_torch_tile_parallel.py`` holds that
  mesh);
* the row helpers on a rank of a two-rank mesh, and ``local_sample_indices``
  and ``stage_local_dataset`` at world size 1, equal to the JAX package's
  and to ``stage_dataset``;
* ``Trainer(mesh=make_mesh(data=1), device="cpu")`` bit-equal to
  ``Trainer(device="cpu")`` over 3 augmented steps, and through ``fit``
  and ``fit_arrays`` with ``from_process_local``; a device the mesh
  contradicts raises;
* augmentation under data parallelism: rank ``r``'s batch is rows of the
  global batch's augmentation (the decisions are drawn for the global batch);
* ``init_distributed`` refuses incomplete arguments and a missing
  ``torchrun`` environment before it starts anything, and picks a process's
  card from ``local_device_ids`` before its local rank.

The two-process runs are in ``test_torch_distributed.py``.
"""
import jax
import numpy as np
import pytest
import torch

from building_detection_tpu.core.config import TrainConfig as JaxTrainConfig
from building_detection_tpu.parallel import distributed as jdist
from building_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from building_detection_tpu.train.trainer import Trainer as JaxTrainer
from building_detection_tpu_torch.core.config import AugmentConfig, TrainConfig
from building_detection_tpu_torch.data import augment as PA
from building_detection_tpu_torch.parallel import distributed as pdist
from building_detection_tpu_torch.parallel import mesh as pmesh
from building_detection_tpu_torch.train.trainer import Trainer
from test_torch_train import TorchTiny, jax_tiny, tiny_data
from test_torch_trainer import assert_same_model, quiet

torch.set_num_threads(2)

CFG = TrainConfig(batch_size=4, image_size=16, epochs=2, warmup_epochs=1)


@pytest.mark.parametrize(
    "world,batch,want",
    [(1, 2, 1), (1, 8, 1), (1, 12, 1), (2, 2, 2), (2, 8, 2), (2, 12, 2), (8, 2, 2), (8, 8, 8), (8, 12, 4)],
)
def test_gcd_rule_caps_the_data_axis(world, batch, want):
    """data=-1 with a batch hint takes gcd(batch, processes): the JAX rule
    (``tests/test_parallel.py``, with processes for devices); an explicit
    data axis wins."""
    assert pmesh.data_axis_size(world, -1, 1, batch) == want
    assert pmesh.data_axis_size(world, 4, 1, 2) == 4
    if world == 8:
        assert jax_make_mesh(data=-1, batch_size=batch).shape["data"] == want


def test_mesh_must_cover_every_rank():
    pmesh.check_covers_ranks(8, 8)
    with pytest.raises(ValueError, match=r"excludes rank\(s\) \[2, 3, 4, 5, 6, 7\].*--batch-size"):
        pmesh.check_covers_ranks(8, pmesh.data_axis_size(8, -1, 1, 2), 1, 2)
    with pytest.raises(ValueError, match="needs 4 processes and the run has 2.*--num-processes"):
        pmesh.check_covers_ranks(2, 4)
    with pytest.raises(ValueError, match="needs 2 processes.*torchrun"):
        pmesh.make_mesh(data=2)  # one process, no group
    with pytest.raises(ValueError, match="model=2 needs 2 processes and the run has 1"):
        pmesh.make_mesh(model=2)  # a model axis over processes needs them too
    with pytest.raises(ValueError, match="batch of 6 does not split over data=4.*--batch-size"):
        pmesh.check_covers_ranks(4, 4, 1, 6)
    local = pmesh.make_mesh(devices=["cpu", "cpu"])  # several devices in one process: a data axis of them
    assert (local.data, local.world_size, local.group, local.devices) == (2, 1, None, (torch.device("cpu"),) * 2)
    assert not torch.distributed.is_initialized()


def test_one_process_mesh():
    mesh = pmesh.make_mesh(batch_size=8)
    assert (mesh.data, mesh.model, mesh.rank, mesh.world_size) == (1, 1, 0, 1)
    assert mesh.group is None and mesh.device is None and mesh.backend is None
    assert mesh.shape == {"data": 1, "model": 1}
    assert pmesh.make_mesh(devices="cpu").device == torch.device("cpu")
    assert pmesh.make_mesh(devices=[torch.device("cpu")]).device == torch.device("cpu")


def test_row_helpers_on_rank_one_of_two():
    mesh = pmesh.Mesh(data=2, model=1, rank=1, world_size=2)
    x = np.arange(8 * 3).reshape(8, 3)
    assert pmesh.data_rows(mesh, 8) == slice(4, 8)
    imgs, labs = pmesh.shard_batch((x, x * 2), mesh)
    np.testing.assert_array_equal(imgs, x[4:])
    np.testing.assert_array_equal(labs, 2 * x[4:])
    staged = np.arange(3 * 8).reshape(3, 8)
    np.testing.assert_array_equal(pmesh.shard_staged(staged, mesh), staged[:, 4:])
    with pytest.raises(ValueError, match="does not split"):
        pmesh.data_rows(mesh, 7)
    np.testing.assert_array_equal(pdist.local_sample_indices(20, 8, mesh), [4, 5, 6, 7, 12, 13, 14, 15])
    pmesh.replicate([torch.ones(3)], pmesh.Mesh(1, 1, 0, 1))  # no group: nothing runs


def test_local_sample_indices_and_stage_local_at_world_one():
    """One process feeds every complete batch, in order, as in the JAX
    package; ``stage_local_dataset`` then equals ``stage_dataset``."""
    imgs, labs = tiny_data(1, n=20)
    jt = JaxTrainer(jax_tiny, JaxTrainConfig(batch_size=8, image_size=16), steps_per_epoch=1,
                    mesh=jax_make_mesh(data=1, devices=jax.devices()[:1]))
    tr = Trainer(TorchTiny, TrainConfig(batch_size=8, image_size=16), mesh=pmesh.make_mesh(), device="cpu")
    idx = pdist.local_sample_indices(20, 8, tr.mesh)
    np.testing.assert_array_equal(idx, jdist.local_sample_indices(20, 8, jt.mesh))
    np.testing.assert_array_equal(idx, np.arange(16))
    for a, b in zip(tr.stage_dataset(imgs, labs), pdist.stage_local_dataset(tr, imgs[idx], labs[idx])):
        assert a.shape[:2] == (2, 8)
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="at least one local batch of 8"):
        pdist.stage_local_dataset(tr, imgs[:7], labs[:7])


def test_mesh_trainer_at_data_one_is_the_plain_trainer():
    """No collective runs at data == 1: three augmented steps with the
    mesh are the plain steps, bit for bit."""
    imgs, labs = tiny_data(2, n=12)
    plain = Trainer(TorchTiny, CFG, steps_per_epoch=3, augment=True, augment_seed=3, device="cpu")
    meshed = Trainer(TorchTiny, CFG, steps_per_epoch=3, augment=True, augment_seed=3,
                     mesh=pmesh.make_mesh(data=1), device="cpu")
    assert meshed.mesh.data == 1 and meshed.device == torch.device("cpu")
    for i in range(3):
        b = slice(4 * i, 4 * i + 4)
        assert meshed.train_on_batch(imgs[b], labs[b]) == plain.train_on_batch(imgs[b], labs[b])
    assert_same_model(plain, meshed)
    assert meshed.eval_on_batch(imgs[:4], labs[:4]) == plain.eval_on_batch(imgs[:4], labs[:4])


@pytest.mark.parametrize("stage", ["staged", "stream"])
def test_fit_arrays_from_process_local_at_world_one(stage):
    imgs, labs = tiny_data(3, n=12)
    a = Trainer(TorchTiny, CFG, steps_per_epoch=3, device="cpu")
    b = Trainer(TorchTiny, CFG, steps_per_epoch=3, mesh=pmesh.make_mesh(), device="cpu")
    ha = a.fit_arrays(imgs, labs, imgs[:4], labs[:4], log_fn=quiet, stage=stage)
    idx = pdist.local_sample_indices(len(imgs), CFG.batch_size, b.mesh)
    hb = b.fit_arrays(imgs[idx], labs[idx], imgs[:4], labs[:4], log_fn=quiet, stage=stage, from_process_local=True)
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    assert [h["val_IoU"] for h in ha] == [h["val_IoU"] for h in hb]
    assert_same_model(a, b)


def test_device_the_mesh_contradicts_raises():
    with pytest.raises(ValueError, match="contradicts the mesh's device"):
        Trainer(TorchTiny, CFG, mesh=pmesh.make_mesh(devices="cuda:0"), device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        Trainer(TorchTiny, CFG, mesh=pmesh.Mesh(1, 1, 0, 1, backend="nccl"), device="cpu")
    assert Trainer(TorchTiny, CFG, mesh=pmesh.make_mesh(devices="cpu")).device == torch.device("cpu")


@pytest.mark.parametrize("data", [2, 4])
def test_augmentation_draws_for_the_global_batch(data):
    """Each rank's augmented rows are the rows of the global batch's
    augmentation: the decisions are drawn for the global batch and sliced."""
    imgs, labs = tiny_data(4, n=8)
    cfg = AugmentConfig()
    whole = PA.augment_batch(torch.from_numpy(imgs), torch.from_numpy(labs), 7, 5, cfg)
    n = 8 // data
    for rank in range(data):
        part = PA.augment_batch(torch.from_numpy(imgs[rank * n:(rank + 1) * n]),
                                torch.from_numpy(labs[rank * n:(rank + 1) * n]), 7, 5, cfg, shard=(rank, data))
        assert torch.equal(part[0], whole[0][rank * n:(rank + 1) * n])
        assert torch.equal(part[1], whole[1][rank * n:(rank + 1) * n])
    alone = PA.augment_batch(torch.from_numpy(imgs[n:2 * n]), torch.from_numpy(labs[n:2 * n]), 7, 5, cfg)
    assert not torch.equal(alone[0], whole[0][n:2 * n])  # drawing for the local batch would differ


def test_init_distributed_refuses_before_starting(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        pdist.init_distributed(backend="gloo")
    with pytest.raises(ValueError, match="together"):
        pdist.init_distributed("127.0.0.1:1", 2, backend="gloo")
    with pytest.raises(ValueError, match="outside 0..1"):
        pdist.init_distributed("127.0.0.1:1", 2, 2, backend="gloo")
    assert not torch.distributed.is_initialized()
    assert pdist.is_primary()
    pdist.destroy()  # no group: nothing to tear down


def test_cuda_index_prefers_local_device_ids():
    assert [pdist.cuda_index(r, None, 4) for r in range(6)] == [0, 1, 2, 3, 0, 1]
    assert pdist.cuda_index(0, [3], 4) == 3  # names a card other than the local rank's
    assert pdist.cuda_index(1, [0], 4) == 0  # two ranks sharing card 0
    # several ids are a launched worker's process's cards: its local rank's
    assert [pdist.cuda_index(r, [2, 3], 4) for r in range(2)] == [2, 3]
    with pytest.raises(ValueError, match="local rank 2 has no card"):
        pdist.cuda_index(2, [0, 1], 4)
    with pytest.raises(ValueError, match="names no card"):
        pdist.cuda_index(0, [4], 4)
