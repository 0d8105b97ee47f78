"""PyTorch port, the offline dataset builder (``data/augment.py::
DatasetBuilder``) and ``python -m building_detection_tpu_torch.cli.augment``
held against the JAX package: from the same seed, ``run``,
``run_copy_paste`` and ``split_train_val`` and the CLI write the same files,
byte for byte."""
import os

import numpy as np
import pytest

from building_detection_tpu.cli import augment as jax_cli
from building_detection_tpu.core.config import AugmentConfig as JaxAugmentConfig
from building_detection_tpu.data.augment import DatasetBuilder as JaxBuilder
from building_detection_tpu.utils import io as jax_uio
from building_detection_tpu_torch.cli import augment as port_cli
from building_detection_tpu_torch.core.config import AugmentConfig
from building_detection_tpu_torch.data.augment import DatasetBuilder
from test_torch_cli import listing

# building coverage of each pair: donors in (7.5 %, 20 %], recipients <= 7.5 %,
# one untouched above 20 %
COVERAGE = {"p0": 0.10, "p1": 0.02, "p2": 0.15, "p3": 0.40, "p4": 0.0, "p5": 0.05}


def write_dataset(root, shape=(40, 48)):
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.RandomState(0)
    h, w = shape
    for name, cov in COVERAGE.items():
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        lab = np.zeros((h, w), np.uint8)
        lab.flat[: int(cov * h * w)] = 255
        jax_uio.imwrite(str(img_dir / f"{name}.png"), img)
        jax_uio.imwrite(str(lab_dir / f"{name}.png"), np.ascontiguousarray(lab))
    return str(img_dir), str(lab_dir)


def builders(tmp_path, seed, **kw):
    img_dir, lab_dir = write_dataset(tmp_path)
    out = {}
    for label, cls, cfg in (("port", DatasetBuilder, AugmentConfig), ("jax", JaxBuilder, JaxAugmentConfig)):
        out[label] = cls(img_dir, lab_dir, str(tmp_path / label / "img"), str(tmp_path / label / "lab"),
                         cfg=cfg(**kw), seed=seed)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_and_split_write_the_jax_bytes(tmp_path, seed):
    b = builders(tmp_path, seed)
    counts = {k: v.run() for k, v in b.items()}
    assert counts["port"] == counts["jax"] >= len(COVERAGE)
    assert any(name.endswith("_3.png") for name in os.listdir(tmp_path / "port" / "img"))  # a rescaled copy
    splits = {k: v.split_train_val(*(str(tmp_path / k / "split" / d) for d in ("ti", "tl", "vi", "vl")))
              for k, v in b.items()}
    assert splits["port"] == splits["jax"]
    assert listing(tmp_path / "port") == listing(tmp_path / "jax")


def test_copy_paste_writes_the_jax_bytes(tmp_path):
    b = builders(tmp_path, 3, scale_range=(0.8, 1.2))
    counts = {k: v.run_copy_paste() for k, v in b.items()}
    assert counts["port"] == counts["jax"] == 3  # p1, p4, p5 receive
    assert sorted(os.listdir(tmp_path / "port" / "img")) == ["p1_5.png", "p4_5.png", "p5_5.png"]
    assert listing(tmp_path / "port") == listing(tmp_path / "jax")


def test_missing_input_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        DatasetBuilder(str(tmp_path / "none"), str(tmp_path / "none"), str(tmp_path / "a"), str(tmp_path / "b"))


def test_augment_cli_writes_the_jax_bytes(tmp_path, capsys):
    img_dir, lab_dir = write_dataset(tmp_path)
    for label, cli in (("port", port_cli), ("jax", jax_cli)):
        root = tmp_path / label
        assert cli.main([
            "--images", img_dir, "--labels", lab_dir,
            "--out-images", str(root / "img"), "--out-labels", str(root / "lab"),
            "--split-dir", str(root / "split"), "--split-rate", "0.8", "--seed", "4", "--copy-paste",
        ]) == 0
    out = capsys.readouterr().out
    assert "copy-paste transplant pairs" in out and "split:" in out
    got = listing(tmp_path / "port")
    assert any(k.startswith(os.path.join("split", "val")) for k in got)
    assert got == listing(tmp_path / "jax")
