"""The PyTorch port runs without JAX, PIL and OpenCV: the machine with the
card has none of them.  In a subprocess that blocks those imports, every
module of the port imports, and ``make_targets``, a ``Pipeline`` over a
tiny member and a ``Trainer`` (augmented steps, the staged epoch, save and
restore) run end to end on the CPU."""
import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import sys
    for blocked in ("jax", "jaxlib", "PIL", "cv2"):
        sys.modules[blocked] = None
    import importlib, pkgutil
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import building_detection_tpu_torch as pkg
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)
    from building_detection_tpu.core.config import Config, TilerConfig
    from building_detection_tpu_torch.core.module import Namer, init_layers
    from building_detection_tpu_torch.infer.fused_ensemble import FusedEnsemblePredictor
    from building_detection_tpu_torch.infer.pipeline import Pipeline
    from building_detection_tpu_torch.kernels import edge_weights
    from building_detection_tpu_torch.nn import layers as L
    from building_detection_tpu_torch.train.trainer import make_targets

    labels = torch.zeros(2, 32, 32, dtype=torch.uint8)
    labels[:, 8:20, 8:20] = 255
    y = make_targets(labels)
    assert y.shape == (2, 32, 32, 4) and float(y[..., 2:].max()) == 2.0

    cfg = Config(tiler=TilerConfig(tile=32, stride=24, overlap=8))
    pipe = Pipeline(models=(), cfg=cfg, compute_dtype=torch.float32)
    members = {
        f"m{i}": init_layers(L.Conv2d(Namer(), 3, 2, 3, activation="softmax").eval(), torch.Generator().manual_seed(i))
        for i in range(5)
    }
    pipe.ensemble = FusedEnsemblePredictor(members, cfg.tiler, 4, torch.float32)
    img = np.random.RandomState(0).randint(0, 256, (70, 100, 3), np.uint8)
    (res,) = pipe.predict_images([img])
    assert res.masks["m0"].shape == (70, 100) and res.fused.shape == (70, 100)

    import os, tempfile
    from building_detection_tpu.core.config import TrainConfig
    from building_detection_tpu_torch.train.trainer import Trainer

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            n = Namer()
            self.conv, self.bn = L.Conv2d(n, 3, 4, 3), L.BatchNorm(n, 4)
            self.out = L.Conv2d(n, 4, 2, 1, activation="softmax")

        def forward(self, x):
            return self.out(L.relu(self.bn(self.conv(x))))

    cfg = TrainConfig(batch_size=2, image_size=16, epochs=1, warmup_epochs=0)
    tr = Trainer(Tiny, cfg, steps_per_epoch=2, augment=True)
    imgs = np.random.RandomState(1).randint(0, 256, (4, 16, 16, 3), np.uint8)
    labs = np.where(np.random.RandomState(2).rand(4, 16, 16) < 0.4, 255, 0).astype(np.uint8)
    hist = tr.fit_arrays(imgs, labs, log_fn=lambda s: None)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"]) and tr.step == 2
    with tempfile.TemporaryDirectory() as d:
        tr.save(os.path.join(d, "t.npz"))
        again = Trainer(Tiny, cfg, steps_per_epoch=2, augment=True, seed=1)
        again.restore(os.path.join(d, "t.npz"))
        assert again.step == 2 and again.optimizer.count == 2
    for mod in ("jax", "PIL", "cv2"):
        assert sys.modules[mod] is None, mod
    assert "building_detection_tpu.utils.io" not in sys.modules
    assert "building_detection_tpu.serve.server" not in sys.modules
    print("NOJAX-OK")
    """
)


def test_port_runs_without_jax_pil_and_cv2():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    done = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert done.returncode == 0, done.stderr[-4000:]
    assert "NOJAX-OK" in done.stdout
