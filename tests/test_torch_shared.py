"""The port's own copies of the JAX package's host code, held against the originals.

``building_detection_tpu_torch`` keeps its own ``core/config.py``,
``post/{geometry,fusion,edges,_native}.py``, ``utils/{io,profiling}.py``,
``data/dataset.py`` and ``train/callbacks.py::EarlyStopping``.  Each must
give the JAX package's results on the same inputs (made with numpy from a
seed):

* every config dataclass equal in ``dataclasses.asdict``, for its defaults
  and after a ``to_json``/``from_json`` round trip written by either package;
* fused masks bit for bit and polygons equal, on the golden fixture and on
  seeded blob masks;
* ``find_contours``, ``approx_poly_dp``, ``min_area_rect`` and ``fill_holes``
  equal through the port's native library (built from ``native/src`` into
  ``build/torch_kernels``) and through its numpy path alike.  The JAX side
  runs its numpy path, the reference its own native library is fuzzed
  against, so the comparison does not depend on whether that library built;
* ``list_pairs``, ``decode_pair``, ``batch_iterator`` and ``prefetch`` equal
  batches; the io helpers, ``StageTimer`` and ``EarlyStopping`` alike.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from building_detection_tpu.core import config as JC
from building_detection_tpu.data import dataset as JD
from building_detection_tpu.post import edges as JE
from building_detection_tpu.post import fusion as JF
from building_detection_tpu.post import geometry as JG
from building_detection_tpu.train.callbacks import EarlyStopping as JaxEarlyStopping
from building_detection_tpu.utils import io as JIO
from building_detection_tpu.utils.profiling import StageTimer as JaxStageTimer
from building_detection_tpu_torch.core import config as PC
from building_detection_tpu_torch.data import dataset as PD
from building_detection_tpu_torch.post import edges as PE
from building_detection_tpu_torch.post import fusion as PF
from building_detection_tpu_torch.post import geometry as PG
from building_detection_tpu_torch.train.callbacks import EarlyStopping
from building_detection_tpu_torch.utils import io as PIO
from building_detection_tpu_torch.utils.profiling import StageTimer

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_pipeline.npz")
CONFIG_CLASSES = ["TilerConfig", "FuseConfig", "EdgeConfig", "TrainConfig", "AugmentConfig",
                  "ServeConfig", "MeshConfig", "Config"]


@pytest.fixture(autouse=True)
def jax_numpy_path(monkeypatch):
    """The JAX package's geometry on its numpy path in every test here."""
    monkeypatch.setattr(JG, "_nat", None)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """The port's geometry through its native library, or its numpy path."""
    if request.param == "native":
        assert PG.native() is not None, "the port's geometry library did not build"
    else:
        monkeypatch.setattr(PG, "native", lambda: None)
    return request.param


# -- config ------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_defaults_equal(name):
    port, jax_cls = getattr(PC, name), getattr(JC, name)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(jax_cls)]
    assert dataclasses.asdict(port()) == dataclasses.asdict(jax_cls())


def custom(C):
    return C.Config(
        tiler=C.TilerConfig(tile=256, stride=200, overlap=56, bucket_sizes=True),
        fuse=C.FuseConfig(vote_threshold=2, min_area=500.0),
        edge=C.EdgeConfig(big_areas=(1000.0, 2000.0, 4000.0)),
        train=C.TrainConfig(batch_size=4, label_smooth=(0.9, 0.1), class_weights=(0.4, 0.6)),
        augment=C.AugmentConfig(scale_range=(0.5, 1.5)),
        serve=C.ServeConfig(port=6001, drain_timeout_s=5.0),
    )


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_json_round_trip(writer, tmp_path):
    path = str(tmp_path / "cfg.json")
    (custom(PC) if writer == "port" else custom(JC)).to_json(path)
    port, jax_cfg = PC.Config.from_json(path), JC.Config.from_json(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg) == dataclasses.asdict(custom(JC))
    assert port == custom(PC)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(dataclasses.asdict(custom(JC))))


# -- fusion and polygons -----------------------------------------------------
def blob_masks(seed: int, shape=(150, 190)):
    """Five member masks {0,255}: shared rectangles (two touching at a
    corner, one pair touching along an edge), each member's edges jittered by
    a few pixels, plus speckle."""
    rng = np.random.RandomState(seed)
    h, w = shape
    rects = []
    for _ in range(rng.randint(3, 6)):
        y0, x0 = rng.randint(0, h - 50), rng.randint(0, w - 60)
        rects.append((y0, x0, y0 + rng.randint(25, 50), x0 + rng.randint(30, 60)))
    rects.append((10, 10, 45, 50))
    rects.append((45, 50, 80, 95))  # touches the one above at a corner
    masks = []
    for _ in range(5):
        m = np.zeros(shape, np.uint8)
        for y0, x0, y1, x1 in rects:
            j = rng.randint(-3, 4, 4)
            m[max(y0 + j[0], 0):y1 + j[1], max(x0 + j[2], 0):x1 + j[3]] = 255
        m[rng.rand(*shape) < 0.003] = 255
        masks.append(m)
    return masks


def corner_blob(corners):
    return json.dumps([[list(map(float, xs)), list(map(float, ys))] for xs, ys in corners])


def test_golden_fixture_fusion_and_polygons(path):
    data = np.load(FIXTURE)
    masks = [data[f"mask_m{i}"] for i in range(5)]
    cfg = PC.Config()
    fused = PF.fuse_masks(masks, cfg.fuse)
    np.testing.assert_array_equal(fused, data["fused"])
    np.testing.assert_array_equal(fused, JF.fuse_masks(masks, JC.FuseConfig()))
    corners, height = PE.extract_polygons(fused, cfg.edge)
    assert corner_blob(corners) == str(data["corners"]) and height == int(data["height"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fusion_and_polygons_on_seeded_masks(seed, path):
    masks = blob_masks(seed)
    fused = PF.fuse_masks(masks, PC.FuseConfig())
    want = JF.fuse_masks(masks, JC.FuseConfig())
    assert fused.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(fused, want)
    corners, height = PE.extract_polygons(fused, PC.EdgeConfig())
    want_corners, want_height = JE.extract_polygons(want, JC.EdgeConfig())
    assert corners, "the seeded rectangles give polygons"
    assert corner_blob(corners) == corner_blob(want_corners) and height == want_height


# -- geometry ----------------------------------------------------------------
def geometry_masks():
    rng = np.random.RandomState(5)
    noise = (rng.rand(60, 70) < 0.45).astype(np.uint8)
    ring = np.zeros((40, 40), np.uint8)
    ring[5:35, 5:35] = 1
    ring[12:28, 12:28] = 0
    ring[18:22, 18:22] = 1  # an island in the hole: not an external contour
    return [noise, ring, blob_masks(3)[0]]


def test_find_contours(path):
    for mask in geometry_masks():
        got, want = PG.find_contours(mask), JG.find_contours(mask)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tolist() == w.tolist()


def test_approx_poly_dp(path):
    for mask in geometry_masks():
        for contour in PG.find_contours(mask):
            for rate in (0.002, 0.01, 0.05):
                eps = rate * PG.arc_length(contour, True)
                for closed in (True, False):
                    got = PG.approx_poly_dp(contour, eps, closed)
                    assert got.tolist() == JG.approx_poly_dp(contour, eps, closed).tolist()


def test_min_area_rect_and_box_points(path):
    for mask in geometry_masks():
        for contour in PG.find_contours(mask):
            rect = PG.min_area_rect(contour)
            assert rect == JG.min_area_rect(contour)
            np.testing.assert_array_equal(PG.box_points(rect), JG.box_points(rect))


def test_fill_holes_and_flat_morphology(path):
    for mask in geometry_masks():
        np.testing.assert_array_equal(PG.fill_holes(mask), JG.fill_holes(mask))
        img = mask * np.uint8(255)
        for kernel, iters in (((1, 5), 5), ((7, 1), 1), ((3, 3), 2)):
            np.testing.assert_array_equal(PG.erode_np(img, kernel, iters), JG.erode_np(img, kernel, iters))
            np.testing.assert_array_equal(PG.dilate_np(img, kernel, iters), JG.dilate_np(img, kernel, iters))


def test_native_library_is_built_under_a_hashed_name():
    import hashlib

    from building_detection_tpu_torch.post import _native

    lib = _native.load()
    digest = hashlib.sha256(_native.SOURCE.read_bytes() + " ".join(_native.GXX_FLAGS).encode()).hexdigest()[:16]
    assert (_native.BUILD_DIR / f"bdgeometry_{digest}.so").exists()
    assert _native.SOURCE.name == "geometry.cc" and lib is _native.load()


# -- dataset -----------------------------------------------------------------
@pytest.fixture
def png_dataset(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(11)
    for sub in ("img", "lab"):
        (tmp_path / sub).mkdir()
    for i in range(5):
        Image.fromarray(rng.randint(0, 256, (20, 24, 3)).astype(np.uint8)).save(tmp_path / "img" / f"t{i}.png")
        Image.fromarray(np.where(rng.rand(20, 24) < 0.4, 255, 0).astype(np.uint8)).save(tmp_path / "lab" / f"t{i}.png")
    (tmp_path / "img" / "notes.txt").write_text("not an image")
    return str(tmp_path / "img"), str(tmp_path / "lab")


def test_list_pairs_and_decode_pair(png_dataset):
    pairs = PD.list_pairs(*png_dataset)
    assert pairs == JD.list_pairs(*png_dataset) and len(pairs) == 5
    for ip, lp in pairs:
        for got, want in zip(PD.decode_pair(ip, lp, 16), JD.decode_pair(ip, lp, 16)):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_iterator_and_prefetch(png_dataset, shuffle):
    pairs = PD.list_pairs(*png_dataset)
    port = PD.prefetch(PD.batch_iterator(pairs, 2, 16, shuffle=shuffle, seed=3))
    jax_it = JD.batch_iterator(pairs, 2, 16, shuffle=shuffle, seed=3)
    for _ in range(6):  # past one pass of the five pairs
        for got, want in zip(next(port), next(jax_it)):
            np.testing.assert_array_equal(got, want)
    port.close()


def test_prefetch_raises_the_feeders_error():
    def broken():
        yield 1
        raise ValueError("bad file")

    it = PD.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad file"):
        next(it)


# -- io, timer, callbacks ----------------------------------------------------
def test_io_helpers(tmp_path):
    corners = [[[np.int64(3), np.int64(9), np.int64(3)], [np.int64(4), np.int64(7), np.int64(4)]],
               [[np.float32(1.5), np.float32(2.0)], [np.float32(0.5), np.float32(8.25)]]]
    assert PIO.points_dict(corners) == JIO.points_dict(corners)
    PIO.write_points(corners, str(tmp_path / "p.txt"))
    JIO.write_points(corners, str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    img = np.random.RandomState(2).randint(0, 256, (9, 13, 3)).astype(np.uint8)
    PIO.imwrite(str(tmp_path / "sub" / "a.png"), img)
    np.testing.assert_array_equal(PIO.imread_rgb(str(tmp_path / "sub" / "a.png")), img)
    np.testing.assert_array_equal(PIO.imread_gray(str(tmp_path / "sub" / "a.png")),
                                  JIO.imread_gray(str(tmp_path / "sub" / "a.png")))


def test_stage_timer():
    port, jax_timer = StageTimer(), JaxStageTimer()
    for t in (port, jax_timer):
        for name in ("forward", "fusion", "forward"):
            with t.stage(name):
                pass
    assert {k: v["calls"] for k, v in port.summary().items()} == {k: v["calls"] for k, v in jax_timer.summary().items()}
    assert list(port.summary()) == ["forward", "fusion"] and "forward" in port.report()
    port.reset()
    assert port.summary() == {}


@pytest.mark.parametrize("mode", ["max", "min"])
def test_early_stopping(mode, capsys):
    values = [0.5, 0.6, 0.55, 0.58, 0.61, 0.4, 0.3, 0.2, 0.1]
    port, jax_cb = EarlyStopping(patience=3, mode=mode), JaxEarlyStopping(patience=3, mode=mode)
    got = [port(None, e, {"val_PA": v}) for e, v in enumerate(values)]
    want = [jax_cb(None, e, {"val_PA": v}) for e, v in enumerate(values)]
    assert got == want and any(got)
    assert (port.best, port.bad_epochs, port.stopped_epoch) == (jax_cb.best, jax_cb.bad_epochs, jax_cb.stopped_epoch)
    assert port(None, 0, {"loss": 1.0}) is False
