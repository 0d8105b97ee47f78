"""PyTorch port, Keras ``.h5`` weights and ``bdt-convert``, held against the JAX package.

* the port's ``import_h5_weights`` and the JAX one give equal arrays (key
  order included) and equal reports on the same files, whichever package
  wrote them, for the five members and for the traps the JAX tests pin
  (name pass all or nothing, the order fallback, strict partial and
  leftover imports, depthwise axes, Keras' per-layer weight rank);
* both packages' exports write the same file;
* ``keras_layer_order.json`` is the JAX package's, byte for byte;
* a port ``Pipeline`` built from an ``.h5`` gives the JAX ``Pipeline``'s
  masks (f32, 32 px tiles);
* a member's file copied by h5py under ``libver='latest'`` into chunked
  datasets (gzip, shuffle, fletcher32), once for each chunk index h5py
  picks, imports equal in both packages; with one chunk byte flipped both
  importers raise;
* with ``h5py`` blocked, the port's import, export, ``.h5`` ``Pipeline``
  and ``bdt-convert`` still run (the port reads and writes ``.h5`` with
  :mod:`utils.hdf5`) and give the JAX package's results on the same files,
  a ``libver='latest'`` chunked copy included;
* ``bdt-convert`` round trips with either package on the other side, and a
  wrong-model ``.npz`` exits with the JAX message.

Every comparison is exact: the files carry f32 arrays and nothing is
computed on them but layout moves.
"""
import dataclasses
import filecmp
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from building_detection_tpu.cli import convert as jax_convert
from building_detection_tpu.infer.pipeline import Pipeline as JaxPipeline
from building_detection_tpu.models import registry as jax_registry
from building_detection_tpu.train import checkpoint as jax_ckpt
from building_detection_tpu_torch.cli import convert as port_convert
from building_detection_tpu_torch.core.config import Config, TilerConfig
from building_detection_tpu_torch.core.module import Namer, init_layers, jax_variables
from building_detection_tpu_torch.infer.pipeline import Pipeline
from building_detection_tpu_torch.models import registry as port_registry
from building_detection_tpu_torch.nn import layers as L
from building_detection_tpu_torch.train import checkpoint as port_ckpt

torch.set_num_threads(2)

MEMBERS = ["res34", "hrnet", "v3plus", "scse", "bam"]


class Small(nn.Sequential):
    """The port's twin of ``tests/test_checkpoint.py::small_model``."""

    def __init__(self):
        n = Namer()
        super().__init__(
            L.Conv2d(n, 3, 4, 3), L.BatchNorm(n, 4), L.Conv2dTranspose(n, 4, 2, 2, strides=2),
            L.SeparableConv2d(n, 2, 3, 3),
        )


def small_variables(seed):
    return jax_variables(init_layers(Small(), torch.Generator().manual_seed(seed)))


def fake_like(params, state, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*np.shape(v)).astype(np.float32) for k, v in {**params, **state}.items()}


def keras_dw(arr):
    return np.ascontiguousarray(np.transpose(arr, (0, 1, 3, 2)))


def write_keras_h5(path, layers):
    """Keras weights-only layout: model_weights/<layer>/<weight path>."""
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = [name.encode() for name, _ in layers]
        for name, weights in layers:
            lg = g.create_group(name)
            lg.attrs["weight_names"] = [wn.encode() for wn, _ in weights]
            for wn, arr in weights:
                lg.create_dataset(wn, data=arr)


def small_layers(fake, rename):
    """The small model's weights in Keras' layout under renamed layers."""
    def layer(ours, leaves):
        name = rename(ours)
        return name, [(f"{name}/{leaf}:0", keras_dw(fake[f"{ours}/{leaf}"]) if leaf == "depthwise_kernel"
                       else fake[f"{ours}/{leaf}"]) for leaf in leaves]

    return [
        layer("conv2d", ("kernel", "bias")),
        layer("batch_normalization", ("gamma", "beta", "moving_mean", "moving_variance")),
        layer("conv2d_transpose", ("kernel", "bias")),
        layer("separable_conv2d", ("depthwise_kernel", "pointwise_kernel", "bias")),
    ]


def import_both(path, params, state, strict=True):
    """Both packages' imports of ``path``: equal arrays in equal key order,
    equal reports (or equal errors); returns the port's result."""
    outcomes = []
    for ckpt in (jax_ckpt, port_ckpt):
        try:
            outcomes.append(ckpt.import_h5_weights(path, dict(params), dict(state), strict=strict))
        except ValueError as e:
            outcomes.append(e)
    want, got = outcomes
    if isinstance(want, ValueError):
        assert isinstance(got, ValueError) and str(got) == str(want)
        raise got
    for w, g in zip(want[:2], got[:2]):
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == w[k].dtype
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    assert got[2].summary() == want[2].summary()
    return got


def assert_equal_to(got_params, got_state, fake):
    for k, v in {**got_params, **got_state}.items():
        np.testing.assert_array_equal(v, fake[k], err_msg=k)


# -- the traps of tests/test_checkpoint.py, on both importers --------------------------
def test_ordered_shape_matching_with_keras_names(tmp_path):
    params, state = small_variables(0)
    fake = fake_like(params, state, 0)
    path = str(tmp_path / "w.h5")
    write_keras_h5(path, small_layers(fake, lambda n: n))
    p, s, report = import_both(path, params, state)
    assert report.complete and report.matched_by_name == len(params) + len(state)
    assert_equal_to(p, s, fake)


@pytest.mark.parametrize("shift", ["offset", "colliding"])
def test_name_mismatch_falls_back_to_order(tmp_path, shift):
    """Offset counters (``conv2d_7``...) and names shifted by one, where the
    file's ``conv2d_1`` holds our ``conv2d``: the name pass is rejected
    whole and everything resolves by order."""
    params, state = small_variables(1)
    fake = fake_like(params, state, 1)
    offsets = {"offset": {"conv2d": 7, "batch_normalization": 3, "conv2d_transpose": 2, "separable_conv2d": 4},
               "colliding": dict.fromkeys(("conv2d", "batch_normalization", "conv2d_transpose",
                                           "separable_conv2d"), 1)}[shift]
    path = str(tmp_path / "w.h5")
    write_keras_h5(path, small_layers(fake, lambda n: f"{n}_{offsets[n]}"))
    p, s, report = import_both(path, params, state)
    assert report.complete and report.matched_by_name == 0 and report.matched_by_order == len(params) + len(state)
    assert report.name_pass_rejected and "name pass rejected" in report.summary()
    assert_equal_to(p, s, fake)


def test_strict_raises_on_partial_h5_and_nonstrict_reports(tmp_path):
    params, state = small_variables(2)
    path = str(tmp_path / "w.h5")
    write_keras_h5(path, [("conv2d", [("conv2d/kernel:0", np.full((3, 3, 3, 4), 0.5, np.float32))])])
    with pytest.raises(ValueError, match="UNMATCHED TARGET"):
        import_both(path, params, state, strict=True)
    p, _, report = import_both(path, params, state, strict=False)
    assert not report.complete and "conv2d/bias" in report.unmatched_ours
    assert report.matched_by_name == 0 and report.matched_by_order == 1
    np.testing.assert_array_equal(p["conv2d/kernel"], 0.5)
    np.testing.assert_array_equal(p["conv2d/bias"], params["conv2d/bias"])  # left at its value


def test_strict_raises_on_leftover_h5(tmp_path):
    params, state = small_variables(3)
    path = str(tmp_path / "w.h5")
    port_ckpt.export_h5_weights(path, params, state)
    with h5py.File(path, "a") as f:
        g = f.create_group("conv2d_99")
        g.create_dataset("conv2d_99/kernel:0", data=np.zeros((9, 9, 9, 9), np.float32))
        g.attrs["weight_names"] = [b"conv2d_99/kernel:0"]
        f.attrs["layer_names"] = [n if isinstance(n, bytes) else n.encode() for n in f.attrs["layer_names"]] + [
            b"conv2d_99"]
    with pytest.raises(ValueError, match="LEFTOVER H5"):
        import_both(path, params, state, strict=True)


def test_export_writes_keras_rank_and_depthwise_layout(tmp_path):
    """Sorted keys (as an ``.npz`` round trip leaves them) still export in
    Keras' per-layer order, depthwise kernels in Keras' axes; the JAX export
    writes the same file."""
    params, state = small_variables(4)
    sorted_p, sorted_s = dict(sorted(params.items())), dict(sorted(state.items()))
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    port_ckpt.export_h5_weights(ours, sorted_p, sorted_s)
    jax_ckpt.export_h5_weights(theirs, sorted_p, sorted_s)
    assert_same_h5(ours, theirs)
    with h5py.File(ours, "r") as f:
        assert names(f["separable_conv2d"].attrs["weight_names"]) == [
            "separable_conv2d/depthwise_kernel:0", "separable_conv2d/pointwise_kernel:0", "separable_conv2d/bias:0"]
        assert names(f["batch_normalization"].attrs["weight_names"])[-2:] == [
            "batch_normalization/moving_mean:0", "batch_normalization/moving_variance:0"]
        np.testing.assert_array_equal(f["separable_conv2d"]["separable_conv2d/depthwise_kernel:0"][()],
                                      keras_dw(params["separable_conv2d/depthwise_kernel"]))
        assert names(f.attrs["keras_version"]) == ["2.21.0"]
    with pytest.raises(ValueError, match="layer_order does not match"):
        port_ckpt.export_h5_weights(ours, params, state, layer_order=["conv2d"])


def names(values):
    return [v.decode() if isinstance(v, bytes) else str(v) for v in np.atleast_1d(values)]


def assert_same_h5(a, b):
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert {k: names(v) for k, v in fa.attrs.items()} == {k: names(v) for k, v in fb.attrs.items()}
        for lname in names(fa.attrs["layer_names"]):
            ga, gb = fa[lname], fb[lname]
            assert names(ga.attrs["weight_names"]) == names(gb.attrs["weight_names"])
            for wn in names(ga.attrs["weight_names"]):
                da, db = ga[wn][()], gb[wn][()]
                assert da.dtype == db.dtype
                np.testing.assert_array_equal(da, db)


# -- the five members ----------------------------------------------------------------
def test_keras_layer_order_is_the_jax_packages():
    assert filecmp.cmp(
        port_registry.__file__.replace("registry.py", "keras_layer_order.json"),
        jax_registry.__file__.replace("registry.py", "keras_layer_order.json"),
        shallow=False,
    )
    for name in MEMBERS:
        assert port_registry.keras_layer_order(name) == jax_registry.keras_layer_order(name)
    with pytest.raises(ValueError, match="no canonical Keras layer order"):
        port_registry.keras_layer_order("unet")


@pytest.mark.parametrize("name", MEMBERS)
def test_member_h5_round_trips_across_packages(tmp_path, name):
    """Each package's export (in Keras' positional layer order, and in
    construction order) imports in both packages with equal arrays and
    equal reports, onto another member's worth of weights."""
    src_p, src_s = jax_variables(port_registry.init_model(name, torch.Generator().manual_seed(7)))
    tgt_p = {k: v + 0.5 for k, v in src_p.items()}
    tgt_s = {k: v + 0.25 for k, v in src_s.items()}
    order = port_registry.keras_layer_order(name)
    files = {}
    for label, ckpt, layer_order in (("port", port_ckpt, order), ("jax", jax_ckpt, order),
                                      ("port_construction", port_ckpt, None)):
        files[label] = str(tmp_path / f"{label}.h5")
        ckpt.export_h5_weights(files[label], src_p, src_s, layer_order=layer_order)
    assert_same_h5(files["port"], files["jax"])
    for path in files.values():
        p, s, report = import_both(path, tgt_p, tgt_s)
        assert report.complete and report.matched_by_name == len(src_p) + len(src_s)
        assert_equal_to(p, s, {**src_p, **src_s})


def test_renamed_xception_resolves_by_order(tmp_path):
    """No name matches: the 16 shape-identical middle-flow blocks still land
    on their own targets, in both packages."""
    src_p, src_s = jax_variables(port_registry.init_model("v3plus", torch.Generator().manual_seed(3)))
    path = str(tmp_path / "src.h5")
    port_ckpt.export_h5_weights(path, src_p, src_s)
    renamed = {}
    for layer, suffix, _, arr in port_ckpt._read_h5_entries(path):
        arr = keras_dw(arr) if suffix == "depthwise_kernel" else arr
        renamed.setdefault(f"x_{layer}", []).append((f"x_{layer}/{suffix}:0", arr))
    write_keras_h5(path, list(renamed.items()))
    p, s, report = import_both(path, {k: v + 1 for k, v in src_p.items()}, src_s)
    assert report.complete and report.matched_by_order == len(src_p) + len(src_s)
    assert_equal_to(p, s, {**src_p, **src_s})


def halves(shape):
    return tuple(max(1, (n + 1) // 2) for n in shape)


# h5py's create_dataset options that make it pick each v4 chunk index under libver='latest'
LATEST_INDEXES = {
    "single_chunk": lambda shape: dict(chunks=shape),
    "fixed_array": lambda shape: dict(chunks=halves(shape)),  # odd axes: partial edge chunks
    "extensible_array": lambda shape: dict(chunks=halves(shape), maxshape=(None,) + shape[1:]),
    "v2_btree": lambda shape: dict(chunks=halves(shape), maxshape=(None,) * len(shape)),  # 1-d: extensible
}
FILTERS = dict(compression="gzip", shuffle=True, fletcher32=True)


def copy_latest(src, dst, index):
    """``src`` copied by h5py under ``libver='latest'``: groups and
    attributes as they were, every dataset chunked by ``index``'s options
    and filtered (``"implicit"``: chunks allocated at creation, no filter,
    which h5py indexes implicitly)."""
    with h5py.File(src, "r") as s, h5py.File(dst, "w", libver="latest") as d:
        def copy(sg, dg):
            for k, v in sg.attrs.items():
                dg.attrs[k] = v
            for k in sg:
                if isinstance(sg[k], h5py.Group):
                    copy(sg[k], dg.create_group(k))
                    continue
                arr = sg[k][()]
                if index != "implicit":
                    dg.create_dataset(k, data=arr, **LATEST_INDEXES[index](arr.shape), **FILTERS)
                    continue
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_chunk(halves(arr.shape))
                dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
                h5py.h5d.create(dg.id, k.encode(), h5py.h5t.py_create(arr.dtype), h5py.h5s.create_simple(arr.shape),
                                dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, arr)

        copy(s, d)
    return dst


def flip_chunk_byte(path):
    """Flip a byte in the middle of the first chunk of the file's largest
    dataset; its name."""
    sizes = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: sizes.append((obj.size, name)) if isinstance(obj, h5py.Dataset) else None)
        name = max(sizes)[1]
        info = f[name].id.get_chunk_info(0)
    with open(path, "r+b") as fh:
        fh.seek(info.byte_offset + info.size // 2)
        b = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([b[0] ^ 0x5A]))
    return name


@pytest.mark.parametrize("index", sorted(LATEST_INDEXES) + ["implicit"])
def test_member_h5_in_latest_chunked_form_imports_equal(tmp_path, index):
    """hrnet's Keras ``.h5`` from the JAX export, copied by h5py under
    ``libver='latest'`` into chunked datasets: both packages import it
    alike, bit for bit.  One chunk byte flipped: both importers raise
    (h5py's ``OSError``, the port's ``ValueError``), where the chunks carry
    a Fletcher-32; the unfiltered implicit index has none, and both read
    the same flipped value."""
    src_p, src_s = jax_variables(port_registry.init_model("hrnet", torch.Generator().manual_seed(11)))
    jax_h5, latest = str(tmp_path / "jax.h5"), str(tmp_path / "latest.h5")
    jax_ckpt.export_h5_weights(jax_h5, src_p, src_s, layer_order=jax_registry.keras_layer_order("hrnet"))
    copy_latest(jax_h5, latest, index)
    with open(latest, "rb") as fh:
        assert fh.read(9)[8] == 3  # superblock v3
    tgt_p, tgt_s = {k: v + 0.5 for k, v in src_p.items()}, {k: v + 0.25 for k, v in src_s.items()}
    p, s, report = import_both(latest, tgt_p, tgt_s)
    assert report.complete and report.matched_by_name == len(src_p) + len(src_s)
    assert_equal_to(p, s, {**src_p, **src_s})
    flip_chunk_byte(latest)
    if index == "implicit":
        p, s, _ = import_both(latest, tgt_p, tgt_s)
        assert any(not np.array_equal(v, {**src_p, **src_s}[k]) for k, v in {**p, **s}.items())
        return
    with pytest.raises(OSError):
        jax_ckpt.import_h5_weights(latest, dict(tgt_p), dict(tgt_s))
    with pytest.raises(ValueError, match="Fletcher-32"):
        port_ckpt.import_h5_weights(latest, dict(tgt_p), dict(tgt_s))


TILE_CFG = Config(tiler=TilerConfig(tile=32, stride=24, overlap=8))


def test_pipeline_from_h5_matches_jax_pipeline(tmp_path, capsys):
    path = str(tmp_path / "scse.h5")
    jax_ckpt.export_h5_weights(path, *jax_variables(port_registry.init_model("scse", torch.Generator().manual_seed(5))),
                               layer_order=jax_registry.keras_layer_order("scse"))
    img = np.random.RandomState(6).randint(0, 256, (40, 50, 3), np.uint8)
    port = Pipeline({"scse": path}, cfg=TILE_CFG, batch_tiles=4, models=("scse",), compute_dtype=torch.float32,
                    device="cpu")
    printed = capsys.readouterr().out
    want = JaxPipeline({"scse": path}, cfg=TILE_CFG, batch_tiles=4, models=("scse",), compute_dtype=jnp.float32)
    assert printed.strip() == capsys.readouterr().out.strip()  # the same report line
    assert "matched by name" in printed
    # one member: its mask (the fusion takes five)
    np.testing.assert_array_equal(port.ensemble.predict_masks(img)["scse"], want.ensemble.predict_masks(img)["scse"])


def test_port_h5_paths_run_with_h5py_blocked(tmp_path, monkeypatch, capsys):
    """With ``h5py`` blocked, the port's import, export, ``Pipeline`` from
    an ``.h5`` and ``bdt-convert`` run (the port reads and writes the files
    itself) and give what the JAX package gave on the same files before the
    block, the JAX export's file and its ``libver='latest'`` chunked copy
    (a fixed array index, gzip, shuffle, fletcher32) alike."""
    src_p, src_s = jax_variables(port_registry.init_model("scse", torch.Generator().manual_seed(5)))
    tgt_p, tgt_s = {k: v + 0.5 for k, v in src_p.items()}, {k: v + 0.25 for k, v in src_s.items()}
    order = jax_registry.keras_layer_order("scse")
    jax_h5, npz, latest = str(tmp_path / "jax.h5"), str(tmp_path / "src.npz"), str(tmp_path / "latest.h5")
    jax_ckpt.export_h5_weights(jax_h5, src_p, src_s, layer_order=order)
    copy_latest(jax_h5, latest, "fixed_array")
    port_ckpt.save_variables(npz, src_p, src_s)
    img = np.random.RandomState(6).randint(0, 256, (40, 50, 3), np.uint8)
    want_import = jax_ckpt.import_h5_weights(jax_h5, dict(tgt_p), dict(tgt_s))
    want_latest = jax_ckpt.import_h5_weights(latest, dict(tgt_p), dict(tgt_s))
    want_mask = JaxPipeline({"scse": jax_h5}, cfg=TILE_CFG, batch_tiles=4, models=("scse",),
                            compute_dtype=jnp.float32).ensemble.predict_masks(img)["scse"]
    cli_h5, want_npz = str(tmp_path / "cli_jax.h5"), str(tmp_path / "want.npz")
    assert jax_convert.main(["scse", npz, cli_h5, "--image-size", "32"]) == 0
    assert jax_convert.main(["scse", cli_h5, want_npz, "--image-size", "32"]) == 0
    capsys.readouterr()

    monkeypatch.setitem(sys.modules, "h5py", None)
    got_import = port_ckpt.import_h5_weights(jax_h5, dict(tgt_p), dict(tgt_s))
    got_latest = port_ckpt.import_h5_weights(latest, dict(tgt_p), dict(tgt_s))
    port_h5 = str(tmp_path / "port.h5")
    port_ckpt.export_h5_weights(port_h5, src_p, src_s, layer_order=order)
    round_trip = port_ckpt.import_h5_weights(port_h5, dict(tgt_p), dict(tgt_s))
    mask = Pipeline({"scse": jax_h5}, cfg=TILE_CFG, batch_tiles=4, models=("scse",), compute_dtype=torch.float32,
                    device="cpu").ensemble.predict_masks(img)["scse"]
    port_cli_h5, back_npz, jax_file_npz = (str(tmp_path / n) for n in ("cli_port.h5", "back.npz", "jax_file.npz"))
    assert port_convert.main(["scse", npz, port_cli_h5, "--image-size", "32"]) == 0
    assert port_convert.main(["scse", port_cli_h5, back_npz, "--image-size", "32"]) == 0
    assert port_convert.main(["scse", cli_h5, jax_file_npz, "--image-size", "32"]) == 0
    assert sys.modules["h5py"] is None
    monkeypatch.undo()

    for got, want in ((got_import, want_import), (round_trip, want_import), (got_latest, want_latest)):
        for w, g in zip(want[:2], got[:2]):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert g[k].dtype == w[k].dtype
        assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])
    np.testing.assert_array_equal(mask, want_mask)
    assert_same_h5(port_h5, jax_h5)
    assert_same_h5(port_cli_h5, cli_h5)
    want = npz_arrays(want_npz)
    for path in (back_npz, jax_file_npz):
        got = npz_arrays(path)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- bdt-convert ------------------------------------------------------------------------
def npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith(("params||", "state||"))}


@pytest.mark.parametrize("exporter,importer", [(port_convert, jax_convert), (jax_convert, port_convert),
                                               (port_convert, port_convert)],
                         ids=["port_to_jax", "jax_to_port", "port_to_port"])
def test_convert_round_trips(tmp_path, exporter, importer):
    """npz -> .h5 by one CLI, .h5 -> npz by the other: the weights come
    back bit for bit, and both CLIs write the same .h5."""
    npz = str(tmp_path / "src.npz")
    port_ckpt.save_variables(npz, *jax_variables(port_registry.init_model("scse", torch.Generator().manual_seed(8))))
    h5 = str(tmp_path / "scse.h5")
    assert exporter.main(["scse", npz, h5, "--image-size", "32"]) == 0
    other = str(tmp_path / "other.h5")
    assert importer.main(["scse", npz, other, "--image-size", "32"]) == 0
    assert_same_h5(h5, other)
    back = str(tmp_path / "back.npz")
    assert importer.main(["scse", h5, back, "--image-size", "32"]) == 0
    want, got = npz_arrays(npz), npz_arrays(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port_ckpt.load_variables(back)[4] == {"model": "scse"}


def test_convert_refuses_a_wrong_model_and_two_of_a_kind(tmp_path):
    npz = str(tmp_path / "scse.npz")
    port_ckpt.save_variables(npz, *jax_variables(port_registry.init_model("scse", torch.Generator().manual_seed(9))))
    errors = []
    for cli in (jax_convert, port_convert):
        with pytest.raises(SystemExit) as e:
            cli.main(["hrnet", npz, str(tmp_path / "x.h5"), "--image-size", "32"])
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "does not match model 'hrnet'" in errors[1]
    for cli in (jax_convert, port_convert):
        with pytest.raises(SystemExit, match="exactly one of src/dst must be .h5"):
            cli.main(["scse", npz, str(tmp_path / "y.npz")])
