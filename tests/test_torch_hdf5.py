"""The port's HDF5 reader and writer (``utils/hdf5.py``), held against h5py.

* The reader gives what h5py gives (member order, attributes, dtypes with
  their byte order, shapes, arrays, strings) on files h5py writes here under
  its default format (``libver='earliest'``: superblock v0, v1 through an
  explicit chunk-index K, and v0 after a user block), ``'v108'`` and
  ``'latest'`` (superblocks v2 and v3): the Keras weights
  layout, groups of 0, 1, 8, 9 and 600 members (multi-level B-trees; dense
  links in a fractal heap), fixed-length (null-padded, null-terminated,
  space-padded) and variable-length strings, scalars, the empty float64
  ``(0,)`` and the null dataspace, every integer and float dtype in both
  byte orders at 0-d and N-d, compact, contiguous, unwritten and chunked
  datasets with gzip, shuffle and fletcher32, dense attributes (up to
  nested indirect blocks of the fractal heap), and under ``'latest'`` each
  of the five v4 chunk indexes (single chunk, implicit, fixed array,
  extensible array, v2 B-tree; paged arrays, unwritten chunks and pages,
  partial edge chunks filtered or, by the layout's flag, not).
* It refuses what h5py refuses, with ``ValueError``: a byte flipped in each
  checksummed structure (a Fletcher-32 chunk; the v2/v3 superblock and its
  extension, ``OHDR``, ``OCHK``, the v2 B-tree's nodes, the fractal heap's
  blocks, the fixed and extensible arrays' blocks and pages), a file cut
  short, a corrupt deflate stream; it reads the byte-swapped Fletcher-32
  form h5py reads.  Its lookup3 gives Bob Jenkins' published values and its
  vectorised Fletcher-32 the library's loop.
* What it does not read raises ``ValueError`` naming the feature (a huge
  fractal-heap object, a soft link, a variable-length string dataset).
* The writer's files read in h5py as the same tree, lookups by name
  included (which need sorted symbol-table nodes and B-tree keys), survive
  h5py appending to them, and refuse an attribute past a header message's
  64 KB as h5py does.
* A bounded hypothesis fuzz over Keras-like trees, both directions.
"""
import ctypes
import ctypes.util
import glob
import os
import tempfile

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from building_detection_tpu_torch.train.checkpoint import _decode
from building_detection_tpu_torch.utils import hdf5

DTYPES = [bo + code for code in ("f2", "f4", "f8", "i1", "u1", "i2", "u2", "i4", "u4", "i8", "u8") for bo in "<>"]
LIBVERS = ["earliest", "v108", "latest"]


def open_h5py(path, libver):
    """An h5py file for writing.  ``earliest_v1`` asks the library for
    superblock v1 (a non-default chunk-index K, which h5py does not expose),
    ``earliest_userblock`` puts a 1 KB user block before the superblock."""
    if libver == "earliest_userblock":
        return h5py.File(path, "w", userblock_size=1024)
    if libver != "earliest_v1":
        return h5py.File(path, "w", libver=libver)
    found = glob.glob(os.path.join(os.path.dirname(h5py.__file__), os.pardir, "h5py.libs", "libhdf5-*"))
    lib = ctypes.CDLL(found[0] if found else ctypes.util.find_library("hdf5"))
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    assert lib.H5Pset_istore_k(ctypes.c_int64(fcpl.id), ctypes.c_uint(64)) >= 0
    return h5py.File(h5py.h5f.create(os.fsencode(path), h5py.h5f.ACC_TRUNC, fcpl=fcpl))


def values(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return np.asarray(rng.randn(*shape) * 100).astype(dtype)
    lo = 0 if dtype.kind == "u" else -100
    return rng.randint(lo, 100, size=shape).astype(dtype)


def assert_same_value(want, got, where):
    if isinstance(want, h5py.Empty):
        assert isinstance(got, hdf5.Empty) and got.dtype == want.dtype, where
        return
    assert type(got) is type(want), (where, type(want), type(got))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.dtype.str == want.dtype.str, (where, want.dtype, got.dtype)
        assert got.shape == want.shape, (where, want.shape, got.shape)
        if want.dtype.kind == "O":
            assert want.ravel().tolist() == got.ravel().tolist(), where
        else:
            assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def assert_same_tree(want, got, where="/"):
    """``want`` an h5py group, ``got`` the port's: members in the same
    order, attributes, datasets' shapes, dtypes and values."""
    assert list(got.keys()) == list(want.keys()), where
    assert list(got.attrs.keys()) == list(want.attrs.keys()), where
    for k, v in want.attrs.items():
        assert k in got.attrs
        assert_same_value(v, got.attrs[k], f"{where}@{k}")
    for k in want:
        w, g = want[k], got[k]
        if isinstance(w, h5py.Group):
            assert isinstance(g, hdf5.Group), where + k
            assert_same_tree(w, g, f"{where}{k}/")
        else:
            assert isinstance(g, hdf5.Dataset), where + k
            assert (g.shape, g.dtype) == (w.shape, w.dtype), where + k
            assert_same_value(w[()], g[()], where + k)
            for a, v in w.attrs.items():
                assert_same_value(v, g.attrs[a], f"{where}{k}@{a}")


def check_reader(path):
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        assert_same_tree(want, got)


# -- files h5py writes ------------------------------------------------------------------
def write_keras(f):
    mw = f.create_group("model_weights")
    mw.attrs["layer_names"] = [b"conv2d_5", b"flatten", b"batch_normalization"]  # vlen, as both exports wrote it
    mw.attrs["backend"] = b"tensorflow"
    mw.attrs["keras_version"] = np.bytes_(b"2.21.0")
    conv = mw.create_group("conv2d_5")
    conv.attrs["weight_names"] = np.array([b"conv2d_5/kernel:0", b"conv2d_5/bias:0"])  # fixed, as Keras writes
    conv.create_dataset("conv2d_5/kernel:0", data=values("<f4", (3, 3, 2, 4), 0))
    conv.create_dataset("conv2d_5/bias:0", data=values("<f4", (4,), 1))
    mw.create_group("flatten").attrs["weight_names"] = np.asarray([])  # weightless: empty float64 (0,)
    bn = mw.create_group("batch_normalization")
    names = [f"batch_normalization/{w}:0" for w in ("gamma", "beta", "moving_mean", "moving_variance")]
    bn.attrs["weight_names"] = [n.encode() for n in names]
    for i, n in enumerate(names):
        bn.create_dataset(n, data=values("<f4", (4,), 2 + i))
    f.create_group("optimizer_weights")


def write_groups(f):
    for n in (0, 1, 8, 9, 600):
        g = f.create_group(f"g{n}")
        for i in reversed(range(n)):  # created out of name order
            g.create_group(f"m{i:03d}{'_x' * (i % 5)}")


def write_strings(f):
    s = f.create_group("strings")
    s.attrs["vlen"] = "héllo"
    s.attrs["vlen_ascii"] = b"tensorflow"
    s.attrs["vlen_list"] = ["a", "bb", "", "dddd"]
    s.attrs["fixed"] = np.bytes_(b"abc")
    s.attrs["fixed_list"] = np.array([b"x", b"yz", b""])
    s.attrs["fixed_2d"] = np.array([[b"ab", b"c"], [b"", b"def"]])
    s.attrs["empty"] = np.zeros((0,), "f8")
    s.attrs["null"] = h5py.Empty("f4")
    s.attrs["int"] = 7
    s.attrs["float"] = 2.5
    for pad, name in ((h5py.h5t.STR_NULLTERM, "nullterm"), (h5py.h5t.STR_SPACEPAD, "spacepad")):
        tid = h5py.h5t.C_S1.copy()
        tid.set_size(6)
        tid.set_strpad(pad)
        attr = h5py.h5a.create(s.id, name.encode(), tid, h5py.h5s.create_simple((3,)))
        attr.write(np.array([b"ab", b"abcdef", b"a c"], "S6"), mtype=tid)
    s.create_dataset("null_ds", data=h5py.Empty("i4"))
    s.create_dataset("fixed_ds", data=np.array([b"one", b"three"]))


def write_dtypes(f):
    d = f.create_group("dtypes")
    for i, dt in enumerate(DTYPES):
        a = values(dt, (2, 3, 4), i)
        d.create_dataset(dt, data=a)
        d.create_dataset(dt + "_0d", data=a.ravel()[0])
        d.attrs[dt] = a[0]
        d.attrs[dt + "_0d"] = a.ravel()[1]


def write_layouts(f, libver):
    g = f.create_group("layouts")
    g.create_dataset("contiguous", data=values("<f4", (5, 7), 0))
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    ds = h5py.h5d.create(g.id, b"compact", h5py.h5t.NATIVE_INT32, h5py.h5s.create_simple((10,)), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(10, dtype="i4"))
    g.create_dataset("unwritten", shape=(3, 4), dtype="f4")
    g.create_dataset("unwritten_fill", shape=(3, 4), dtype=">i2", fillvalue=-3)
    g.create_dataset("zero_size", data=np.zeros((0, 3), "f4"))
    g.create_dataset("gzip_shuffle", data=values("<f4", (37, 21), 1), chunks=(8, 5), compression="gzip",
                     shuffle=True)
    g.create_dataset("fletcher", data=values(">f8", (9, 9), 2), chunks=(4, 4), fletcher32=True)
    g.create_dataset("sparse", shape=(20, 20), chunks=(8, 8), dtype="i2", fillvalue=7)[0:3, 0:3] = 1
    g.create_dataset("gzip_3d", data=values("<u2", (5, 6, 7), 3), chunks=(2, 6, 3), compression="gzip")


def hdf5_library():
    """The HDF5 library h5py runs on, for what h5py does not expose."""
    found = glob.glob(os.path.join(os.path.dirname(h5py.__file__), os.pardir, "h5py.libs", "libhdf5-*"))
    lib = ctypes.CDLL(found[0] if found else ctypes.util.find_library("hdf5"))
    lib.H5Pset_chunk_opts.argtypes = [ctypes.c_int64, ctypes.c_uint]
    lib.H5Pset_chunk_opts.restype = ctypes.c_int
    lib.H5Dget_chunk_index_type.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    lib.H5Dget_chunk_index_type.restype = ctypes.c_int
    return lib


def low_level(g, name, data, chunks, maxshape=None, gzip=False, fletcher=False, whole_edges=False, early=False):
    """A chunked dataset through the library's own calls: ``whole_edges``
    stores partial edge chunks unfiltered (``H5Pset_chunk_opts``), ``early``
    allocates every chunk at creation (the implicit index, unfiltered)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    if gzip:
        dcpl.set_deflate(4)
    if fletcher:
        dcpl.set_fletcher32()
    if whole_edges:
        assert hdf5_library().H5Pset_chunk_opts(dcpl.id, 0x0002) >= 0  # H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS
    if early:
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    space = h5py.h5s.create_simple(data.shape, tuple(h5py.h5s.UNLIMITED if m is None else m
                                                     for m in maxshape or data.shape))
    ds = h5py.h5d.create(g.id, name.encode(), h5py.h5t.py_create(data.dtype), space, dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def write_chunk_indexes(f, libver):
    """Under ``'latest'`` every chunk index h5py picks (the name's prefix
    says which; ``test_latest_writes_every_chunk_index`` holds the library
    to it), under the older formats the same datasets in v1 B-trees."""
    g = f.create_group("chunk_indexes")
    a = values("<f4", (37, 21), 4)  # (8, 5) chunks: partial edge chunks on both axes
    g.create_dataset("single", data=a, chunks=a.shape)
    g.create_dataset("single_filtered", data=a, chunks=a.shape, compression="gzip", shuffle=True, fletcher32=True)
    low_level(g, "implicit", a, (8, 5), early=True)
    low_level(g, "implicit_larger_max", a, (8, 5), maxshape=(50, 30), early=True)
    g.create_dataset("fixed", data=a, chunks=(8, 5))
    g.create_dataset("fixed_filtered", data=a, chunks=(8, 5), compression="gzip", shuffle=True, fletcher32=True)
    g.create_dataset("fixed_larger_max", data=a, chunks=(8, 5), maxshape=(50, 30), compression="gzip")
    low_level(g, "fixed_whole_edges", a, (8, 5), gzip=True, fletcher=True, whole_edges=True)
    g.create_dataset("fixed_sparse", shape=(20, 20), chunks=(8, 8), dtype="i2", fillvalue=7)[0:3, 9:12] = 1
    g.create_dataset("fixed_empty", shape=(0, 4), chunks=(2, 2), maxshape=(6, 4), dtype="f4")
    g.create_dataset("earray_empty", shape=(0, 4), chunks=(2, 2), maxshape=(None, 4), dtype="f4")
    paged = g.create_dataset("fixed_paged", shape=(3000,), chunks=(1,), dtype="u1", fillvalue=9)  # 3 pages of 1024
    paged[0:10], paged[2500:2510] = np.arange(10), np.arange(10, 20)  # the middle page never written
    g.create_dataset("fixed_paged_filtered", data=np.arange(2100, dtype="<u2"), chunks=(2,), fletcher32=True)
    g.create_dataset("earray", data=a, chunks=(8, 5), maxshape=(None, 21))
    g.create_dataset("earray_second_axis", data=a, chunks=(8, 5), maxshape=(37, None), compression="gzip",
                     shuffle=True, fletcher32=True)
    g.create_dataset("earray_middle_axis", data=values("<i4", (5, 6, 7), 5), chunks=(2, 4, 3),
                     maxshape=(5, None, 7))
    low_level(g, "earray_whole_edges", a, (8, 5), maxshape=(None, 21), gzip=True, whole_edges=True)
    sparse = g.create_dataset("earray_sparse", shape=(1200,), chunks=(3,), maxshape=(None,), dtype=">i8",
                              fillvalue=-5)
    sparse[0:4], sparse[900:990] = np.arange(4), np.arange(90)  # a super block; data blocks never written
    # a data block of 2048 elements (super block 13, past the first 131060 chunks) in pages of 1024, one written
    far = g.create_dataset("earray_paged", shape=(140000,), chunks=(1,), maxshape=(None,), dtype="u1", fillvalue=3)
    far[0:6], far[131100] = np.arange(6), 77
    g.create_dataset("btree2", data=a, chunks=(8, 5), maxshape=(None, None))
    g.create_dataset("btree2_filtered", data=values("<u2", (5, 6, 7), 3), chunks=(2, 2, 3),
                     maxshape=(None, None, None), compression="gzip", fletcher32=True)
    g.create_dataset("btree2_deep", data=np.arange(3000, dtype="<i2").reshape(60, 50), chunks=(2, 2),
                     maxshape=(None, None))  # 750 records: internal nodes
    g.create_dataset("btree2_sparse", shape=(30, 30), chunks=(4, 4), maxshape=(None, None), dtype="f8",
                     fillvalue=2.5)[10:14, 3:5] = 1.0
    # Fletcher-32 on odd-length chunks and on sums that are multiples of 65535
    g.create_dataset("fletcher_odd", data=np.arange(23, dtype="u1"), chunks=(5,), fletcher32=True)
    g.create_dataset("fletcher_ones", data=np.full((16,), 0xFF, "u1"), chunks=(8,), fletcher32=True)
    g.create_dataset("fletcher_zeros", data=np.zeros(8, "u1"), chunks=(4,), fletcher32=True)


def write_dense_attrs(f):
    g = f.create_group("many_attrs")
    for i in range(20):  # past 8, 'latest' moves them to a fractal heap
        g.attrs[f"a{19 - i:02d}"] = np.arange(i, dtype="<i8")
    g.attrs["names"] = [b"conv2d", b"dense_1"]
    wide = f.create_group("wide_attrs")
    for i in range(250):  # 750 KB of attributes: a fractal heap past its direct rows (nested indirect blocks)
        wide.attrs[f"w{i:03d}"] = np.full(370, i, "<f8")
    ds = f.create_dataset("attributed", data=np.arange(3.0))
    for i in range(12):
        ds.attrs[f"x{i}"] = float(i)


WRITERS = {
    "keras": lambda f, libver: write_keras(f),
    "groups": lambda f, libver: write_groups(f),
    "strings": lambda f, libver: write_strings(f),
    "dtypes": lambda f, libver: write_dtypes(f),
    "layouts": write_layouts,
    "dense_attrs": lambda f, libver: write_dense_attrs(f),
    "chunk_indexes": write_chunk_indexes,
}


@pytest.mark.parametrize("feature", sorted(WRITERS))
@pytest.mark.parametrize("libver", ["earliest", "earliest_v1", "earliest_userblock"] + LIBVERS[1:])
def test_reader_equals_h5py(tmp_path, libver, feature):
    path = str(tmp_path / "f.h5")
    with open_h5py(path, libver) as f:
        WRITERS[feature](f, libver)
    with open(path, "rb") as fh:
        head = fh.read(1033)
    at = 1024 if libver == "earliest_userblock" else 0
    assert head[at:at + 8] == hdf5.SIGNATURE
    assert head[at + 8] == {"earliest_v1": 1, "v108": 2, "latest": 3}.get(libver, 0)  # the superblock's version
    check_reader(path)


CHUNK_INDEX_TYPES = {"single": 1, "implicit": 2, "fixed": 3, "fletcher": 3, "earray": 4, "btree2": 5}


def test_latest_writes_every_chunk_index(tmp_path, monkeypatch):
    """Under ``'latest'`` the library picks the index each dataset's name
    says (``H5D_chunk_index_t``), and reading the file goes through every
    structure of the five, pages included."""
    path = str(tmp_path / "f.h5")
    lib = hdf5_library()
    with h5py.File(path, "w", libver="latest") as f:
        write_chunk_indexes(f, "latest")
        for name, ds in f["chunk_indexes"].items():
            kind = ctypes.c_int(-1)
            assert lib.H5Dget_chunk_index_type(ds.id.id, ctypes.byref(kind)) >= 0
            assert kind.value == CHUNK_INDEX_TYPES[name.split("_")[0]], name
    seen = set()
    verify = hdf5._Store.verify
    monkeypatch.setattr(hdf5._Store, "verify", lambda self, addr, size, what, zeroed=None: (
        seen.add(what), verify(self, addr, size, what, zeroed))[1])
    check_reader(path)
    assert seen >= {"fixed array header (FAHD)", "fixed array data block (FADB)", "fixed array data block page",
                    "extensible array header (EAHD)", "extensible array index block (EAIB)",
                    "extensible array super block (EASB)", "extensible array data block (EADB)",
                    "extensible array data block page", "v2 B-tree header (BTHD)", "v2 B-tree node (BTIN)",
                    "v2 B-tree node (BTLF)", "object header (OHDR)", "superblock (version 3)"}, seen


def test_reader_paths_and_mapping(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        write_keras(f)
    with hdf5.File(path) as f:
        g = f["model_weights"]["conv2d_5"]
        assert "conv2d_5/kernel:0" in g and "/model_weights/conv2d_5/conv2d_5/bias:0" in g
        assert "conv2d_5/nothing:0" not in g and "missing/x" not in f and "model_weights/flatten/x" not in f
        with pytest.raises(KeyError):
            f["model_weights/nothing"]
        assert g.attrs.get("nope", "default") == "default" and "weight_names" in g.attrs
        assert [_decode(n) for n in f["model_weights"].attrs["layer_names"]] == [
            "conv2d_5", "flatten", "batch_normalization"]
        assert len(f["model_weights"]) == 3 and dict(g.attrs.items()).keys() == {"weight_names"}
        kernel = f["model_weights/conv2d_5/conv2d_5/kernel:0"][()]
    kernel += 1  # a copy: writable, and it outlives the file
    np.testing.assert_array_equal(kernel, values("<f4", (3, 3, 2, 4), 0) + 1)


def test_reader_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("chunked", data=np.arange(100.0).reshape(10, 10), chunks=(5, 5))
        g = f.create_group("huge")
        for i in range(9):  # dense attribute storage
            g.attrs[f"a{i}"] = i
        g.attrs["big"] = np.arange(5000.0)  # past the heap's largest managed object
        f["soft"] = h5py.SoftLink("/huge")
        f["vlen"] = ["a", "bc"]
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match="variable-length string datasets"):
            f["vlen"][()]
        np.testing.assert_array_equal(f["chunked"][()], np.arange(100.0).reshape(10, 10))  # read since v4 indexes
        with pytest.raises(ValueError, match="huge fractal-heap objects"):
            f["huge"].attrs
        with pytest.raises(ValueError, match="soft and external links"):
            f["soft"]
    empty = tmp_path / "empty.h5"
    empty.write_bytes(b"")
    for bad in (empty, tmp_path / "note.txt"):
        bad.write_bytes(bad.read_bytes() if bad == empty else b"not an HDF5 file at all" * 40)
        with pytest.raises(ValueError, match="not an HDF5 file"):
            hdf5.File(str(bad))


# -- what h5py refuses ------------------------------------------------------------------
def fletcher32_loop(data: bytes) -> int:
    """The library's ``H5_checksum_fletcher32``, loop for loop."""
    sum1 = sum2 = 0
    n, i = len(data) // 2, 0
    while n:
        t = min(n, 360)
        n -= t
        for _ in range(t):
            sum1 += (data[i] << 8) | data[i + 1]
            i += 2
            sum2 += sum1
        sum1, sum2 = (sum1 & 0xFFFF) + (sum1 >> 16), (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[i] << 8
        sum2 += sum1
        sum1, sum2 = (sum1 & 0xFFFF) + (sum1 >> 16), (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1, sum2 = (sum1 & 0xFFFF) + (sum1 >> 16), (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


@pytest.mark.parametrize("n", [0, 1, 2, 3, 719, 720, 721, 4097])
def test_checksums_are_the_librarys(n, monkeypatch):
    """Fletcher-32 equals the library's loop on random bytes, on all-0xff
    bytes (sums at multiples of 65535: 0xffff, not 0) and on zeros, odd
    lengths included, across numpy blocks too; lookup3 gives Bob Jenkins'
    published values."""
    rng = np.random.RandomState(n)
    cases = [rng.randint(0, 256, n).astype(np.uint8).tobytes(), b"\xff" * n, bytes(n),
             rng.randint(250, 256, n).astype(np.uint8).tobytes()]
    want = [fletcher32_loop(data) for data in cases]
    assert [hdf5.fletcher32(data) for data in cases] == want
    monkeypatch.setattr(hdf5, "_FLETCHER_BLOCK", 7)  # many numpy blocks
    assert [hdf5.fletcher32(data) for data in cases] == want
    assert fletcher32_loop(b"\xff" * 4) == 0xFFFFFFFF and fletcher32_loop(bytes(4)) == 0
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551


def h5py_contents(path):
    """``(object path, is a dataset, attribute names)`` of every object."""
    out = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.append((name, isinstance(obj, h5py.Dataset), list(obj.attrs))))
        out.append(("/", False, list(f.attrs)))
    return out


def read_everything_h5py(path, contents):
    """Every object, dataset and attribute, looked up by name: the library
    (1.14.6) crashes iterating over a v2 B-tree whose internal node fails
    its checksum, where a lookup raises."""
    with h5py.File(path, "r") as f:
        for name, is_dataset, attrs in contents:
            obj = f[name]
            if is_dataset:
                obj[()]
            for a in attrs:
                obj.attrs[a]


def read_everything_port(path):
    def walk(g):
        dict(g.attrs)
        for k in g:
            if isinstance(g[k], hdf5.Group):
                walk(g[k])
            else:
                g[k][()]
                dict(g[k].attrs)

    with hdf5.File(path) as f:
        walk(f)


def first_message(data, addr):
    """The position of the first message's type in the ``OHDR`` at ``addr``."""
    flags = data[addr + 5]
    return addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0) + (1 << (flags & 3))


def superblock_address(which):
    return lambda data, path: int.from_bytes(data[12 + 8 * which:20 + 8 * which], "little")


def chunk_byte(name):
    def at(data, path):
        with h5py.File(path, "r") as f:
            info = f[name].id.get_chunk_info(0)
        return info.byte_offset + info.size // 2
    return at


def signature(sig, plus, last=False):
    return lambda data, path: (data.rindex(sig) if last else data.index(sig)) + plus


def write_fletcher(f):
    f.create_dataset("d", data=values(">f8", (9, 9), 2), chunks=(4, 4), fletcher32=True)


def write_continued(f):
    ds = f.create_dataset("d", data=np.arange(10.0))
    for i in range(7):  # compact (at most 8), added after the header was sized: a continuation chunk
        ds.attrs[f"x{i}"] = np.full(30, i, "<f8")


def write_dataset(*args, **kwargs):
    return lambda f: f.create_dataset("d", *args, **kwargs)


def write_fixed_paged(f):
    f.create_dataset("d", shape=(3000,), chunks=(1,), dtype="u1")[:] = np.arange(3000) % 251


def write_earray_paged(f):
    f.create_dataset("d", shape=(140000,), chunks=(1,), maxshape=(None,), dtype="u1")[131100] = 7


def write_earray_super(f):
    f.create_dataset("d", shape=(1200,), chunks=(3,), maxshape=(None,), dtype="<i4")[900:990] = np.arange(90)


ROOT = superblock_address(3)  # v2/v3: base, extension, end of file, root
# case: (libver, what h5py writes, where a byte flips, what the port's error says)
CORRUPT = {
    "fletcher32_chunk_earliest": ("earliest", write_fletcher, chunk_byte("d"), "Fletcher-32"),
    "fletcher32_chunk_latest": ("latest", write_fletcher, chunk_byte("d"), "Fletcher-32"),
    "deflate_chunk": ("latest", write_dataset(data=values("<f4", (40, 40), 1), chunks=(20, 20), compression="gzip"),
                      chunk_byte("d"), "deflate"),
    "superblock_v2": ("v108", write_keras, lambda data, path: 43, r"superblock \(version 2\).*checksum"),
    "superblock_v3": ("latest", write_keras, lambda data, path: 43, r"superblock \(version 3\).*checksum"),
    "superblock_extension": ("latest_paged_space", write_keras,
                             lambda data, path: first_message(data, superblock_address(1)(data, path)),
                             r"OHDR.*checksum"),
    "OHDR": ("latest", write_keras, lambda data, path: first_message(data, ROOT(data, path)), r"OHDR.*checksum"),
    "OCHK": ("latest", write_continued, signature(b"OCHK", 4), r"OCHK.*checksum"),
    "BTHD": ("latest", write_groups, signature(b"BTHD", 6), r"BTHD.*checksum"),
    "BTIN": ("latest", write_groups, signature(b"BTIN", 6), r"BTIN.*checksum"),
    "BTLF": ("latest", write_groups, signature(b"BTLF", 6), r"BTLF.*checksum"),
    "FRHP": ("latest", write_dense_attrs, signature(b"FRHP", 6), r"FRHP.*checksum"),
    "FHIB": ("latest", write_dense_attrs, signature(b"FHIB", 6), r"FHIB.*checksum"),
    "FHDB": ("latest", write_dense_attrs, signature(b"FHDB", 40), r"FHDB.*checksum"),
    "FAHD": ("latest", write_dataset(data=values("<f4", (40, 40), 1), chunks=(8, 8)), signature(b"FAHD", 6),
             r"FAHD.*checksum"),
    "FADB": ("latest", write_dataset(data=values("<f4", (40, 40), 1), chunks=(8, 8)), signature(b"FADB", 20),
             r"FADB.*checksum"),
    "FADB_page": ("latest", write_fixed_paged, signature(b"FADB", 19 + 8), "fixed array data block page.*checksum"),
    "EAHD": ("latest", write_earray_super, signature(b"EAHD", 6), r"EAHD.*checksum"),
    "EAIB": ("latest", write_earray_super, signature(b"EAIB", 14), r"EAIB.*checksum"),
    "EASB": ("latest", write_earray_super, signature(b"EASB", 6), r"EASB.*checksum"),
    "EADB": ("latest", write_earray_super, signature(b"EADB", 6), r"EADB.*checksum"),
    "EADB_page": ("latest", write_earray_paged, signature(b"EADB", 22 + 40 * 8, last=True),
                  "extensible array data block page.*checksum"),
    "btree2_chunk_index": ("latest", write_dataset(data=values("<f4", (40, 40), 1), chunks=(8, 8),
                                                   maxshape=(None, None)), signature(b"BTLF", 6), r"BTLF.*checksum"),
}


def h5py_file(path, libver):
    if libver == "latest_paged_space":  # a superblock extension: the paged file-space strategy, kept
        return h5py.File(path, "w", libver="latest", fs_strategy="page", fs_persist=True)
    return open_h5py(path, libver)


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_structure_refused_by_both(tmp_path, case):
    """One byte flipped inside a checksummed structure (or a chunk): h5py
    raises, and the port raises ``ValueError`` naming it; intact, both read
    the file alike."""
    libver, write, locate, said = CORRUPT[case]
    path = str(tmp_path / "f.h5")
    with h5py_file(path, libver) as f:
        write(f)
    check_reader(path)
    contents = h5py_contents(path)
    data = bytearray(open(path, "rb").read())
    data[locate(bytes(data), path)] ^= 0x5A
    open(path, "wb").write(bytes(data))
    with pytest.raises((OSError, KeyError)):
        read_everything_h5py(path, contents)
    with pytest.raises(ValueError, match=said):
        read_everything_port(path)


@pytest.mark.parametrize("cut", [1, 100])
@pytest.mark.parametrize("writer", ["earliest", "earliest_userblock", "latest", "port"])
def test_truncated_file_refused_by_both(tmp_path, writer, cut):
    """A file shorter than the end of file its superblock records: the
    library refuses it at open, and so does the port, whatever is read."""
    path = str(tmp_path / "f.h5")
    if writer == "port":
        with hdf5.Writer(path) as f:
            fill_writer(f)
    else:
        with open_h5py(path, writer) as f:
            write_keras(f)
    check_reader(path)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-cut])
    with pytest.raises(OSError, match="truncated file"):
        h5py.File(path, "r")
    with pytest.raises(ValueError, match="truncated HDF5 file"):
        hdf5.File(path)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_byte_swapped_fletcher32_is_read(tmp_path, libver):
    """The library also takes a chunk's Fletcher-32 with each 16-bit half
    byte-swapped (files of HDF5 1.6.2 and before): so does the port."""
    path = str(tmp_path / "f.h5")
    with open_h5py(path, libver) as f:
        f.create_dataset("d", data=values("<i2", (30, 7), 3), chunks=(4, 7), fletcher32=True)
        infos = [f["d"].id.get_chunk_info(i) for i in range(f["d"].id.get_num_chunks())]
    data = bytearray(open(path, "rb").read())
    for info in infos:
        end = info.byte_offset + info.size
        assert int.from_bytes(data[end - 4:end], "little") == fletcher32_loop(bytes(data[info.byte_offset:end - 4]))
        data[end - 4:end] = bytes([data[end - 3], data[end - 4], data[end - 1], data[end - 2]])
    open(path, "wb").write(bytes(data))
    check_reader(path)


# -- the writer -------------------------------------------------------------------------
def fill_writer(f):
    """Every kind of value the writer takes, the Keras layout included."""
    f.attrs["layer_names"] = [b"conv2d", b"dense", b"zz_last", b"a_first"]
    f.attrs["backend"] = b"tensorflow"
    f.attrs["keras_version"] = "2.21.0"
    f.attrs["int"] = np.int32(-3)
    f.attrs["floats"] = np.arange(5, dtype=">f8")
    f.attrs["empty"] = np.asarray([])
    g = f.create_group("conv2d")
    g.attrs["weight_names"] = [b"conv2d/kernel:0", b"conv2d/bias:0"]
    g.create_dataset("conv2d/kernel:0", data=values("<f4", (3, 3, 3, 4), 0))
    g.create_dataset("conv2d/bias:0", data=values("<f4", (4,), 1))
    for i, dt in enumerate(DTYPES):
        f.create_dataset(f"dtypes/{dt}", data=values(dt, (2, 3), i))
        f.create_dataset(f"dtypes/{dt}_0d", data=values(dt, (), i))
    f.create_dataset("dtypes/strided", data=values("<i4", (4, 6), 0)[:, ::2])
    f.create_dataset("dtypes/zero_size", data=np.zeros((0, 3), "f4"))
    for name in ("zz_last", "a_first", "dense"):
        f.create_group(name).attrs["weight_names"] = np.asarray([])
    big = f.create_group("big")
    for i in reversed(range(600)):  # 75 full symbol-table nodes: a two-level B-tree
        big.create_group(f"layer_{i * 7919 % 600:03d}")


def test_writer_files_read_in_h5py(tmp_path):
    path = str(tmp_path / "w.h5")
    with hdf5.Writer(path) as f:
        fill_writer(f)
    with h5py.File(path, "r") as h:
        assert [h.attrs[k].tolist() if isinstance(h.attrs[k], np.ndarray) else h.attrs[k] for k in (
            "layer_names", "backend", "keras_version", "int")] == [
            [b"conv2d", b"dense", b"zz_last", b"a_first"], b"tensorflow", b"2.21.0", -3]
        assert h.attrs["layer_names"].dtype == np.dtype("S7")  # fixed-length, null-padded
        assert h.attrs["floats"].dtype.str == ">f8" and h.attrs["empty"].dtype == np.float64
        np.testing.assert_array_equal(h["conv2d/conv2d/kernel:0"][()], values("<f4", (3, 3, 3, 4), 0))
        for i, dt in enumerate(DTYPES):
            assert h[f"dtypes/{dt}"].dtype.str == np.dtype(dt).str
            assert h[f"dtypes/{dt}"][()].tobytes() == values(dt, (2, 3), i).tobytes()
            assert h[f"dtypes/{dt}_0d"].shape == () and h[f"dtypes/{dt}_0d"][()] == values(dt, (), i)
        np.testing.assert_array_equal(h["dtypes/strided"][()], values("<i4", (4, 6), 0)[:, ::2])
        assert h["dtypes/zero_size"].shape == (0, 3)
        assert list(h["big"]) == sorted(h["big"]) and len(h["big"]) == 600
    check_reader(path)


def test_writer_names_found_by_h5py_lookup(tmp_path):
    """h5py finds each member by a binary search over the B-tree keys and
    the names in each symbol-table node: both must be sorted bytewise."""
    path = str(tmp_path / "w.h5")
    names = [f"{p}{i}" for i in range(90) for p in ("b", "A", "a_", "Z")]  # 360, not in byte order
    with hdf5.Writer(path) as f:
        for i, n in enumerate(names):
            f.create_dataset(n, data=np.full((2,), i, "<i4"))
        f.create_group("g").attrs["x"] = 1
    with h5py.File(path, "r") as h:
        for i, n in enumerate(names):
            assert n in h, n
            assert h[n][()].tolist() == [i, i], n
        for n in ("a", "b90", "A90", "zz", "a_", "0"):
            assert n not in h, n
        assert h["g"].attrs["x"] == 1


def test_h5py_appends_to_a_written_file(tmp_path):
    """h5py adds members and rewrites attributes in place: what the writer
    wrote is a file the library edits (heaps grow, nodes split)."""
    path = str(tmp_path / "w.h5")
    with hdf5.Writer(path) as f:
        fill_writer(f)
    with h5py.File(path, "a") as h:
        g = h.create_group("conv2d_99")
        g.create_dataset("conv2d_99/kernel:0", data=np.ones((2, 2), np.float32))
        g.attrs["weight_names"] = [b"conv2d_99/kernel:0"]
        h.attrs["layer_names"] = list(h.attrs["layer_names"]) + [b"conv2d_99"]
        for i in range(40):
            h["big"].create_group(f"layer_{i:03d}_added")
        h["conv2d"].attrs["note"] = np.arange(3000.0)
    check_reader(path)
    with hdf5.File(path) as f:
        assert [_decode(n) for n in f.attrs["layer_names"]][-1] == "conv2d_99" and len(f["big"]) == 640


def test_writer_refuses_a_header_message_past_64_kb(tmp_path):
    """As h5py: an attribute that does not fit one object header message
    raises; one that fits is written."""
    for n, fits in ((8000, True), (8200, False), (100_000, False)):
        with h5py.File(str(tmp_path / "h.h5"), "w") as h:
            if fits:
                h.attrs["a"] = np.zeros(n, "f8")
            else:
                with pytest.raises(OSError, match="too large"):
                    h.attrs["a"] = np.zeros(n, "f8")
        w = hdf5.Writer(str(tmp_path / "w.h5"))
        if fits:
            w.attrs["a"] = np.zeros(n, "f8")
        else:
            with pytest.raises(ValueError, match="header message"):
                w.attrs["a"] = np.zeros(n, "f8")
    w = hdf5.Writer(str(tmp_path / "w.h5"))
    with pytest.raises(TypeError, match="cannot write"):
        w.create_dataset("x", data=np.zeros(3, np.complex64))
    w.create_dataset("a/b", data=np.zeros(1))
    with pytest.raises(ValueError, match="already exists"):
        w.create_group("a/b")
    with pytest.raises(ValueError, match="is a dataset"):
        w.create_dataset("a/b/c", data=np.zeros(1))


# -- fuzz --------------------------------------------------------------------------------
NAME = st.text(alphabet="abcdefghijklmnopqrstuvwxyz_0123456789:", min_size=1, max_size=14)
WEIGHT = st.tuples(NAME, st.sampled_from(DTYPES), st.lists(st.integers(0, 4), max_size=4).map(tuple))
LAYER = st.tuples(NAME, st.lists(WEIGHT, max_size=4, unique_by=lambda w: w[0]))
TREE = st.lists(LAYER, max_size=14, unique_by=lambda layer: layer[0])
FUZZ = settings(max_examples=25, deadline=None, database=None, suppress_health_check=[HealthCheck.too_slow])


def keras_tree(f, layers, fixed):
    """A Keras weights file of ``layers`` into an h5py file or the writer."""
    strings = (lambda names: np.array(names, "S")) if fixed else list
    f.attrs["layer_names"] = strings([name.encode() for name, _ in layers]) if layers else np.asarray([])
    f.attrs["backend"] = np.bytes_(b"tensorflow") if fixed else b"tensorflow"
    for i, (lname, weights) in enumerate(layers):
        g = f.create_group(lname)
        wnames = [f"{lname}/{w}:0".encode() for w, _, _ in weights]
        g.attrs["weight_names"] = strings(wnames) if wnames else np.asarray([])
        for j, (w, dt, shape) in enumerate(weights):
            g.create_dataset(f"{lname}/{w}:0", data=values(dt, shape, 100 * i + j))


@FUZZ
@given(layers=TREE, libver=st.sampled_from(LIBVERS), fixed=st.booleans())
def test_fuzz_reader_on_h5py_files(layers, libver, fixed):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "f.h5")
        with h5py.File(path, "w", libver=libver) as f:
            keras_tree(f, layers, fixed)
        check_reader(path)


@FUZZ
@given(layers=TREE)
def test_fuzz_writer_read_by_h5py(layers):
    with tempfile.TemporaryDirectory() as d:
        ours, theirs = os.path.join(d, "ours.h5"), os.path.join(d, "theirs.h5")
        with hdf5.Writer(ours) as f:
            keras_tree(f, layers, fixed=True)
        with h5py.File(theirs, "w") as f:
            keras_tree(f, layers, fixed=True)
        with h5py.File(ours, "r") as got, h5py.File(theirs, "r") as want:
            assert_h5py_trees_equal(want, got)
        check_reader(ours)


def assert_h5py_trees_equal(want, got, where="/"):
    assert list(got) == list(want) and list(got.attrs) == list(want.attrs), where
    for k, v in want.attrs.items():
        g = got.attrs[k]
        assert type(g) is type(v) and g.dtype == v.dtype and np.shape(g) == np.shape(v), (where, k)
        assert g.tobytes() == v.tobytes(), (where, k)
    for k in want:
        if isinstance(want[k], h5py.Group):
            assert_h5py_trees_equal(want[k], got[k], f"{where}{k}/")
        else:
            assert got[k].dtype.str == want[k].dtype.str and got[k].shape == want[k].shape, where + k
            assert got[k][()].tobytes() == want[k][()].tobytes(), where + k
