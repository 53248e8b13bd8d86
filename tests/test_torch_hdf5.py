"""The port's HDF5 reader (`deeplearning4j_torch/keras_import/hdf5.py`)
against h5py, which the JAX package reads Keras files with: every attribute
and dataset of the nine Keras fixtures, and files written here with h5py
that reach each part of the reader's corner (continuation blocks, both byte
orders, integer and float types, empty, unallocated and scalar datasets,
fixed- and variable-length strings, a bare `save_weights` layout), read
bitwise as h5py reads them; and the features outside the corner refused by
name. The port's `Hdf5Archive` is held to the JAX package's on every
fixture."""
import glob
import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from deeplearning4j_torch.keras_import import hdf5  # noqa: E402
from deeplearning4j_torch.keras_import.reader import (  # noqa: E402
    Hdf5Archive, UnsupportedKerasConfigurationException)
from deeplearning4j_tpu.keras_import.reader import (  # noqa: E402
    Hdf5Archive as JaxHdf5Archive)

from test_torch_word2vec import one_torch_thread  # noqa: E402,F401

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "keras")
FIXTURES = sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(FIX, "*.h5")))


def assert_same_value(got, want, where):
    """Bitwise: the same type, dtype, shape and bytes (object arrays: the
    same Python objects element by element)."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        if want.dtype == object:
            assert all(type(a) is type(b) and a == b
                       for a, b in zip(got.ravel(), want.ravel())), where
        else:
            assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def assert_same_tree(mine, ref):
    """Every member, attribute and dataset of h5py's object `ref` read alike
    through the port's reader."""
    assert list(mine.keys()) == list(ref.keys()), ref.name
    assert sorted(mine.attrs.keys()) == sorted(ref.attrs.keys()), ref.name
    for name in ref.attrs:
        assert name in mine.attrs
        assert_same_value(mine.attrs[name], ref.attrs[name], f"{ref.name}@{name}")
    for key in ref.keys():
        m, r = mine[key], ref[key]
        assert m.name == r.name
        if isinstance(r, h5py.Group):
            assert hasattr(m, "keys")
            assert_same_tree(m, r)
            continue
        assert not hasattr(m, "keys")
        assert (m.shape, m.dtype) == (r.shape, r.dtype), r.name
        assert_same_value(m[()], r[()], r.name)
        assert_same_value(np.asarray(m), np.asarray(r), r.name)
        for name in r.attrs:
            assert_same_value(m.attrs[name], r.attrs[name], f"{r.name}@{name}")


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_reads_as_h5py_reads_it(name):
    path = os.path.join(FIX, f"{name}.h5")
    with h5py.File(path, "r") as ref, hdf5.File(path) as mine:
        assert_same_tree(mine, ref)


def test_nine_fixtures():
    assert len(FIXTURES) == 9 and "mnist_cnn" in FIXTURES


@pytest.mark.parametrize("name", FIXTURES)
def test_archive_matches_the_jax_package(name):
    path = os.path.join(FIX, f"{name}.h5")
    with Hdf5Archive(path) as mine, JaxHdf5Archive(path) as ref:
        assert mine.model_config() == ref.model_config()
        assert mine.training_config() == ref.training_config()
        assert mine.keras_version() == ref.keras_version()
        names = ref.layer_names()
        assert mine.layer_names() == names
        for layer in names + ["not_a_layer"]:
            got, want = mine.layer_weights(layer), ref.layer_weights(layer)
            assert list(got) == list(want)
            for k in want:
                assert_same_value(got[k], want[k], f"{layer}/{k}")


def write_corner_file(path):
    """One file that reaches every part of the reader's corner."""
    vlen = h5py.string_dtype()
    with h5py.File(path, "w", libver="earliest") as f:
        g = f.create_group("many_attributes")   # overflows the first header block
        for i in range(200):
            g.attrs[f"a{i:03d}"] = np.arange(i % 7 + 1, dtype=np.float32) * i
        g.attrs["long"] = "x" * 3000
        f.create_dataset("big_endian", data=np.arange(12, dtype=">f4").reshape(3, 4))
        f.create_dataset("big_endian_int", data=np.arange(-2, 3, dtype=">i8"))
        f.create_dataset("int64", data=np.arange(-3, 9, dtype=np.int64))
        f.create_dataset("uint8", data=np.arange(7, dtype=np.uint8))
        f.create_dataset("float64", data=np.linspace(0, 1, 9))
        f.create_dataset("float16", data=np.linspace(0, 1, 9).astype(np.float16))
        f.create_dataset("empty", shape=(0,), dtype="f4")
        f.create_dataset("unallocated", shape=(3, 2), dtype="f4")
        f.create_dataset("filled", shape=(4,), dtype="i4", fillvalue=7)
        f.create_dataset("scalar", data=np.float32(3.5))
        f.create_dataset("compact", data=np.arange(4, dtype=np.int32),
                         dcpl=_compact_dcpl())
        f.create_dataset("vlen_strings", data=np.array(["ab", "cde"], dtype=vlen))
        f.create_dataset("fixed_strings", data=np.array([b"ab", b"cde"]))
        f.attrs["vlen_scalar"] = "héllo"
        f.attrs.create("vlen_json", '{"a": [1, 2]}', dtype=vlen)
        f.attrs["fixed_scalar"] = np.bytes_(b"fixed str")
        f.attrs["fixed_array"] = np.array([b"conv2d/kernel:0", b"b"])
        f.attrs["vlen_array"] = np.array(["a", "bb"], dtype=vlen)
        f.attrs["int_scalar"] = np.int64(5)
        f.attrs["empty_array"] = np.array([], dtype=np.float64)
        f.attrs["matrix"] = np.ones((2, 3), np.int32)
        nested = f.create_group("a").create_group("b")
        nested.create_dataset("c", data=np.ones(2, np.float32))
        for i in range(40):   # a B-tree of several symbol-table nodes
            f.create_group(f"sub{i:02d}").create_dataset("x", data=np.full(3, i, np.float32))


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def test_every_part_of_the_corner_reads_as_h5py_reads_it(tmp_path):
    path = str(tmp_path / "corner.h5")
    write_corner_file(path)
    with h5py.File(path, "r") as ref, hdf5.File(path) as mine:
        assert_same_tree(mine, ref)
        assert mine["compact"].shape == (4,)
        assert mine["many_attributes"].attrs["long"] == "x" * 3000
        # paths, membership and names
        assert "a/b/c" in mine and "/a/b" in mine and "a/x" not in mine
        assert mine["a"]["b/c"].name == "/a/b/c"
        assert mine["/a/b"]["/a/b/c"].name == "/a/b/c"
        with pytest.raises(KeyError):
            mine["a/missing"]


def test_bare_save_weights_layout(tmp_path):
    """Keras's `save_weights` puts the layer groups at the root, with
    fixed-length byte-string names; the archive finds them there."""
    path = str(tmp_path / "bare.h5")
    with h5py.File(path, "w", libver="earliest") as f:
        f.attrs["layer_names"] = np.array([b"dense", b"out"])
        for n, shape in (("dense", (4, 3)), ("out", (3, 2))):
            g = f.create_group(n)
            g.attrs["weight_names"] = np.array([f"{n}/kernel:0".encode(),
                                                f"{n}/bias:0".encode()])
            g.create_dataset(f"{n}/kernel:0",
                             data=np.arange(np.prod(shape), dtype=np.float32).reshape(shape))
            g.create_dataset(f"{n}/bias:0", data=np.full(shape[1], 0.5, np.float32))
    with h5py.File(path, "r") as ref, hdf5.File(path) as mine:
        assert_same_tree(mine, ref)
    with Hdf5Archive(path) as mine, JaxHdf5Archive(path) as ref:
        assert mine.layer_names() == ref.layer_names() == ["dense", "out"]
        for layer in ("dense", "out"):
            got, want = mine.layer_weights(layer), ref.layer_weights(layer)
            assert sorted(got) == sorted(want) == ["bias", "kernel"]
            for k in want:
                assert_same_value(got[k], want[k], k)


def _chunked(f):
    f.create_dataset("x", data=np.ones((64, 64), np.float32), chunks=(8, 8))


def _gzip(f):
    f.create_dataset("x", data=np.ones((64, 64), np.float32), compression="gzip")


def _external_link(f):
    f.create_dataset("x", data=np.ones(4, np.float32))
    f["link"] = h5py.ExternalLink("other.h5", "/x")


def _soft_link(f):
    f.create_dataset("x", data=np.ones(4, np.float32))
    f["link"] = h5py.SoftLink("/x")


@pytest.mark.parametrize("write, libver, named", [
    (_chunked, "earliest", "chunked layout"),
    (_gzip, "earliest", r"filter pipeline .*deflate \(gzip\)"),
    (_chunked, "latest", "superblock version 3"),
    (_external_link, "earliest", "link messages"),
    (_soft_link, "earliest", "soft link 'link'"),
], ids=["chunked", "gzip", "libver_latest", "external_link", "soft_link"])
def test_outside_the_corner_is_refused_by_name(tmp_path, write, libver, named):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver) as f:
        write(f)
    with pytest.raises(UnsupportedKerasConfigurationException, match=named):
        with hdf5.File(path) as f:
            f["x"][()]
            f["link"]


def test_not_an_hdf5_file(tmp_path):
    path = tmp_path / "plain.txt"
    path.write_bytes(b"not hdf5 at all" * 100)
    with pytest.raises(OSError, match="not an HDF5 file"):
        hdf5.File(str(path))
    with pytest.raises(ValueError, match="read-only"):
        hdf5.File(os.path.join(FIX, "mlp.h5"), "r+")
