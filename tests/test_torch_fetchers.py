"""The port's dataset fetchers against the JAX package's.

The synthesizers write byte-identical files (MNIST IDX, CIFAR binary
batches, the LFW directory of PPMs) for the same arguments and seeds; each
package's reader reads the other's files to the same arrays (and gzip'd IDX
files); the Mnist, Iris, Cifar, LFW and Curves iterators give bitwise the
same DataSets; a bad magic number raises.
"""
import filecmp
import gzip
import os
import shutil

import numpy as np
import pytest

import deeplearning4j_torch.data.fetchers as port_f
import deeplearning4j_tpu.data.fetchers as ref_f


def _same_tree(a, b):
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n
    return names


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.features.dtype == w.features.dtype
        np.testing.assert_array_equal(g.features, w.features)
        np.testing.assert_array_equal(g.labels, w.labels)


def test_mnist_files_and_iterators_match(tmp_path):
    p, r = str(tmp_path / "port"), str(tmp_path / "ref")
    port_f.synthesize_mnist_idx(p, n_train=96, n_test=32, seed=5)
    ref_f.synthesize_mnist_idx(r, n_train=96, n_test=32, seed=5)
    assert len(_same_tree(p, r)) == 4
    for train in (True, False):
        _same_batches(port_f.MnistDataSetIterator(20, train=train, path=r),
                      ref_f.MnistDataSetIterator(20, train=train, path=p))
    _same_batches(port_f.MnistDataSetIterator(32, num_examples=50, flatten=False,
                                              shuffle=True, seed=3, path=p),
                  ref_f.MnistDataSetIterator(32, num_examples=50, flatten=False,
                                             shuffle=True, seed=3, path=p))
    # the default synthesis (1024 + 256) through the fetcher
    d = str(tmp_path / "auto")
    got = port_f.MnistDataFetcher(path=d, synthesize=True).as_dataset(64)
    want = ref_f.MnistDataFetcher(path=d).as_dataset(64)
    np.testing.assert_array_equal(got.features, want.features)
    assert got.features.shape == (64, 784) and got.labels.shape == (64, 10)
    with pytest.raises(FileNotFoundError):
        port_f.MnistDataFetcher(path=str(tmp_path / "none"))


def test_idx_round_trip_gzip_and_bad_magic(tmp_path):
    imgs = np.random.default_rng(1).integers(0, 256, (7, 5, 6), dtype=np.uint8)
    labels = np.arange(20, dtype=np.uint8)
    port_f.write_idx_images(str(tmp_path / "i"), imgs)
    ref_f.write_idx_labels(str(tmp_path / "l"), labels)
    np.testing.assert_array_equal(ref_f.read_idx_images(str(tmp_path / "i")), imgs)
    np.testing.assert_array_equal(port_f.read_idx_labels(str(tmp_path / "l")), labels)
    with open(tmp_path / "i", "rb") as f, gzip.open(tmp_path / "g.gz", "wb") as g:
        shutil.copyfileobj(f, g)
    np.testing.assert_array_equal(port_f.read_idx_images(str(tmp_path / "g")), imgs)
    with pytest.raises(ValueError, match="magic"):
        port_f.read_idx_images(str(tmp_path / "l"))


def test_iris_matches():
    got, want = port_f.iris_dataset(), ref_f.iris_dataset()
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    _same_batches(port_f.IrisDataSetIterator(40, num_examples=100),
                  ref_f.IrisDataSetIterator(40, num_examples=100))


def test_cifar_files_and_iterators_match(tmp_path):
    p, r = str(tmp_path / "port"), str(tmp_path / "ref")
    port_f.synthesize_cifar_bin(p, n_train=23, n_test=6, seed=2)
    ref_f.synthesize_cifar_bin(r, n_train=23, n_test=6, seed=2)
    assert len(_same_tree(p, r)) == 6
    for train in (True, False):
        _same_batches(port_f.CifarDataSetIterator(8, train=train, path=r),
                      ref_f.CifarDataSetIterator(8, train=train, path=p))
    imgs, labels = port_f.read_cifar_bin(os.path.join(p, "test_batch.bin"))
    ref_f.write_cifar_bin(str(tmp_path / "x.bin"), imgs, labels)
    got = port_f.read_cifar_bin(str(tmp_path / "x.bin"))
    np.testing.assert_array_equal(got[0], imgs)
    np.testing.assert_array_equal(got[1], labels)
    (tmp_path / "bad.bin").write_bytes(b"\0" * 10)
    with pytest.raises(ValueError, match="CIFAR record"):
        port_f.read_cifar_bin(str(tmp_path / "bad.bin"))


def test_lfw_directory_and_iterator_match(tmp_path):
    p, r = str(tmp_path / "port"), str(tmp_path / "ref")
    port_f.synthesize_lfw_dir(p, num_people=3, per_person=3, size=20, seed=4)
    ref_f.synthesize_lfw_dir(r, num_people=3, per_person=3, size=20, seed=4)
    assert len(_same_tree(p, r)) == 9
    got = port_f.LFWDataSetIterator(4, image_shape=(12, 12, 3), path=p, num_examples=7)
    want = ref_f.LFWDataSetIterator(4, image_shape=(12, 12, 3), path=r, num_examples=7)
    assert got.labels == want.labels and got.total_examples() == 7
    _same_batches(got, want)


def test_curves_match():
    got, want = port_f.curves_dataset(40, seed=9), ref_f.curves_dataset(40, seed=9)
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.features, got.labels)
    _same_batches(port_f.CurvesDataSetIterator(16, num_examples=40),
                  ref_f.CurvesDataSetIterator(16, num_examples=40))
