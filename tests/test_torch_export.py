"""The port's export-based training against the JAX package's.

`export_datasets` re-batches across the incoming DataSets' boundaries (7-row
batches into 5-row files, the last partial file kept, `max_batches` cutting
early) and writes the JAX package's files; `ExportedDataSetIterator` reads
either package's directory back to the same DataSets; masked DataSets and an
empty directory raise; `fit` on the exported iterator is bitwise `fit` on
the same batches.
"""
import os

import numpy as np
import pytest

import deeplearning4j_torch as port
import deeplearning4j_torch.data.export as port_exp
import deeplearning4j_tpu.data.export as ref_exp
import deeplearning4j_tpu.data as ref_data
from deeplearning4j_torch.utils import params as port_params


def _ds(pkg, n=33, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return pkg.DataSet(x, y)


@pytest.mark.parametrize("max_batches", [None, 3])
def test_export_writes_the_reference_files(tmp_path, max_batches):
    p, r = str(tmp_path / "p"), str(tmp_path / "r")
    got = port_exp.export_datasets(port.ListDataSetIterator(_ds(port), 7), p, 5,
                                   max_batches)
    want = ref_exp.export_datasets(ref_data.ListDataSetIterator(_ds(ref_data), 7),
                                   r, 5, max_batches)
    assert [os.path.basename(f) for f in got] == [os.path.basename(f) for f in want]
    assert len(got) == (3 if max_batches else 7)
    for a, b in zip(got, want):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])
    for src in (p, r):
        back = list(port_exp.ExportedDataSetIterator(src))
        ref_back = list(ref_exp.ExportedDataSetIterator(src))
        assert [d.num_examples() for d in back] == \
            ([5] * 3 if max_batches else [5] * 6 + [3])
        for a, b in zip(back, ref_back):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)
    assert port_exp.ExportedDataSetIterator(p).batch_size() == 5


def test_masked_and_missing_raise(tmp_path):
    ds = _ds(port, 4)
    ds.features_mask = np.ones((4, 1), np.float32)
    with pytest.raises(NotImplementedError):
        port_exp.export_datasets([ds], str(tmp_path / "m"), 2)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        port_exp.ExportedDataSetIterator(str(tmp_path / "empty"))


def test_fit_on_exported_batches_is_fit_on_the_batches(tmp_path):
    def conf():
        return (port.NeuralNetConfiguration.builder().seed(2)
                .updater(port.Adam(learning_rate=1e-2)).list()
                .layer(port.DenseLayer(n_out=5, activation="tanh"))
                .layer(port.OutputLayer(n_out=3, activation="softmax"))
                .set_input_type(port.InputType.feed_forward(4)).build())
    data = _ds(port, 20)
    port_exp.export_datasets(port.ListDataSetIterator(data, 3), str(tmp_path), 8)
    a = port.MultiLayerNetwork(conf()).init(device="cpu")
    b = port.MultiLayerNetwork(conf()).init(device="cpu")
    a.fit(port_exp.ExportedDataSetIterator(str(tmp_path)), pad_to_bucket=False)
    b.fit(port.ListDataSetIterator(data, 8), pad_to_bucket=False)
    assert a.iteration == b.iteration == 3
    for u, v in zip(port_params.tree_leaves(a.params_tree),
                    port_params.tree_leaves(b.params_tree)):
        assert (u == v).all()
