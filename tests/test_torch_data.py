"""The torch port's DataSet container and iterators against the JAX
package's: the same numpy data gives the same batches, in the same order,
with the same masks (exact: these only slice and permute numpy arrays)."""
import numpy as np
import pytest

from deeplearning4j_torch.data import dataset as port_ds
from deeplearning4j_torch.data import iterators as port_it
from deeplearning4j_tpu.data import dataset as ref_ds
from deeplearning4j_tpu.data import iterators as ref_it


def _arrays(n=11, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, 2)).astype(np.float32),
            (rng.random(n) < 0.5).astype(np.float32),
            (rng.random((n, 2)) < 0.5).astype(np.float32))


def _pair(masks=True):
    f, l, fm, lm = _arrays()
    if not masks:
        fm = lm = None
    return port_ds.DataSet(f, l, fm, lm), ref_ds.DataSet(f, l, fm, lm)


def _assert_same(got, want):
    for name in ("features", "labels", "features_mask", "labels_mask"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.mark.parametrize("masks", [True, False])
def test_dataset_methods_match_reference(masks):
    p, r = _pair(masks)
    assert p.num_examples() == r.num_examples() == 11
    for g, w in zip(p.split_test_and_train(8), r.split_test_and_train(8)):
        _assert_same(g, w)
    _assert_same(p.shuffle(seed=3), r.shuffle(seed=3))
    _assert_same_batches(p.batch_by(4), r.batch_by(4))
    _assert_same(port_ds.DataSet.merge(p.batch_by(4)),
                 ref_ds.DataSet.merge(r.batch_by(4)))


@pytest.mark.parametrize("kw", [
    {"batch_size": 4}, {"batch_size": 4, "drop_last": True},
    {"batch_size": 3, "shuffle": True, "seed": 5}, {"batch_size": 20},
], ids=["ragged", "drop_last", "shuffled", "one_batch"])
def test_list_iterator_matches_reference(kw):
    p, r = _pair()
    pi = port_it.ListDataSetIterator(p, **kw)
    ri = ref_it.ListDataSetIterator(r, **kw)
    for _ in range(2):  # a second epoch re-iterates (and reshuffles)
        _assert_same_batches(pi, ri)
    assert pi.batch_size() == ri.batch_size()
    assert pi.total_examples() == ri.total_examples() == 11


def test_existing_iterator_pre_processor_and_as_iterator():
    p, r = _pair()
    pe = port_it.ExistingDataSetIterator(p.batch_by(5))
    re_ = ref_it.ExistingDataSetIterator(r.batch_by(5))
    scale = lambda ds: type(ds)(ds.features * 2, ds.labels, ds.features_mask,
                                ds.labels_mask)
    pe.pre_processor, re_.pre_processor = scale, scale
    _assert_same_batches(pe, re_)
    assert pe.batch_size() == re_.batch_size() == 5
    f, l, _, _ = _arrays()
    _assert_same_batches(port_it.as_iterator(f, l, 4), ref_it.as_iterator(f, l, 4))
    _assert_same_batches(port_it.as_iterator(p, batch_size=6),
                         ref_it.as_iterator(r, batch_size=6))
    assert port_it.as_iterator(pe) is pe
    with pytest.raises(ValueError, match="labels"):
        port_it.as_iterator(f)
