"""Padding and sequence packing: the port's data/padding.py and
PackToBucketIterator against the JAX package's, and the packed batch's loss.

- `pad_lmask_zero_weight` (no mask, rank-1 and rank-2 masks),
  `pad_dataset_rows`, `pad_multidataset_rows`, `first_fit_pack` and
  `pack_sequences`: the JAX package's arrays exactly.
- PackToBucketIterator over ragged batches (its bucket and rows from the
  first batch, and fixed ones, splitting a batch that needs more rows):
  the JAX package's packed arrays and positions exactly, and the packing
  metrics (`packed_requests_total`, `packing_efficiency`).
- A two-layer causal attention net with `packed_segments=True` (width 16,
  4 heads): the packed batch's score equals the unpacked batch's (rtol
  1e-5: the same tokens' losses summed in another order), on both packages,
  and the port's packed score equals the JAX package's (rtol 1e-5), and
  `fit` through PackToBucketIterator matches the JAX package's parameters
  after 4 steps (rtol 1e-5, atol 1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeplearning4j_torch as port
from deeplearning4j_torch.data import iterators as it
from deeplearning4j_torch.data import padding
from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.optimize import metrics as port_metrics
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data import iterators as ref_it
from deeplearning4j_tpu.data import padding as ref_padding
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as RefMultiDataSet

WIDTH, HEADS, VOCAB = 16, 4, 11


@pytest.mark.parametrize("mask", [None, "rank1", "rank2"])
def test_zero_weight_masks_match_reference(mask):
    rng = np.random.default_rng(1)
    m = {None: None, "rank1": rng.random(5).astype(np.float32),
         "rank2": rng.random((5, 7)).astype(np.float32)}[mask]
    np.testing.assert_array_equal(padding.pad_lmask_zero_weight(m, 5, 3),
                                  ref_padding.pad_lmask_zero_weight(m, 5, 3))
    x = rng.standard_normal((5, 7, 2)).astype(np.float32)
    got = padding.pad_dataset_rows(DataSet(x, x[..., :1], None, m), 8)
    want = ref_padding.pad_dataset_rows(RefDataSet(x, x[..., :1], None, m), 8)
    for a, b in ((got.features, want.features), (got.labels, want.labels),
                 (got.labels_mask, want.labels_mask)):
        np.testing.assert_array_equal(a, b)
    assert got.features_mask is None and want.features_mask is None
    assert padding.pad_dataset_rows(got, 4) is got   # already at target
    mg = padding.pad_multidataset_rows(MultiDataSet([x], [x, x], None, [m, None]), 6)
    mw = ref_padding.pad_multidataset_rows(
        RefMultiDataSet([x], [x, x], None, [m, None]), 6)
    for a, b in zip(mg.labels_masks + mg.labels + mg.features,
                    mw.labels_masks + mw.labels + mw.features):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bucket", [8, 16, 40])
def test_first_fit_and_pack_sequences_match_reference(bucket):
    rng = np.random.default_rng(bucket)
    lengths = rng.integers(1, 9, 12)
    assert padding.first_fit_pack(lengths, bucket) == \
        ref_padding.first_fit_pack(lengths, bucket)
    f = rng.standard_normal((12, 8, 3)).astype(np.float32)
    l = rng.standard_normal((12, 8, 2)).astype(np.float32)
    lm = rng.random((12, 8)).astype(np.float32)
    got = padding.pack_sequences(f, l, lengths, bucket, rows=12, labels_mask=lm)
    want = ref_padding.pack_sequences(f, l, lengths, bucket, rows=12, labels_mask=lm)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exceeds bucket_len"):
        padding.first_fit_pack([bucket + 1], bucket)


def _ragged(n, t, seed, lo=2):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, t + 1, n)
    idx = rng.integers(0, VOCAB, (n, t))
    eye = np.eye(VOCAB, dtype=np.float32)
    x, y = eye[idx], eye[np.roll(idx, -1, 1)]
    fm = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return x * fm[..., None], y * fm[..., None], fm, fm.copy()


@pytest.mark.parametrize("fixed", [False, True])
def test_pack_to_bucket_matches_reference_and_counts(fixed):
    batches = [_ragged(6, 12, seed=s) for s in (1, 2, 3)]
    kw = dict(bucket_len=16, rows=2) if fixed else {}
    port_iter = it.PackToBucketIterator(
        it.ExistingDataSetIterator([DataSet(*b) for b in batches]), **kw)
    ref_iter = ref_it.PackToBucketIterator(
        ref_it.ExistingDataSetIterator([RefDataSet(*b) for b in batches]), **kw)
    eff = port_metrics.registry().gauge("packing_efficiency").labels(source="fit")
    items = port_metrics.registry().counter("packed_requests_total").labels(
        source="fit")
    items0 = items.value()
    got, want = list(port_iter), list(ref_iter)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        for a, b in ((g.features, w.features), (g.labels, w.labels),
                     (g.features_mask, w.features_mask),
                     (g.labels_mask, w.labels_mask),
                     (g.packed_positions, w.packed_positions)):
            np.testing.assert_array_equal(a, b)
        assert g.features.shape == got[0].features.shape
    assert items.value() == items0 + 18
    assert 0 < eff.value() <= 1
    assert port_iter.batch_size() == ref_iter.batch_size()


def _attn_conf(pkg):
    attn = lambda: pkg.SelfAttentionLayer(
        n_out=WIDTH, n_heads=HEADS, causal=True, activation="relu",
        attention_impl="dense", packed_segments=True)
    return (pkg.NeuralNetConfiguration.builder().seed(0)
            .updater(pkg.Sgd(0.1)).list()
            .layer(attn()).layer(attn())
            .layer(pkg.RnnOutputLayer(n_out=VOCAB, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(VOCAB))
            .build())


def _ref_attn(port_net):
    net = ref.MultiLayerNetwork(_attn_conf(ref)).init()
    net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    return net


def test_packed_loss_equals_unpacked_and_reference():
    port_net = port.MultiLayerNetwork(_attn_conf(port)).init(device="cpu")
    ref_net = _ref_attn(port_net)
    x, y, fm, lm = _ragged(6, 12, seed=4)
    packed = next(iter(it.PackToBucketIterator(
        it.ExistingDataSetIterator([DataSet(x, y, fm, lm)]), bucket_len=24)))
    assert packed.features.shape[0] < 6   # several sequences share a row
    unpacked_score = port_net.score(DataSet(x, y, fm, lm))
    packed_score = port_net.score(packed)
    np.testing.assert_allclose(packed_score, unpacked_score, rtol=1e-5)
    ref_packed = ref_net.score(RefDataSet(packed.features, packed.labels,
                                          packed.features_mask, packed.labels_mask))
    np.testing.assert_allclose(packed_score, ref_packed, rtol=1e-5)
    np.testing.assert_allclose(ref_packed, ref_net.score(RefDataSet(x, y, fm, lm)),
                               rtol=1e-5)


def test_fit_through_pack_to_bucket_matches_reference():
    port_net = port.MultiLayerNetwork(_attn_conf(port)).init(device="cpu")
    ref_net = _ref_attn(port_net)
    batches = [_ragged(4, 12, seed=s) for s in (5, 6, 7, 8)]
    port_net.fit(it.PackToBucketIterator(it.ExistingDataSetIterator(
        [DataSet(*b) for b in batches]), bucket_len=24, rows=2))
    ref_net.fit(ref_it.PackToBucketIterator(ref_it.ExistingDataSetIterator(
        [RefDataSet(*b) for b in batches]), bucket_len=24, rows=2), use_async=False)
    assert port_net.iteration == ref_net.iteration >= 4
    got = jax.tree_util.tree_leaves(port_params.params_to_numpy(port_net.params_tree))
    for g, w in zip(got, jax.tree_util.tree_leaves(ref_net.params_tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)
