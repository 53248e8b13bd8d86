"""The port's transfer learning against the JAX package's.

- TransferLearning.builder: a feature extractor (frozen layers), fine-tune
  overrides, `n_out_replace` (that layer and the next re-initialized),
  `remove_output_layer` + `add_layer`: the same configuration JSON, the
  retained parameters copied (not aliased) from the source network, and
  after 4 `fit` steps from the same parameters the JAX package's
  parameters (rtol 1e-5, atol 1e-7) with the frozen layers bitwise where
  they were.
- TransferLearningHelper: `featurize` gives the frozen front's activations,
  `fit_featurized` trains only the tail and writes it back; the JAX
  package's tail after the same steps (rtol 1e-5, atol 1e-6: each package
  trains on its own featurized activations, which differ by float32
  rounding).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.nn import transfer_learning as tl
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.nn import transfer_learning as rtl


def _conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(10)
            .updater(pkg.Nesterovs(learning_rate=0.05, momentum=0.9)).list()
            .layer(pkg.DenseLayer(n_out=9, activation="relu"))
            .layer(pkg.DenseLayer(n_out=7, activation="tanh"))
            .layer(pkg.DenseLayer(n_out=6, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(5)).build())


def _data(n=16, seed=5, classes=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _source():
    src = port.MultiLayerNetwork(_conf(port)).init(device="cpu")
    src.fit(*_data(8, seed=1), batch_size=4)   # trained, not fresh
    ref_src = ref.MultiLayerNetwork(_conf(ref)).init()
    ref_src.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(src.params_tree))
    return src, ref_src


def _carry(port_net, ref_net):
    """The port network's (fresh, re-initialized) parameters into the JAX
    one: the two packages draw a new layer from different generators."""
    ref_net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    ref_net.opt_state = jax.tree_util.tree_map(
        jnp.asarray, port_params.opt_state_to_numpy(port_net.opt_state))


EDITS = {
    "feature_extractor": lambda pkg, mod, b: b.set_feature_extractor(1)
    .fine_tune_configuration(mod.FineTuneConfiguration(learning_rate=0.1, l2=1e-3)),
    "n_out_replace": lambda pkg, mod, b: b.n_out_replace(1, 4).set_feature_extractor(0),
    "replace_output": lambda pkg, mod, b: b.set_feature_extractor(2).remove_output_layer()
    .add_layer(pkg.OutputLayer(n_in=6, n_out=4, activation="softmax", loss="mcxent")),
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_builder_matches_reference(edit):
    src, ref_src = _source()
    pkgs = ((port, tl), (ref, rtl))
    nets = []
    for (pkg, mod), s in zip(pkgs, (src, ref_src)):
        nets.append(EDITS[edit](pkg, mod, mod.TransferLearning.builder(s)).build())
    got, want = nets
    assert json.loads(got.conf.to_json()) == json.loads(want.conf.to_json())
    frozen = [l.frozen for l in got.layers]
    assert frozen == [l.frozen for l in want.layers] and any(frozen)
    kept = {"feature_extractor": [0, 1, 2, 3], "n_out_replace": [0, 3],
            "replace_output": [0, 1, 2]}[edit]
    for i in kept:
        for k, t in got.params_tree[i].items():
            assert torch.equal(t, src.params_tree[i][k])
            assert t.data_ptr() != src.params_tree[i][k].data_ptr()
    _carry(got, want)
    before = [{k: t.clone() for k, t in lp.items()} for lp in got.params_tree]
    classes = got.layers[-1].n_out
    x, y = _data(16, seed=6, classes=classes)
    got.fit(x, y, batch_size=4)
    want.fit(x, y, batch_size=4, use_async=False)
    for i, l in enumerate(got.layers):
        if l.frozen:
            for k, t in got.params_tree[i].items():
                assert torch.equal(t, before[i][k])
    for g, w in zip(jax.tree_util.tree_leaves(port_params.params_to_numpy(got.params_tree)),
                    jax.tree_util.tree_leaves(want.params_tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)
    # the source network is untouched by the new one's training
    for i in kept:
        assert not any(t.data_ptr() == src.params_tree[i][k].data_ptr()
                       for k, t in got.params_tree[i].items())


def test_helper_featurizes_and_trains_the_tail_like_reference():
    src, ref_src = _source()
    helper, ref_helper = tl.TransferLearningHelper(src, 1), rtl.TransferLearningHelper(
        ref_src, 1)
    _carry(helper.unfrozen, ref_helper.unfrozen)
    x, y = _data(12, seed=7)
    feats, ref_feats = helper.featurize(DataSet(x, y)), ref_helper.featurize(RefDataSet(x, y))
    np.testing.assert_allclose(feats.features, np.asarray(ref_feats.features),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(feats.features, src.feed_forward(x)[2])
    front = [{k: t.clone() for k, t in lp.items()} for lp in src.params_tree[:2]]
    helper.fit_featurized(feats, epochs=1, batch_size=4)
    ref_helper.fit_featurized(RefDataSet(np.asarray(ref_feats.features), y), epochs=1,
                              batch_size=4)
    for i in range(2):   # the frozen front stays
        for k, t in src.params_tree[i].items():
            assert torch.equal(t, front[i][k])
    for i in (2, 3):     # the tail was trained and written back
        for k, t in src.params_tree[i].items():
            assert torch.equal(t, helper.unfrozen.params_tree[i - 2][k])
    for g, w in zip(jax.tree_util.tree_leaves(port_params.params_to_numpy(src.params_tree)),
                    jax.tree_util.tree_leaves(ref_src.params_tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(helper.output_from_featurized(feats.features),
                               ref_helper.output_from_featurized(ref_feats.features),
                               rtol=1e-5, atol=1e-6)
