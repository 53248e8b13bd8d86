"""Integer features into a float network, against the JAX package.

The networks keep integer features integer (embedding indices depend on
it, tests/test_torch_embedding_indices.py), and the JAX package's ``x @ w``
promotes an integer x to the weight's type; the port's product
(`quantize.matmul_any`) does the same. Dense(4 -> 3, tanh) + Output(2,
softmax) on int32 features, as a MultiLayerNetwork and as a
ComputationGraph, from the same parameters: `output`, `score` and one `fit`
step (rtol 1e-6; params 1e-6 relative, float32 both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.quantize import quantize as port_quant
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet

X = np.array([[0, 1, 0, 2], [1, 0, 3, 0]], np.int32)
Y = np.array([[1, 0], [0, 1]], np.float32)


def _mln(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(5)
            .updater(pkg.Sgd(learning_rate=0.1)).list()
            .layer(pkg.DenseLayer(n_out=3, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(4)).build())


def _graph(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(5)
            .updater(pkg.Sgd(learning_rate=0.1)).graph_builder()
            .add_inputs("in")
            .add_layer("dense", pkg.DenseLayer(n_out=3, activation="tanh"), "in")
            .add_layer("out", pkg.OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "dense")
            .set_outputs("out")
            .set_input_types(pkg.InputType.feed_forward(4)).build())


def _pair(kind):
    if kind == "mln":
        mine = port.MultiLayerNetwork(_mln(port)).init(device="cpu")
        theirs = ref.MultiLayerNetwork(_mln(ref)).init()
    else:
        mine = port.ComputationGraph(_graph(port)).init(device="cpu")
        theirs = ref.ComputationGraph(_graph(ref)).init()
    theirs.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(mine.params_tree))
    return mine, theirs


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_integer_features_match_reference(kind):
    mine, theirs = _pair(kind)
    got, want = mine.output(X), np.asarray(theirs.output(X))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if kind == "mln":
        got_s, want_s = mine.score(x=X, y=Y), theirs.score(x=X, y=Y)
    else:
        got_s = mine.score(port.DataSet(X, Y))
        want_s = theirs.score(RefDataSet(X, Y))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    mine.fit(X, Y, batch_size=2)
    theirs.fit(X, Y, batch_size=2, use_async=False)
    got_p = port_params.params_to_numpy(mine.params_tree)
    want_p = theirs.params_tree
    layers = got_p.items() if isinstance(got_p, dict) else enumerate(got_p)
    for i, gl in layers:
        for k, g in gl.items():
            np.testing.assert_allclose(g, np.asarray(want_p[i][k]), rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_allclose(float(mine.score_value), float(theirs.score_value),
                               rtol=1e-6)


def test_matmul_any_promotes_integers_to_the_weight_type():
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(X)
    got = port_quant.matmul_any(x, w)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, x.float() @ w)
    assert port_quant.matmul_any(x, w.to(torch.bfloat16)).dtype == torch.float32
