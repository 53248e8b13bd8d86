"""Embedding indices in the torch port against the JAX package.

- Integer features reach the first layer as integers: a bfloat16 network
  casts floating features only, as the JAX package's `_cast_features` does.
  A bfloat16 cast would round index 257 to 256 and 997 to 996. Held on a
  bfloat16 `EmbeddingLayer(1000 -> 4)` then `OutputLayer(3)` with the same
  parameters in both packages: `output` to bfloat16 rounding, and one `fit`
  step moves the rows of the batch's indices and no others.
- An index outside [-n, n) raises IndexError before the gather, in
  `EmbeddingLayer.forward` and in `embedding_qlookup`. On a CUDA tensor the
  gather would trip a device-side assert that poisons the process's CUDA
  context; `chip_smoke.py` serves a good request after a bad one there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch import quantize as port_q
from deeplearning4j_torch.nn.layers import core as port_core
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref

IDX = np.array([[257], [997], [3]])


def _conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(5)
            .updater(pkg.Sgd(learning_rate=0.5)).list()
            .layer(pkg.EmbeddingLayer(n_in=1000, n_out=4, activation="identity"))
            .layer(pkg.OutputLayer(n_in=4, n_out=3, activation="softmax",
                                   loss="mcxent"))
            .build())


def _nets():
    """(port net, JAX-package net), bfloat16, the same parameters."""
    net = port.MultiLayerNetwork(_conf(port)).init(dtype=torch.bfloat16,
                                                   device="cpu")
    ref_net = ref.MultiLayerNetwork(_conf(ref)).init(dtype=jnp.bfloat16)
    ref_net.params_tree = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16),
        port_params.params_to_numpy(net.params_tree))
    return net, ref_net


def test_bfloat16_output_takes_integer_indices_as_they_are():
    net, ref_net = _nets()
    got, want = net.output(IDX), np.asarray(ref_net.output(IDX), np.float32)
    assert got.shape == (3, 3)
    # both take rows 257, 997 and 3, in bfloat16 with float32 softmax sums
    np.testing.assert_allclose(got.astype(np.float32), want, rtol=2 ** -7,
                               atol=2 ** -8)
    # rows 256 and 996 give other answers, so the rows taken are 257 and 997
    assert not np.allclose(net.output(np.array([[256], [996], [3]]))[:2], got[:2])


def test_bfloat16_fit_moves_the_batchs_rows():
    net, ref_net = _nets()
    y = np.eye(3, dtype=np.float32)[[0, 1, 2]]
    before = port_params.params_to_numpy(net.params_tree)[0]["W"]
    net.fit(IDX, y, batch_size=3)
    ref_net.fit(IDX, y, batch_size=3)
    after = port_params.params_to_numpy(net.params_tree)[0]["W"]
    moved = sorted(np.flatnonzero((after != before).any(-1)).tolist())
    assert moved == [3, 257, 997]
    ref_after = np.asarray(ref_net.params_tree[0]["W"], np.float32)
    ref_moved = sorted(np.flatnonzero((ref_after != before).any(-1)).tolist())
    assert ref_moved == moved
    np.testing.assert_allclose(after[moved], ref_after[moved], rtol=2 ** -7,
                               atol=2 ** -8)


@pytest.mark.parametrize("bad", [1000, -1001, 5000])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_embedding_layer_raises_on_an_index_out_of_range(quantized, bad):
    layer = port_core.EmbeddingLayer(n_in=1000, n_out=4)
    params = {"W": torch.randn(1000, 4), "b": torch.zeros(4)}
    if quantized:
        params = port_q.quantize_tree(params)
    ok = layer.forward(params, torch.tensor([[0], [999], [-1000]]))
    assert ok.shape == (3, 4)
    with pytest.raises(IndexError, match="out of range"):
        layer.forward(params, torch.tensor([[3], [bad]]))


@pytest.mark.parametrize("bad", [20, -21])
def test_embedding_qlookup_raises_on_an_index_out_of_range(bad):
    qp = port_q.quantize_tree({"W": torch.randn(20, 6), "b": torch.zeros(6)})
    assert port_q.embedding_qlookup(qp, torch.tensor([0, 19, -20])).shape == (3, 6)
    with pytest.raises(IndexError, match=r"\[-20, 20\)"):
        port_q.embedding_qlookup(qp, torch.tensor([1, bad, 2]))


def test_network_output_raises_and_then_serves():
    net = port.MultiLayerNetwork(_conf(port)).init(device="cpu")
    with pytest.raises(IndexError):
        net.output(np.array([[1000]]))
    assert net.output(IDX).shape == (3, 3)
