"""The torch port's configuration DSL, MultiLayerNetwork and zoo against the
JAX package.

- Configuration JSON round-trips both ways: the JAX package's JSON builds
  the same layer list in the port, and the port's JSON in the JAX package.
- A narrow AlexNet-shaped net gives the same `output()` as the JAX package
  from the same weights (the port's init, carried over with
  params_to_numpy), at atol 2e-5 (float32, sums in another order).
- Zoo AlexNet at 60x60x3 (where the JAX package runs its space-to-depth
  stem) gives the same activations layer by layer.
- Weight init: the generators differ, so the DISTRIBUTION layers are held
  to their mean and std, not to the JAX package's values.
"""
import json

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.models import zoo as ref_zoo
from deeplearning4j_tpu.utils import serde as ref_serde


def _narrow_conf(pkg):
    """conv->LRN->pool->conv->LRN->pool->conv->pool->dense->output, at
    AlexNet's strides and modes but a few channels wide."""
    return (pkg.NeuralNetConfiguration.builder()
            .seed(7)
            .weight_init(pkg.WeightInit.XAVIER)
            .activation("relu")
            .updater(pkg.Nesterovs(learning_rate=1e-2, momentum=0.9))
            .convolution_mode(pkg.ConvolutionMode.SAME)
            .list()
            .layer(pkg.ConvolutionLayer(
                kernel_size=(5, 5), stride=(2, 2), padding=(1, 1), n_out=8,
                convolution_mode=pkg.ConvolutionMode.TRUNCATE))
            .layer(pkg.LocalResponseNormalization(alpha=1e-2))
            .layer(pkg.SubsamplingLayer(
                kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
                pooling_type=pkg.PoolingType.MAX,
                convolution_mode=pkg.ConvolutionMode.TRUNCATE))
            .layer(pkg.ConvolutionLayer(kernel_size=(3, 3), stride=(2, 2),
                                        n_out=12, bias_init=0.1))
            .layer(pkg.LocalResponseNormalization(n=4, alpha=1e-2))
            .layer(pkg.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                        pooling_type=pkg.PoolingType.MAX))
            .layer(pkg.ConvolutionLayer(kernel_size=(3, 3), n_out=16))
            .layer(pkg.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type=pkg.PoolingType.MAX))
            .layer(pkg.DenseLayer(n_out=24, dropout_rate=0.5))
            .layer(pkg.OutputLayer(n_out=5, activation="softmax",
                                   loss="negativeloglikelihood"))
            .set_input_type(pkg.InputType.convolutional(33, 33, 3))
            .build())


def _pair(ref_conf, port_net):
    """A JAX-package network holding the port's initialized weights,
    carried over with params_to_numpy. (Its own init() would spend seconds
    compiling the random draws this test does not need.)"""
    ref_net = ref.MultiLayerNetwork(ref_conf)
    ref_net.params_tree = jax.tree_util.tree_map(
        jax.numpy.asarray, port_params.params_to_numpy(port_net.params_tree))
    ref_net.state_tree = tuple(l.init_state() for l in ref_net.layers)
    ref_net._build_jitted()
    ref_net._initialized = True
    return ref_net


def _images(shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("make", [
    _narrow_conf,
    lambda pkg: (ref_zoo if pkg is ref else port_zoo).AlexNet(
        input_shape=(60, 60, 3), num_labels=10).conf(),
    lambda pkg: (ref_zoo if pkg is ref else port_zoo).LeNet().conf(),
], ids=["narrow", "alexnet60", "lenet"])
def test_conf_json_round_trips_both_ways(make):
    ref_conf, port_conf = make(ref), make(port)
    ref_json, port_json = ref_conf.to_json(), port_conf.to_json()
    assert json.loads(port_json) == json.loads(ref_json)
    from_ref = port.MultiLayerConfiguration.from_json(ref_json)
    from_port = ref.MultiLayerConfiguration.from_json(port_json)
    assert [type(l).__name__ for l in from_ref.layers] == \
        [type(l).__name__ for l in ref_conf.layers]
    assert json.loads(from_ref.to_json()) == json.loads(ref_json)
    assert json.loads(ref_serde.to_json(from_port)) == json.loads(port_json)
    # the preprocessor auto-inserted before the first dense layer survives
    assert any(isinstance(p, port.nn.conf.inputs.CnnToFeedForwardPreProcessor)
               for p in from_ref.input_preprocessors.values())


def test_narrow_net_output_matches_reference():
    port_net = port.MultiLayerNetwork(_narrow_conf(port)).init(device="cpu")
    ref_net = _pair(_narrow_conf(ref), port_net)
    x = _images((4, 33, 33, 3))
    want = ref_net.output(x)
    got = port_net.output(x)
    assert got.shape == want.shape == (4, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(port_net.predict(x), ref_net.predict(x))


def test_zoo_alexnet_60px_matches_reference_layer_by_layer():
    port_net = port_zoo.AlexNet(input_shape=(60, 60, 3),
                                num_labels=10).init(device="cpu")
    ref_net = _pair(ref_zoo.AlexNet(input_shape=(60, 60, 3),
                                    num_labels=10).conf(), port_net)
    x = _images((2, 60, 60, 3))
    want = ref_net.feed_forward(x)
    got = port_net.feed_forward(x)
    assert len(got) == len(want) == 14
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        # absolute scale per layer: N(0, 0.01) weights shrink activations
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-5 * scale,
                                   err_msg=f"layer {i}")
    np.testing.assert_allclose(port_net.output(x), ref_net.output(x),
                               rtol=1e-5, atol=2e-5)


def test_zoo_alexnet_full_width_shapes():
    """The full-width configuration infers the published shapes (no init:
    24.4M float32 weights)."""
    conf = port_zoo.AlexNet().conf()
    net = port.MultiLayerNetwork(conf)
    assert tuple(net._feature_struct(8).shape) == (8, 224, 224, 3)
    assert [l.n_in for l in conf.layers
            if isinstance(l, port.DenseLayer)] == [256, 4096, 4096]
    assert conf.layers[-1].n_out == 1000


def test_weight_init_statistics():
    net = port_zoo.AlexNet(input_shape=(60, 60, 3),
                           num_labels=10).init(device="cpu", seed=3)
    p = net.params_tree
    for i, std in ((0, 0.01), (3, 0.01), (6, 0.01), (10, 0.005), (11, 0.005)):
        w = p[i]["W"]
        assert abs(w.mean().item()) < 0.1 * std, i
        assert abs(w.std().item() / std - 1.0) < 0.05, i
    assert torch.all(p[3]["b"] == 1.0) and torch.all(p[0]["b"] == 0.0)
    again = port_zoo.AlexNet(input_shape=(60, 60, 3),
                             num_labels=10).init(device="cpu", seed=3)
    assert torch.equal(again.params_tree[10]["W"], p[10]["W"])
