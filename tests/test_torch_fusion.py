"""Sibling-conv fusion (nn/graph/fusion.py) in the torch port against the
JAX package.

- The groups and the fused configuration of zoo GoogLeNet equal the JAX
  package's, field by field in JSON, with the same topological order.
- `fuse_params` gives the JAX package's fused parameters and optimizer
  state (carried to its layout), and `unfuse_params` undoes it bitwise.
- A fused graph (`fuse_graph`) answers as the unfused one (rtol 1e-6 on the
  CPU: one wider conv sums in another order), and one `fit` step of each
  lands on the same parameters once unfused (rtol 1e-5).
- The exactness gates reject dropout, gradient normalization and network
  outputs, and the counter records the decisions.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.nn.graph import fusion as port_fusion
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu.models import zoo as ref_zoo
from deeplearning4j_tpu.nn.graph import fusion as ref_fusion


def test_googlenet_groups_and_fused_conf_match_reference():
    got_conf, got_groups = port_fusion.fuse_sibling_convs(port_zoo.GoogLeNet().conf())
    want_conf, want_groups = ref_fusion.fuse_sibling_convs(ref_zoo.GoogLeNet().conf())
    assert len(got_groups) == 9   # one per inception block
    assert [(g.fused_name, g.input, g.members, g.n_outs, g.offsets)
            for g in got_groups] == \
        [(g.fused_name, g.input, g.members, g.n_outs, g.offsets) for g in want_groups]
    assert json.loads(got_conf.to_json()) == json.loads(want_conf.to_json())
    assert got_conf.topo_order == want_conf.topo_order
    assert json.loads(port_zoo.GoogLeNet(fuse_siblings=True).conf().to_json()) == \
        json.loads(got_conf.to_json())


@pytest.fixture(scope="module")
def small():
    """GoogLeNet at 32x32x3 with 10 classes, dropout off, on the CPU, its
    optimizer state filled with small random values."""
    zoo = port_zoo.GoogLeNet(num_labels=10, input_shape=(32, 32, 3))
    conf = zoo.conf()
    conf.nodes["fc1"].layer.dropout_rate = 0.0
    net = port.ComputationGraph(conf).init(device="cpu")
    rng = np.random.default_rng(3)
    net.opt_state = port_params.tree_map(
        lambda t: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)
                                   * 1e-3).to(memory_format=torch.channels_last
                                              if t.ndim == 4 else torch.contiguous_format),
        net.opt_state)
    return net


def _images(n, seed=5):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def test_fuse_params_matches_reference_and_unfuses_bitwise(small):
    net = small
    _, groups = port_fusion.fuse_sibling_convs(net.conf)
    _, ref_groups = ref_fusion.fuse_sibling_convs(
        ref_zoo.GoogLeNet(num_labels=10, input_shape=(32, 32, 3)).conf())
    for tree in (net.params_tree, net.opt_state):
        fused = port_fusion.fuse_params(groups, tree)
        want = ref_fusion.fuse_params(ref_groups, jax.tree_util.tree_map(
            jnp.asarray, port_params.params_to_numpy(tree)))
        got = port_params.params_to_numpy(fused)
        assert sorted(got) == sorted(want)
        for node in want:
            for g, w in zip(port_params.tree_leaves(got[node]),
                            jax.tree_util.tree_leaves(want[node])):
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=node)
        back = port_fusion.unfuse_params(groups, fused)
        assert sorted(back) == sorted(tree)
        for node in tree:
            for a, b in zip(port_params.tree_leaves(tree[node]),
                            port_params.tree_leaves(back[node])):
                assert torch.equal(a, b), node


def test_fused_graph_answers_and_trains_as_the_unfused_one(small):
    net = port.ComputationGraph(small.conf).init(device="cpu")
    net.opt_state = small.opt_state
    fused = port_fusion.fuse_graph(net)
    assert fused is not net and fused.num_params() == net.num_params()
    assert sum(n.is_layer() for n in fused.conf.nodes.values()) == \
        sum(n.is_layer() for n in net.conf.nodes.values()) - 2 * 9
    x = _images(4)
    np.testing.assert_allclose(fused.output(x), net.output(x), rtol=1e-6, atol=1e-8)
    y = np.eye(10, dtype=np.float32)[[1, 3, 5, 7]]
    net.fit(x, y, batch_size=4)
    fused.fit(x, y, batch_size=4)
    np.testing.assert_allclose(float(fused.score_value), float(net.score_value),
                               rtol=1e-6)
    _, groups = port_fusion.fuse_sibling_convs(net.conf)
    for attr, atol in (("params_tree", 1e-7), ("opt_state", 1e-9)):
        back = port_fusion.unfuse_params(groups, getattr(fused, attr))
        for node, sub in getattr(net, attr).items():
            for a, b in zip(port_params.tree_leaves(sub),
                            port_params.tree_leaves(back[node])):
                torch.testing.assert_close(b, a, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("gate", ["dropout", "gradient_normalization", "network_output",
                                  "different_geometry"])
def test_gates_reject_what_would_not_be_exact(gate):
    def conf(as_outputs=False, **second):
        g = (port.NeuralNetConfiguration.builder().graph_builder()
             .add_inputs("in").set_input_types(port.InputType.convolutional(6, 6, 3)))
        g.add_layer("a", port.ConvolutionLayer(kernel_size=(1, 1), n_out=4), "in")
        g.add_layer("b", port.ConvolutionLayer(kernel_size=(1, 1), n_out=5, **second), "in")
        outs = ["a", "b"] if as_outputs else []
        if not outs:
            g.add_vertex("m", port.MergeVertex(), "a", "b")
            g.add_layer("pool", port.GlobalPoolingLayer(), "m")
            g.add_layer("out", port.OutputLayer(n_out=2), "pool")
            outs = ["out"]
        return g.set_outputs(*outs).build()

    assert len(port_fusion.find_sibling_conv_groups(conf())) == 1
    second = {"dropout": dict(dropout_rate=0.5),
              "gradient_normalization": dict(
                  gradient_normalization=port.GradientNormalization.RENORMALIZE_L2_PER_LAYER),
              "network_output": dict(as_outputs=True),
              "different_geometry": dict(stride=(2, 2))}[gate]
    before = dict(port_fusion.sibling_conv_fusion_total)
    fused, groups = port_fusion.fuse_sibling_convs(conf(**second))
    assert groups == [] and port_fusion.sibling_conv_fusion_total == before
    assert json.loads(fused.to_json()) == json.loads(conf(**second).to_json())
    port_fusion.fuse_sibling_convs(conf())
    assert port_fusion.sibling_conv_fusion_total["fused"] == before["fused"] + 1


def test_fuse_graph_carries_the_layer_state():
    """Sibling 1x1 convs each feeding a BatchNormalization: the fused graph
    carries the BN nodes' running statistics as they are (the fused conv
    node has none), answers on them as the unfused graph does, and a
    training step moves the same state."""
    g = (port.NeuralNetConfiguration.builder().seed(4)
         .updater(port.Sgd(learning_rate=0.1)).graph_builder()
         .add_inputs("in").set_input_types(port.InputType.convolutional(6, 6, 3)))
    g.add_layer("a", port.ConvolutionLayer(kernel_size=(1, 1), n_out=4), "in")
    g.add_layer("b", port.ConvolutionLayer(kernel_size=(1, 1), n_out=5), "in")
    g.add_layer("bn_a", port.BatchNormalization(), "a")
    g.add_layer("bn_b", port.BatchNormalization(), "b")
    g.add_vertex("m", port.MergeVertex(), "bn_a", "bn_b")
    g.add_layer("pool", port.GlobalPoolingLayer(pooling_type=port.PoolingType.AVG), "m")
    g.add_layer("out", port.OutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"), "pool")
    net = port.ComputationGraph(g.set_outputs("out").build()).init(device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    net.fit(x, y, batch_size=4)   # a running state away from its init
    fused = port_fusion.fuse_graph(net)
    assert fused is not net and "a+b" in fused.state_tree
    assert fused.state_tree["a+b"] == {}
    for n in ("bn_a", "bn_b"):
        for k in ("mean", "var"):
            assert torch.equal(fused.state_tree[n][k], net.state_tree[n][k])
    np.testing.assert_allclose(fused.output(x), net.output(x), rtol=1e-6, atol=1e-7)
    net.fit(x, y, batch_size=4)
    fused.fit(x, y, batch_size=4)
    for n in ("bn_a", "bn_b"):
        for k in ("mean", "var"):
            torch.testing.assert_close(fused.state_tree[n][k], net.state_tree[n][k],
                                       rtol=1e-6, atol=1e-7)
