"""The multi-model serving merge (nn/graph/fusion.py: merge_serving_conf,
fused_trees_from_members, build_fused_serving_net) in the torch port against
the JAX package, on two small graphs (a conv, LRN, global pooling, a dense
layer and a softmax head; 3 and 5 classes) whose first convs read the shared
input and fuse into one:

- `merge_serving_conf` gives the JAX package's JSON and column slices.
- The fused net's member columns equal each member alone (rtol 1e-5 on the
  CPU: the fused conv sums a wider output) and the JAX package's fused
  net's columns (rtol 1e-5, atol 1e-7).
- Member sets the JAX package refuses, the port refuses with the same
  error type; the port also refuses members of different types.
- The fused trees are copies: a member's later change does not reach them.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
import deeplearning4j_tpu as ref
from deeplearning4j_torch.nn.graph import fusion as port_fusion
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu.nn.graph import fusion as ref_fusion

RTOL, ATOL = 1e-5, 1e-7


def member_conf(pkg, seed, n_out, hw=8):
    g = (pkg.NeuralNetConfiguration.builder().seed(seed).activation("relu")
         .graph_builder())
    g.add_inputs("in")
    g.set_input_types(pkg.InputType.convolutional(hw, hw, 3))
    g.add_layer("conv", pkg.ConvolutionLayer(kernel_size=(3, 3), n_out=4), "in")
    g.add_layer("lrn", pkg.LocalResponseNormalization(alpha=1e-2), "conv")
    g.add_layer("pool", pkg.GlobalPoolingLayer(pooling_type=pkg.PoolingType.AVG), "lrn")
    g.add_layer("dense", pkg.DenseLayer(n_out=8), "pool")
    g.add_layer("out", pkg.OutputLayer(n_out=n_out, activation="softmax",
                                       loss="mcxent"), "dense")
    g.set_outputs("out")
    return g.build()


def carry(port_net, conf):
    """A JAX-package graph holding the port graph's parameters and state."""
    net = ref.ComputationGraph(conf)
    net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    net.state_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.state_to_numpy(port_net.state_tree))
    net.opt_state = jax.tree_util.tree_map(
        jnp.asarray, port_params.opt_state_to_numpy(port_net.opt_state))
    net._rng = jax.random.PRNGKey(0)
    net._build_jitted()
    net._initialized = True
    return net


@pytest.fixture(scope="module")
def members():
    ports = [("a", port.ComputationGraph(member_conf(port, 1, 3)).init(device="cpu")),
             ("b", port.ComputationGraph(member_conf(port, 2, 5)).init(device="cpu"))]
    refs = [(nm, carry(net, member_conf(ref, i + 1, (3, 5)[i])))
            for i, (nm, net) in enumerate(ports)]
    return ports, refs


def _x(n=3, seed=17, hw=8):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


def test_merged_conf_matches_reference(members):
    ports, refs = members
    got, got_slices = port_fusion.merge_serving_conf(ports)
    want, want_slices = ref_fusion.merge_serving_conf(refs)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.topo_order == want.topo_order
    assert got_slices == want_slices == {"a": (0, 3), "b": (3, 5)}
    fused, groups = port_fusion.fuse_sibling_convs(got)
    ref_fused, ref_groups = ref_fusion.fuse_sibling_convs(want)
    assert [g.members for g in groups] == [g.members for g in ref_groups] == \
        [("a/conv", "b/conv")]
    assert json.loads(fused.to_json()) == json.loads(ref_fused.to_json())


def test_fused_columns_match_members_and_reference(members):
    ports, refs = members
    net, groups, slices = port_fusion.build_fused_serving_net(ports)
    ref_net, _, _ = ref_fusion.build_fused_serving_net(refs)
    x = _x()
    out, ref_out = net.output(x), np.asarray(ref_net.output(x))
    assert out.shape == ref_out.shape == (3, 8)
    np.testing.assert_allclose(out, ref_out, rtol=RTOL, atol=ATOL)
    for nm, member in ports:
        off, width = slices[nm]
        np.testing.assert_allclose(out[:, off:off + width], member.output(x),
                                   rtol=RTOL, atol=ATOL)
    assert list(net.params_tree) == net._layer_nodes
    assert net.device == ports[0][1].device and net._dtype == torch.float32


@pytest.mark.parametrize("case", ["one_member", "duplicate_names",
                                  "not_initialized", "not_a_graph",
                                  "input_geometry"])
def test_ineligible_sets_raise_as_reference(members, case):
    ports, refs = members
    other_port = port.ComputationGraph(member_conf(port, 3, 2, hw=6)).init(device="cpu")
    others = {port: other_port, ref: carry(other_port, member_conf(ref, 3, 2, hw=6))}
    for pkg, named, fusion in ((port, ports, port_fusion), (ref, refs, ref_fusion)):
        a, b = named
        bad = {"one_member": [a],
               "duplicate_names": [a, ("a", b[1])],
               "not_initialized": [a, ("c", pkg.ComputationGraph(
                   member_conf(pkg, 3, 2)))],
               "not_a_graph": [a, ("c", object())],
               "input_geometry": [a, ("c", others[pkg])]}[case]
        with pytest.raises(fusion.FusionIneligibleError):
            fusion.merge_serving_conf(bad)


def test_members_of_other_types_are_ineligible(members):
    ports, _ = members
    bf16 = port.ComputationGraph(member_conf(port, 2, 5)).init(
        device="cpu", dtype=torch.bfloat16)
    with pytest.raises(port_fusion.FusionIneligibleError, match="bfloat16"):
        port_fusion.merge_serving_conf([ports[0], ("b16", bf16)])


def test_fused_trees_are_copies(members):
    ports, _ = members
    net, groups, _ = port_fusion.build_fused_serving_net(ports)
    before = net.output(_x())
    a = ports[0][1]
    saved = a.params_tree["dense"]["W"].clone()
    try:
        a.params_tree["dense"]["W"].add_(1.0)
        np.testing.assert_array_equal(net.output(_x()), before)
        params, state = port_fusion.fused_trees_from_members(groups, ports,
                                                             order=net._layer_nodes)
        assert not torch.equal(params["a/dense"]["W"], net.params_tree["a/dense"]["W"])
    finally:
        a.params_tree["dense"]["W"].copy_(saved)
