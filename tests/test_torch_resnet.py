"""Zoo ResNet50, SimpleCNN, VGG16 and VGG19 of the torch port against the
JAX package.

- ResNet50's configuration (JSON and topological order) equals the JAX
  package's, as do the spatial sizes its layers infer (a 224x224 image:
  112 -> 55 -> 28 -> 14 -> 7 -> 4); its parameter leaves follow
  `zoo_param_manifest.json` (159 layer nodes), and its state tree holds the
  53 BatchNormalization nodes of the JAX configuration, in sorted order.
- A mini ResNet built with each package's own `_conv_block` and
  `_identity_block` at narrow widths, 32x32x3, batch 4, ResNet50's
  hyperparameters (RmsProp but for its epsilon, normal(0, 0.5), l1, l2),
  from the same
  parameters: the train-mode score and gradients (1e-5 relative norm),
  3 `fit` steps (parameters and BN state after each within 1e-5 relative
  norm per node, RmsProp's mean of g^2 within 2e-5), then `output` on the trained
  running statistics (rtol 1e-5). Untrained networks are compared in train
  mode: ResNet50's normal(0, 0.5) init overflows in evaluation by design
  (the JAX package's tests/test_zoo.py says so).
- SimpleCNN, VGG16 and VGG19: configuration JSON and leaf order against the
  manifest; one evaluation forward of each against the JAX package's
  (rtol 1e-5), SimpleCNN's with a running state carried across.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.models import zoo as ref_zoo
from test_torch_word2vec import one_torch_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _manifest(name):
    with open(os.path.join(FIX, "zoo_param_manifest.json")) as f:
        return json.load(f)[name]


def _assert_leaf_order(name, tree):
    """The order in which a checkpoint numbers the leaves (sorted dict
    keys, utils/params.py `tree_leaves`) against the JAX package's
    manifest, node by node and parameter by parameter."""
    manifest = _manifest(name)
    if isinstance(tree, dict):
        named = {k: {p: f"{k}/{p}" for p in lp} for k, lp in tree.items()}
        keys = sorted(tree)
    else:
        named = tuple({p: f"{i}/{p}" for p in lp} for i, lp in enumerate(tree))
        keys = list(range(len(tree)))
    groups = {}
    for leaf in port_params.tree_leaves(named):
        key, pname = leaf.split("/")
        groups.setdefault(key, []).append(pname)
    assert [[k, v] for k, v in groups.items()] == [[str(k), v] for k, v in manifest if v]
    assert keys == [k for k, _ in manifest]


def _node_types(conf):
    """Each node's output type, inferred along the topological order by the
    package's own layers and vertices (on copies)."""
    types = dict(zip(conf.network_inputs, conf.input_types))
    for name in conf.topo_order:
        node = conf.nodes[name]
        ins = [types[i] for i in node.inputs]
        if node.is_layer():
            it = ins[0] if node.preprocessor is None else \
                node.preprocessor.output_type(ins[0])
            types[name] = copy.deepcopy(node.layer).set_input_type(it)
        else:
            types[name] = node.vertex.output_type(ins)
    return types


def _hwc(t):
    return tuple(getattr(t, a, None) for a in ("height", "width", "channels", "size"))


def test_resnet50_conf_matches_reference():
    mine, theirs = port_zoo.ResNet50().conf(), ref_zoo.ResNet50().conf()
    assert json.loads(mine.to_json()) == json.loads(theirs.to_json())
    assert mine.topo_order == theirs.topo_order
    kinds = [type(n.layer if n.is_layer() else n.vertex).__name__
             for n in mine.nodes.values()]
    assert kinds.count("BatchNormalization") == 53
    assert kinds.count("ElementWiseVertex") == 16
    got, want = _node_types(mine), _node_types(theirs)
    assert {n: _hwc(t) for n, t in got.items()} == {n: _hwc(t) for n, t in want.items()}
    # the strided 1x1 convs of every _conv_block, Truncate mode
    assert [got[n].height for n in ("stem-cnn1", "stem-maxpool1", "res2a_branch2a",
                                    "res3a_branch2a", "res4a_branch2a",
                                    "res5a_branch2a")] == [112, 55, 28, 14, 7, 4]


def test_resnet50_leaf_order_and_state_nodes():
    net = port_zoo.ResNet50(num_labels=10, input_shape=(64, 64, 3)).init(device="cpu")
    _assert_leaf_order("ResNet50", net.params_tree)
    assert len(_manifest("ResNet50")) == 159 == len(net.params_tree)
    theirs = ref_zoo.ResNet50(num_labels=10, input_shape=(64, 64, 3)).conf()
    bn = sorted(n for n, node in theirs.nodes.items()
                if node.is_layer() and type(node.layer).__name__ == "BatchNormalization")
    state_nodes = [n for n in port_params.tree_leaves(
        {k: {s: k for s in st} for k, st in net.state_tree.items()})][::2]
    assert len(bn) == 53 and state_nodes == bn
    for n in bn:
        st = net.state_tree[n]
        assert st["mean"].dtype == st["var"].dtype == torch.float32
        assert not st["mean"].any() and bool((st["var"] == 1).all())


# ------------------------------------------------------------- mini ResNet

def _mini_conf(pkg, pkg_zoo):
    model = pkg_zoo.ResNet50()
    g = (pkg.NeuralNetConfiguration.builder()
         .seed(17)
         .activation("identity")
         # ResNet50's RmsProp but for epsilon (1e-3 there): a step is
         # lr g / (sqrt(v) + eps), so where g is 0 but for rounding (the
         # conv biases ahead of a train-mode BN, and the stem BN's beta in
         # every channel whose pool windows all hold a positive: 1x1 convs
         # into train-mode BNs give such cotangents a zero sum) the step is
         # rounding times lr / eps, 100x at 1e-3, which would swamp the
         # comparison; 0.1 keeps it at 1x
         .updater(pkg.RmsProp(learning_rate=0.1, rms_decay=0.96, epsilon=0.1))
         .weight_init(pkg.WeightInit.DISTRIBUTION)
         .dist(pkg.Distribution(kind="normal", mean=0.0, std=0.5))
         .l1(1e-7).l2(5e-5)
         .graph_builder())
    g.add_inputs("input")
    g.set_input_types(pkg.InputType.convolutional(32, 32, 3))
    g.add_layer("stem-zero", pkg.ZeroPaddingLayer(padding=(1, 1)), "input")
    g.add_layer("stem-cnn1", pkg.ConvolutionLayer(
        kernel_size=(3, 3), stride=(2, 2), n_out=8), "stem-zero")
    a = model._bn_act(g, "stem1", "stem-cnn1")
    # "mask", the JAX package's CPU max pool, on both sides
    g.add_layer("stem-maxpool1", pkg.SubsamplingLayer(
        kernel_size=(3, 3), stride=(2, 2), pooling_type=pkg.PoolingType.MAX,
        pooling_impl="mask"), a)
    x = model._conv_block(g, (3, 3), (8, 8, 16), "2", "a", "stem-maxpool1",
                          stride=(1, 1))
    x = model._identity_block(g, (3, 3), (8, 8, 16), "2", "b", x)
    x = model._conv_block(g, (3, 3), (12, 12, 24), "3", "a", x)
    g.add_layer("avgpool", pkg.GlobalPoolingLayer(pooling_type=pkg.PoolingType.AVG), x)
    g.add_layer("output", pkg.OutputLayer(n_out=5, activation="softmax",
                                          loss="negativeloglikelihood"), "avgpool")
    g.set_outputs("output")
    return g.build()


def _carry(port_net, conf):
    """A JAX-package graph holding the port graph's parameters, optimizer
    state and layer state."""
    net = ref.ComputationGraph(conf)
    conv = lambda tree, fn: jax.tree_util.tree_map(jnp.asarray, fn(tree))
    net.params_tree = conv(port_net.params_tree, port_params.params_to_numpy)
    net.opt_state = conv(port_net.opt_state, port_params.opt_state_to_numpy)
    net.state_tree = conv(port_net.state_tree, port_params.state_to_numpy)
    net._rng = jax.random.PRNGKey(0)
    net._build_jitted()
    net._initialized = True
    return net


def _data(n, seed=41):
    rng = np.random.default_rng(seed)
    x = (0.5 + rng.standard_normal((n, 32, 32, 3))).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    return x, y


def _rel_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def mini():
    port_net = port.ComputationGraph(_mini_conf(port, port_zoo)).init(device="cpu")
    conf = _mini_conf(ref, ref_zoo)
    assert json.loads(conf.to_json()) == json.loads(port_net.conf.to_json())
    assert port_net.conf.topo_order == conf.topo_order
    return port_net, conf


def test_mini_resnet_train_mode_score_and_gradients(mini):
    port_net, conf = mini
    ref_net = _carry(port_net, conf)
    x, y = _data(4)
    inputs, labels, fm, lm = port_net._pack(port_net._coerce(x, y))
    s, grads, new_state = port_net._value_and_grad(inputs, labels, fm, lm, True, None)
    (want_s, want_state), want_g = jax.jit(lambda p, st, a, b: jax.value_and_grad(
        ref_net._loss_pure, has_aux=True)(p, st, {"input": a}, {"output": b}, {}, {},
                                          None, True))(
        ref_net.params_tree, ref_net.state_tree, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(s), float(want_s), rtol=1e-5)
    got_g = port_params.params_to_numpy(grads)
    conv_nodes = {n for n, node in conf.nodes.items() if node.is_layer()
                  and type(node.layer).__name__ == "ConvolutionLayer"}
    for n, wl in want_g.items():
        for k, w in wl.items():
            w = np.asarray(w)
            if k == "b" and n in conv_nodes:
                # every conv feeds a train-mode BN, so its bias gradient is
                # 0 but for rounding, 1e-9 of the kernel's
                assert np.abs(got_g[n][k]).max() < 1e-6 * np.abs(got_g[n]["W"]).max()
                continue
            assert _rel_err(got_g[n][k], w) < 1e-5, (n, k)
    got_state = port_params.state_to_numpy(new_state)
    for n, wl in want_state.items():
        for k, w in wl.items():
            np.testing.assert_allclose(got_state[n][k], np.asarray(w), rtol=1e-5,
                                       atol=1e-6 * np.abs(np.asarray(w)).max())


class _Recorder:
    def __init__(self, to_numpy):
        self.to_numpy = to_numpy
        self.steps = []

    def iteration_done(self, model, iteration):
        self.steps.append((iteration, float(model.score_value)) + self.to_numpy(model))


def _port_snap(model):
    return (port_params.params_to_numpy(model.params_tree),
            port_params.opt_state_to_numpy(model.opt_state),
            port_params.state_to_numpy(model.state_tree))


def _ref_snap(model):
    copy_ = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, copy=True), t)
    return copy_(model.params_tree), copy_(model.opt_state), copy_(model.state_tree)


def _assert_close_by_node(got, want, what, tol=1e-5):
    """Every node's leaves, taken together, within `tol` relative norm: a
    conv's bias ahead of a train-mode BN has a gradient that is 0 but for
    rounding, so its steps differ by rounding, against a kernel of 0.5."""
    assert sorted(got) == sorted(want), what
    worst = 0.0
    for n, wl in want.items():
        flat_w = [np.asarray(w).ravel() for w in jax.tree_util.tree_leaves(wl)]
        flat_g = [np.asarray(g).ravel() for g in jax.tree_util.tree_leaves(got[n])]
        assert [a.shape for a in flat_g] == [a.shape for a in flat_w], (what, n)
        if flat_w:
            err = _rel_err(np.concatenate(flat_g), np.concatenate(flat_w))
            worst = max(worst, err)
            assert err < tol, (what, n, err)
    return worst


def test_mini_resnet_three_fit_steps_then_trained_output(mini):
    port_net, conf = mini
    port_net = port.ComputationGraph(port_net.conf).init(device="cpu")
    ref_net = _carry(port_net, conf)
    x, y = _data(12, seed=42)
    pr, rr = _Recorder(_port_snap), _Recorder(_ref_snap)
    port_net.listeners.append(pr)
    ref_net.listeners.append(rr)
    port_net.fit(x, y, batch_size=4)
    ref_net.fit(x, y, batch_size=4, use_async=False)
    assert len(pr.steps) == len(rr.steps) == 3
    for (pi, ps, pp, po, pst), (ri, rs, rp, ro, rst) in zip(pr.steps, rr.steps):
        assert pi == ri
        np.testing.assert_allclose(ps, rs, rtol=1e-5)
        _assert_close_by_node(pp, rp, f"params {pi}")
        # RmsProp's state is a running mean of g^2: the square doubles the
        # gradients' relative differences (up to 4.6e-6 after one step)
        _assert_close_by_node(po, ro, f"RmsProp {pi}", tol=2e-5)
        _assert_close_by_node(pst, rst, f"BN state {pi}")
    # evaluation on the trained running statistics, the state left as it is
    before = port_params.state_to_numpy(port_net.state_tree)
    got, want = port_net.output(x[:4]), np.asarray(ref_net.output(x[:4]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    after = port_params.state_to_numpy(port_net.state_tree)
    for n in before:
        for k in before[n]:
            np.testing.assert_array_equal(after[n][k], before[n][k])


# ------------------------------------------- SimpleCNN, VGG16 and VGG19

SMALL = dict(num_labels=10, input_shape=(32, 32, 3))


@pytest.mark.parametrize("name", ["SimpleCNN", "VGG16", "VGG19"])
def test_mln_zoo_conf_and_leaf_order(name):
    mine = getattr(port_zoo, name)(**SMALL)
    assert json.loads(mine.conf().to_json()) == \
        json.loads(getattr(ref_zoo, name)(**SMALL).conf().to_json())
    net = mine.init(device="cpu")
    _assert_leaf_order(name, net.params_tree)
    n_bn = sum(1 for s in net.state_tree if s)
    assert n_bn == (9 if name == "SimpleCNN" else 0)


def test_simple_cnn_eval_forward_matches_reference_with_state():
    port_net = port_zoo.SimpleCNN().init(device="cpu")
    rng = np.random.default_rng(43)
    # a running state away from its init, as training would leave it
    state = tuple({k: (rng.random(v.shape).astype(np.float32) + 0.5 if k == "var"
                       else 0.1 * rng.standard_normal(v.shape).astype(np.float32))
                   for k, v in st.items()} for st in
                  port_params.state_to_numpy(port_net.state_tree))
    port_net.state_tree = port_params.state_from_numpy(state, device="cpu")
    ref_net = ref.MultiLayerNetwork(ref_zoo.SimpleCNN().conf()).init()
    ref_net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    ref_net.state_tree = jax.tree_util.tree_map(jnp.asarray, state)
    x = rng.standard_normal((3, 48, 48, 1)).astype(np.float32)
    got, want = port_net.output(x), np.asarray(ref_net.output(x))
    assert got.shape == (3, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["VGG16", "VGG19"])
def test_vgg_forward_matches_reference(name):
    port_net = getattr(port_zoo, name)(**SMALL).init(device="cpu")
    ref_net = ref.MultiLayerNetwork(getattr(ref_zoo, name)(**SMALL).conf()).init()
    ref_net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    x = np.random.default_rng(44).standard_normal((2, 32, 32, 3)).astype(np.float32)
    got, want = port_net.output(x), np.asarray(ref_net.output(x))
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
