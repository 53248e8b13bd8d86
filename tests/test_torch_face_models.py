"""CenterLossOutputLayer, the zoo block helpers (models/helpers.py) and zoo
InceptionResNetV1 and FaceNetNN4Small2 of the torch port against the JAX
package.

- CenterLossOutputLayer: score, score array and gradients against the JAX
  layer (rtol 1e-6 / 1e-5): the features feel lambda, the centers alpha,
  the reported score stays base + lambda/2 mean ||x - c_y||^2; centers
  start at zero and take no regularization.
- The helpers: `conv_bn` and every block helper build the JAX package's
  node names, layers and JSON, and the node shapes it infers.
- A mini face graph from the helpers (conv_bn, Inception-ResNet A/B/C,
  reductions A/B, a FaceNet inception module, bottleneck, L2NormalizeVertex,
  center loss; Xavier init, 16x16x3, batch 8, RmsProp) from the same
  parameters: 2 `fit` steps (scores rtol 1e-5; parameters, RmsProp and BN
  state after each within 1e-4 relative norm per leaf), then `output`
  (rtol 1e-5).
- The zoo models at the JAX package's test sizes (InceptionResNetV1 at
  64x64, FaceNetNN4Small2 at 96x96, 7 and 9 labels, batch 2): JSON and
  topological order equal; every node's train-mode forward and new BN state
  computed from the JAX package's activations of its inputs (each node and
  state within 1e-5 of its largest value, one node at a time: at init these deep
  normal(0, 0.5) / ReLU-init stacks amplify float32 rounding through
  batch statistics of 8-18 values per channel to 1e-3 of an activation and
  a few % of a gradient, in either package); FaceNetNN4Small2's evaluation
  output (rtol 1e-5); and one `fit` step against the JAX package's
  train-mode forward at the same trees: its score (rtol 2e-4) and every
  BN node's new state (within 1e-4 of its largest value in FaceNetNN4Small2,
  3e-3 in InceptionResNetV1: the batch statistics of the whole forward,
  whose rounding the deep stack carries to 2.7e-5 and 1.4e-3 there).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.models import helpers as port_helpers
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.nn.layers import pretrain as port_pretrain
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.models import helpers as ref_helpers
from deeplearning4j_tpu.models import zoo as ref_zoo
from deeplearning4j_tpu.nn.layers import pretrain as ref_pretrain

from test_torch_resnet import _carry, _hwc, _node_types
from test_torch_word2vec import one_torch_thread  # noqa: F401


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------ CenterLossOutputLayer

def _center_pair(n_in=6, n_out=4):
    kw = dict(n_in=n_in, n_out=n_out, activation="softmax", loss="mcxent",
              alpha=0.9, lambda_=0.3, l2=0.01)
    r, p = ref_pretrain.CenterLossOutputLayer(**kw), port_pretrain.CenterLossOutputLayer(**kw)
    rp = r.init_params(jax.random.PRNGKey(3))
    rp = dict(rp, cW=jnp.asarray(np.random.default_rng(1).standard_normal((n_out, n_in)),
                                 jnp.float32))
    pp = port_params.params_from_numpy((jax.tree_util.tree_map(np.asarray, rp),),
                                       "cpu")[0]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[[0, 3, 1, 3, 2]]
    return r, rp, p, pp, x, y


def test_center_loss_init_and_regularization():
    layer = port.CenterLossOutputLayer(n_in=6, n_out=4, l2=0.5)
    p = layer.init_params(torch.Generator().manual_seed(0))
    assert sorted(p) == ["W", "b", "cW"] and not p["cW"].any()
    assert tuple(p["cW"].shape) == (4, 6)
    assert layer.param_reg("cW") == (0.0, 0.0) and layer.param_reg("W") == (0.0, 0.5)


def test_center_loss_score_and_score_array_match_reference():
    r, rp, p, pp, x, y = _center_pair()
    got = p.compute_score(pp, torch.from_numpy(x), torch.from_numpy(y))
    want = r.compute_score(rp, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the reported score: base + lambda/2 mean ||x - c_y||^2
    base = port.OutputLayer.compute_score(p, pp, torch.from_numpy(x), torch.from_numpy(y))
    c_y = pp["cW"][torch.from_numpy(y).argmax(-1)]
    centre = 0.5 * 0.3 * torch.mean(torch.sum((torch.from_numpy(x) - c_y) ** 2, -1))
    np.testing.assert_allclose(float(got), float(base + centre), rtol=1e-6)
    arr = p.compute_score_array(pp, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(arr.numpy(), np.asarray(r.compute_score_array(
        rp, jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)


def test_center_loss_gradients_features_lambda_centers_alpha():
    r, rp, p, pp, x, y = _center_pair()
    want_p, want_x = jax.grad(lambda q, xx: r.compute_score(q, xx, jnp.asarray(y)),
                              argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in pp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    p.compute_score(leaves, xt, torch.from_numpy(y)).backward()
    for k in ("W", "b", "cW"):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(want_p[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-7)
    # the centers feel alpha: d/dc of alpha/2 mean ||x - c_y||^2
    yi = y.argmax(-1)
    want_c = np.zeros_like(x[:4])
    c = np.asarray(rp["cW"])
    for i, k in enumerate(yi):
        want_c[k] += 0.9 * (c[k] - x[i]) / len(x)
    np.testing.assert_allclose(leaves["cW"].grad.numpy(), want_c, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ block helpers

def _helper_graph(pkg, helpers, hw=16):
    """Every helper once, in a small graph with a center-loss head."""
    g = (pkg.NeuralNetConfiguration.builder().seed(21)
         .activation("relu")
         .updater(pkg.RmsProp(learning_rate=1e-2, rms_decay=0.96, epsilon=0.1))
         .weight_init(pkg.WeightInit.XAVIER)
         .graph_builder())
    g.add_inputs("input")
    g.set_input_types(pkg.InputType.convolutional(hw, hw, 3))
    x = helpers.conv_bn(g, "stem", "input", 256, (3, 3), (2, 2))
    x = helpers.inception_resnet_a(g, "resnetA", 1, 0.17, x)
    f = helpers.facenet_inception(g, "face", x, c1x1=8, c3x3_reduce=8, c3x3=8,
                                  c5x5_reduce=4, c5x5=8, pool_proj=8,
                                  pool_type=pkg.PoolingType.AVG)
    x = helpers.reduction_a(g, "reduceA", x)
    x = helpers.inception_resnet_b(g, "resnetB", 1, 0.10, x, width=896)
    x = helpers.reduction_b(g, "reduceB", x)
    x = helpers.inception_resnet_c(g, "resnetC", 1, 0.20, x, width=1792)
    g.add_layer("avgpool", pkg.GlobalPoolingLayer(pooling_type=pkg.PoolingType.AVG), x)
    g.add_layer("facepool", pkg.GlobalPoolingLayer(pooling_type=pkg.PoolingType.AVG), f)
    g.add_vertex("both", pkg.MergeVertex(), "avgpool", "facepool")
    g.add_layer("bottleneck", pkg.DenseLayer(n_out=16, activation="identity"), "both")
    g.add_vertex("embeddings", pkg.L2NormalizeVertex(), "bottleneck")
    g.add_layer("lossLayer", pkg.CenterLossOutputLayer(
        n_out=5, activation="softmax", loss="mcxent", alpha=0.9, lambda_=1e-2),
        "embeddings")
    g.set_outputs("lossLayer")
    conf = g.build()
    _mask_max_pools(conf)
    return conf


def _mask_max_pools(conf):
    """"mask", the JAX package's CPU max pool, for every max pool: windows
    of ReLU outputs tie at 0 (the port's "auto" is "sns")."""
    for node in conf.nodes.values():
        if node.is_layer() and type(node.layer).__name__ == "SubsamplingLayer" and \
                node.layer.pooling_type.name == "MAX":
            node.layer.pooling_impl = "mask"


def test_helpers_build_the_reference_graph():
    mine, theirs = _helper_graph(port, port_helpers), _helper_graph(ref, ref_helpers)
    assert json.loads(mine.to_json()) == json.loads(theirs.to_json())
    assert mine.topo_order == theirs.topo_order
    got, want = _node_types(mine), _node_types(theirs)
    assert {n: _hwc(t) for n, t in got.items()} == {n: _hwc(t) for n, t in want.items()}
    assert port_helpers.name_layer("resnetA", "b1", 3) == "resnetA-b1-3"
    # conv_bn: the conv takes the activation, the BN decay .995 / eps 1e-3
    cnn, bn = mine.nodes["stem-cnn"].layer, mine.nodes["stem-bn"].layer
    assert (cnn.activation, bn.activation, bn.decay, bn.eps) == ("relu", "identity",
                                                                 0.995, 1e-3)
    assert mine.nodes["resnetA-shortcut-1"].inputs == ["stem-bn", "resnetA-scale-1"]
    assert mine.nodes["resnetA-scale-1"].vertex.scale_factor == 0.17
    assert [_hwc(got[n]) for n in ("stem-bn", "resnetA-shortcut-1", "reduceA",
                                   "resnetB-shortcut-1", "reduceB",
                                   "resnetC-shortcut-1", "face")] == \
        [(8, 8, 256, None), (8, 8, 256, None), (4, 4, 896, None), (4, 4, 896, None),
         (2, 2, 1792, None), (2, 2, 1792, None), (8, 8, 32, None)]


def _data(n, hw, classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _assert_leaves(got, want, rtol, what):
    lg = port_params.tree_leaves(got)
    lw = jax.tree_util.tree_leaves(want)
    assert len(lg) == len(lw), what
    for i, (a, b) in enumerate(zip(lg, lw)):
        assert _rel(a, np.asarray(b)) < rtol, (what, i, _rel(a, np.asarray(b)))


def test_mini_face_graph_matches_reference():
    conf = _helper_graph(ref, ref_helpers)
    net = port.ComputationGraph(_helper_graph(port, port_helpers)).init(device="cpu")
    ref_net = _carry(net, conf)
    x, y = _data(8, 16, 5, seed=31)
    for step in range(2):
        net.fit(x, y, batch_size=8)
        ref_net.fit(x, y, batch_size=8, use_async=False)
        np.testing.assert_allclose(float(net.score_value), float(ref_net.score_value),
                                   rtol=1e-5)
        for what, mine, theirs in (("params", net.params_tree, ref_net.params_tree),
                                   ("RmsProp", net.opt_state, ref_net.opt_state),
                                   ("BN state", net.state_tree, ref_net.state_tree)):
            _assert_leaves(port_params.params_to_numpy(mine), theirs, 1e-4,
                           f"{what} after step {step + 1}")
    np.testing.assert_allclose(net.output(x), np.asarray(ref_net.output(x)), rtol=1e-5,
                               atol=1e-7)


# ------------------------------------------------------------ the zoo models

ZOO = {"InceptionResNetV1": (64, 7), "FaceNetNN4Small2": (96, 9)}
# a fit step's new BN state against the JAX package's, of each leaf's largest
# value: the whole train-mode forward's rounding, seen at 2.7e-5 and 1.4e-3
FIT_STATE_TOL = {"FaceNetNN4Small2": 1e-4, "InceptionResNetV1": 3e-3}


@pytest.fixture(scope="module", params=sorted(ZOO))
def zoo_pair(request):
    """(name, the port's network at init, the JAX package's network on the
    same trees, (x, y), and the JAX package's train-mode forward of x:
    every node's activation, the new layer state and the score)."""
    name = request.param
    hw, labels = ZOO[name]
    kw = dict(num_labels=labels, input_shape=(hw, hw, 3))
    mine, theirs = getattr(port_zoo, name)(**kw).conf(), getattr(ref_zoo, name)(**kw).conf()
    assert json.loads(mine.to_json()) == json.loads(theirs.to_json())
    assert mine.topo_order == theirs.topo_order
    _mask_max_pools(mine)
    net = port.ComputationGraph(mine).init(device="cpu")
    ref_net = _carry(net, theirs)
    x, y = _data(2, hw, labels, seed=41)

    def train_forward(p, st, a, b):
        acts, new_state, _, _ = ref_net._walk(p, st, {"input": a}, True, None, {})
        loss, _ = ref_net._loss_pure(p, st, {"input": a}, {"lossLayer": b}, {}, {},
                                     None, True)
        return acts, new_state, loss

    ref = jax.jit(train_forward)(ref_net.params_tree, ref_net.state_tree,
                                 jnp.asarray(x), jnp.asarray(y))
    return name, net, ref_net, (x, y), ref


def test_zoo_face_model_shapes_match_reference(zoo_pair):
    name, net, ref_net, _, _ = zoo_pair
    got, want = _node_types(net.conf), _node_types(ref_net.conf)
    assert {n: _hwc(t) for n, t in got.items()} == {n: _hwc(t) for n, t in want.items()}
    kinds = [type(n.layer if n.is_layer() else n.vertex).__name__
             for n in net.conf.nodes.values()]
    assert kinds[-3:] == ["DenseLayer", "L2NormalizeVertex", "CenterLossOutputLayer"]
    assert net.params_tree["lossLayer"]["cW"].shape == (ZOO[name][1], 128)
    assert net.num_params() == ref_net.num_params()


def test_zoo_face_model_nodes_match_reference_one_by_one(zoo_pair):
    """Train mode: each node from the JAX package's activations of its
    inputs, and each BN node's new state."""
    _, net, _, _, (acts, state, _) = zoo_pair
    assert net.iteration == 0
    worst = 0.0
    with torch.no_grad():
        for name in net.conf.topo_order:
            node = net.conf.nodes[name]
            ins = [torch.from_numpy(np.array(acts[i])) for i in node.inputs]
            if node.is_layer():
                y, st = node.layer.forward_with_state(
                    net.params_tree[name], net.state_tree[name], ins[0], train=True)
                for k, v in st.items():
                    want = np.asarray(state[name][k])
                    # single-pass variance: E[x^2] - E[x]^2 of conv outputs
                    # whose mean is several of their standard deviations
                    assert np.abs(v.numpy() - want).max() <= 1e-5 * np.abs(want).max(), \
                        (name, k)
            else:
                y = node.vertex.forward(ins, train=True, masks=[None] * len(ins))
            want = np.asarray(acts[name])
            err = np.abs(y.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-5, (name, err)
            worst = max(worst, err)
    assert worst > 0.0   # the comparison saw float32 rounding, not a copy


def test_zoo_face_model_fit_step_matches_reference(zoo_pair):
    """One `fit` step: its score is the train-mode loss before the update,
    and it commits the train-mode forward's new BN state; both against the
    JAX package's train-mode forward (its own step computes them so)."""
    name, net, ref_net, (x, y), (_, state, loss) = zoo_pair
    assert net.iteration == 0
    if name == "FaceNetNN4Small2":
        np.testing.assert_allclose(net.output(x), np.asarray(ref_net.output(x)),
                                   rtol=1e-5, atol=1e-7)
    net.fit(x, y, batch_size=2)
    assert net.iteration == 1
    np.testing.assert_allclose(float(net.score_value), float(loss), rtol=2e-4)
    got = port_params.state_to_numpy(net.state_tree)
    assert {n for n, st in got.items() if st} == {n for n, st in state.items() if st}
    for n, st in got.items():
        for k, v in st.items():
            want = np.asarray(state[n][k])
            assert np.abs(v - want).max() <= FIT_STATE_TOL[name] * np.abs(want).max(), \
                (n, k)
