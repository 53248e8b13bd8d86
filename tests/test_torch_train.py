"""The torch port's training path against the JAX package.

- `compute_gradient_and_score` of zoo AlexNet at 60x60x3, from the same
  parameters, per layer. The JAX package's CPU max-pool backward splits ties
  ("mask") where torch's sends the cotangent to the first maximum ("sns"),
  yet the parameter gradients agree: every tied window holds zeros from a
  ReLU whose gradient is 0 there, and a zero channel adds nothing to LRN's
  cross term.
- `fit` for 3 steps (the last one ragged) of a narrow AlexNet-shaped net,
  dropout off, from the same parameters and the same non-zero optimizer
  state: parameters, optimizer state and score after every step.
- `score()`, a frozen layer, dropout's statistics and determinism, the
  max-pool tie rule against the JAX package's "sns", and that a CPU `fit`
  never reaches the CUDA kernels.

Tolerances are stated where they are used: float32 on both sides, sums in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.nn.layers.core import dropout
from deeplearning4j_torch.ops import lrn as port_lrn
from deeplearning4j_torch.ops import pooling as port_pool
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.models import zoo as ref_zoo
from deeplearning4j_tpu.ops import pooling as ref_pool


def _narrow_conf(pkg, frozen_first=False):
    """AlexNet's layer kinds, modes, updater, gradient normalization and L2
    at a few channels, dropout off."""
    return (pkg.NeuralNetConfiguration.builder()
            .seed(7)
            .weight_init(pkg.WeightInit.XAVIER)
            .activation("relu")
            .updater(pkg.Nesterovs(learning_rate=1e-2, momentum=0.9))
            .convolution_mode(pkg.ConvolutionMode.SAME)
            .gradient_normalization(
                pkg.GradientNormalization.RENORMALIZE_L2_PER_LAYER)
            .l2(5e-4)
            .list()
            .layer(pkg.ConvolutionLayer(
                kernel_size=(5, 5), stride=(2, 2), padding=(1, 1), n_out=8,
                convolution_mode=pkg.ConvolutionMode.TRUNCATE,
                frozen=frozen_first))
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
            .layer(pkg.DenseLayer(n_out=24))
            .layer(pkg.OutputLayer(n_out=5, activation="softmax",
                                   loss="negativeloglikelihood"))
            .set_input_type(pkg.InputType.convolutional(33, 33, 3))
            .build())


def _data(n, shape, classes, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _ref_net(conf, port_net, init=False):
    """A JAX-package network holding the port network's parameters and
    optimizer state (carried with params_to_numpy/opt_state_to_numpy)."""
    net = ref.MultiLayerNetwork(conf)
    if init:
        net.init()
    else:
        net.state_tree = tuple(l.init_state() for l in net.layers)
        net._build_jitted()
        net._initialized = True
    net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    net.opt_state = jax.tree_util.tree_map(
        jnp.asarray, port_params.opt_state_to_numpy(port_net.opt_state))
    return net


def _rel_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_alexnet_60px_gradients_match_reference_per_layer():
    port_net = port_zoo.AlexNet(input_shape=(60, 60, 3),
                                num_labels=10).init(device="cpu")
    ref_net = _ref_net(ref_zoo.AlexNet(input_shape=(60, 60, 3),
                                       num_labels=10).conf(), port_net)
    x, y = _data(2, (60, 60, 3), 10)
    got_g, got_s = port_net.compute_gradient_and_score(DataSet(x, y))
    # what ref_net.compute_gradient_and_score computes (value_and_grad of
    # _loss_pure, no rng, train=False), jitted: eager it compiles op by op
    (want_s, _), want_g = jax.jit(lambda p, a, b: jax.value_and_grad(
        ref_net._loss_pure, has_aux=True)(p, ref_net.state_tree, a, b, None,
                                          None, None, False))(
        ref_net.params_tree, jnp.asarray(x), jnp.asarray(y))
    want_s = float(want_s)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    got_g = port_params.params_to_numpy(got_g)
    assert [sorted(l) for l in got_g] == [sorted(l) for l in want_g]
    for i, (gl, wl) in enumerate(zip(got_g, want_g)):
        for k in wl:
            # relative norm of the difference, per parameter: float32 convs
            # and matmuls summed in another order
            assert _rel_err(gl[k], np.asarray(wl[k])) < 1e-4, (i, k)


def _random_opt_state(net, seed):
    """The net's optimizer-state structure filled with small random values,
    so the carried state is not just zeros."""
    rng = np.random.default_rng(seed)
    tree = port_params.opt_state_to_numpy(net.opt_state)
    filled = tuple({k: tuple(rng.standard_normal(a.shape).astype(np.float32)
                             * 1e-3 for a in s)
                    if isinstance(s, tuple) else
                    rng.standard_normal(s.shape).astype(np.float32) * 1e-3
                    for k, s in layer.items()} for layer in tree)
    return port_params.opt_state_from_numpy(filled, device="cpu")


class _Recorder:
    def __init__(self, to_numpy):
        self.to_numpy = to_numpy
        self.steps = []

    def iteration_done(self, model, iteration):
        self.steps.append((iteration, float(model.score_value))
                          + self.to_numpy(model))


def _ref_snapshot(model):
    copy = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, copy=True), t)
    return copy(model.params_tree), copy(model.opt_state)


def _port_snapshot(model):
    return (port_params.params_to_numpy(model.params_tree),
            port_params.opt_state_to_numpy(model.opt_state))


def _assert_trees_close(got, want, rtol, atol, what):
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    assert tree_g == tree_w, what
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} leaf {i}")


def test_fit_three_steps_matches_reference():
    port_net = port.MultiLayerNetwork(_narrow_conf(port)).init(device="cpu")
    port_net.opt_state = _random_opt_state(port_net, seed=5)
    ref_net = _ref_net(_narrow_conf(ref), port_net, init=True)
    x, y = _data(7, (33, 33, 3), 5)  # batches of 3, 3 and a ragged 1
    port_rec, ref_rec = _Recorder(_port_snapshot), _Recorder(_ref_snapshot)
    port_net.listeners.append(port_rec)
    ref_net.listeners.append(ref_rec)
    before = port_lrn.launches, port_lrn.bwd_launches
    port_net.fit(x, y, batch_size=3)
    ref_net.fit(x, y, batch_size=3, use_async=False)
    assert (port_lrn.launches, port_lrn.bwd_launches) == before
    assert len(port_rec.steps) == len(ref_rec.steps) == 3
    assert port_net.iteration == ref_net.iteration == 3
    assert port_net.epoch == ref_net.epoch == 1
    for (pi, ps, pp, po), (ri, rs, rp, ro) in zip(port_rec.steps, ref_rec.steps):
        assert pi == ri
        np.testing.assert_allclose(ps, rs, rtol=1e-5)
        # params O(0.1-1) differ by up to 3e-8, the Nesterov velocities
        # (O(lr) = 1e-2) by up to 2.2e-9 on the CPU: float32 sums in
        # another order
        _assert_trees_close(pp, rp, rtol=1e-5, atol=1e-7, what=f"params {pi}")
        _assert_trees_close(po, ro, rtol=1e-5, atol=1e-8, what=f"opt {pi}")
    # and score() on the trained parameters, with and without data
    np.testing.assert_allclose(port_net.score(x=x, y=y),
                               ref_net.score(x=x, y=y), rtol=1e-5)
    np.testing.assert_allclose(port_net.score(DataSet(x, y)),
                               ref_net.score(RefDataSet(x, y)), rtol=1e-5)
    assert port_net.score() == pytest.approx(ps)


def test_frozen_layer_stays_put():
    net = port.MultiLayerNetwork(_narrow_conf(port, frozen_first=True)
                                 ).init(device="cpu")
    net.opt_state = _random_opt_state(net, seed=6)
    w0 = {k: v.clone() for k, v in net.params_tree[0].items()}
    s0 = {k: v.clone() for k, v in net.opt_state[0].items()}
    w3 = net.params_tree[3]["W"].clone()
    x, y = _data(4, (33, 33, 3), 5)
    net.fit(x, y, batch_size=2)
    for k in w0:
        assert torch.equal(net.params_tree[0][k], w0[k])
        assert torch.equal(net.opt_state[0][k], s0[k])
    assert not torch.equal(net.params_tree[3]["W"], w3)


def test_dropout_statistics_and_determinism():
    x = torch.full((400, 500), 3.0)
    gen = torch.Generator().manual_seed(1)
    y = dropout(x, 0.5, True, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    assert torch.all(y[kept] == 6.0)  # inverted: x / keep
    again = dropout(x, 0.5, True, torch.Generator().manual_seed(1))
    assert torch.equal(y, again)
    assert not torch.equal(y, dropout(x, 0.5, True, gen))
    y3 = dropout(x, 0.3, True, torch.Generator().manual_seed(2))
    assert abs((y3 != 0).float().mean().item() - 0.7) < 0.01
    assert dropout(x, 0.5, False, gen) is x
    assert dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.5, True, None)
    # a whole fit with dropout on is a function of the seed
    nets = [port_zoo.AlexNet(input_shape=(60, 60, 3), num_labels=10
                             ).init(device="cpu", seed=9) for _ in range(3)]
    nets[2]._dropout_gen.manual_seed(10)
    x, y = _data(2, (60, 60, 3), 10)
    for n in nets:
        n.fit(x, y, batch_size=2)
    w = [n.params_tree[11]["W"] for n in nets]
    assert torch.equal(w[0], w[1])
    assert not torch.equal(w[0], w[2])


def test_max_pool_tie_rule_matches_reference_sns():
    rng = np.random.default_rng(3)
    # small integers: many tied maxima in every window
    x = rng.integers(0, 3, (2, 9, 9, 4)).astype(np.float32)
    g = rng.standard_normal((2, 5, 5, 4)).astype(np.float32)
    pads = ((1, 1), (1, 1))
    y, vjp = jax.vjp(lambda v: ref_pool.max_pool(v, (3, 3), (2, 2), pads,
                                                 impl="sns"), jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = port_pool.max_pool(xt, (3, 3), (2, 2), pads)
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    yt.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # "mask" splits the ties instead (the JAX package's CPU default),
    # which on these windows gives another gradient
    y, vjp = jax.vjp(lambda v: ref_pool.max_pool(v, (3, 3), (2, 2), pads,
                                                 impl="mask"), jnp.asarray(x))
    want_mask, = vjp(jnp.asarray(g))
    xm = torch.from_numpy(x).requires_grad_()
    port_pool.max_pool(xm, (3, 3), (2, 2), pads, impl="mask").backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(xm.grad.numpy(), np.asarray(want_mask),
                               rtol=1e-6, atol=1e-6)
    assert not np.allclose(xm.grad.numpy(), xt.grad.numpy())
    with pytest.raises(ValueError):
        port_pool.max_pool(xt, (3, 3), (2, 2), pads, impl="conv")


def _dense_conf(pkg, head):
    return (pkg.NeuralNetConfiguration.builder()
            .seed(3)
            .weight_init(pkg.WeightInit.XAVIER)
            .updater(pkg.Adam(learning_rate=1e-2))
            .l1(1e-3)
            .list()
            .layer(pkg.DenseLayer(n_out=6, activation="tanh"))
            .layer(head(pkg))
            .set_input_type(pkg.InputType.feed_forward(5))
            .build())


@pytest.mark.parametrize("head", [
    lambda pkg: pkg.OutputLayer(n_out=4, activation="sigmoid", loss="xent"),
    lambda pkg: pkg.LossLayer(activation="identity", loss="mse")
    if pkg is port else ref.nn.layers.core.LossLayer(activation="identity",
                                                     loss="mse"),
], ids=["output_xent", "loss_layer_mse"])
def test_output_heads_score_and_gradients_match_reference(head):
    port_net = port.MultiLayerNetwork(_dense_conf(port, head)).init(device="cpu")
    ref_net = _ref_net(_dense_conf(ref, head), port_net)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    out_w = 4 if isinstance(port_net.layers[-1], port.OutputLayer) else 6
    y = (rng.random((7, out_w)) < 0.5).astype(np.float32)
    got_g, got_s = port_net.compute_gradient_and_score(DataSet(x, y))
    want_g, want_s = ref_net.compute_gradient_and_score(RefDataSet(x, y))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    for gl, wl in zip(port_params.params_to_numpy(got_g), want_g):
        assert sorted(gl) == sorted(wl)
        for k in wl:
            np.testing.assert_allclose(gl[k], np.asarray(wl[k]), rtol=1e-5,
                                       atol=1e-7)
    # the per-example score of the head, on the last hidden activations
    h = port_net.feed_forward(x)[-2]
    got_sa = port_net.layers[-1].compute_score_array(
        port_net.params_tree[-1], torch.from_numpy(h), torch.from_numpy(y))
    want_sa = ref_net.layers[-1].compute_score_array(
        ref_net.params_tree[-1], jnp.asarray(h), jnp.asarray(y))
    np.testing.assert_allclose(got_sa.numpy(), np.asarray(want_sa), rtol=1e-5,
                               atol=1e-6)


def test_opt_state_round_trip_is_bitwise():
    net = port.MultiLayerNetwork(_narrow_conf(port)).init(device="cpu")
    state = _random_opt_state(net, seed=8)
    back = port_params.opt_state_from_numpy(
        port_params.opt_state_to_numpy(state), device="cpu")
    for a, b, p in zip(state, back, net.params_tree):
        assert sorted(a) == sorted(b) == sorted(p)
        for k in a:
            assert torch.equal(a[k], b[k])
            assert b[k].shape == p[k].shape
    # conv kernels' state is OIHW in the port and HWIO in the JAX package
    assert port_params.opt_state_to_numpy(state)[0]["W"].shape == (5, 5, 3, 8)
    assert state[0]["W"].shape == (8, 3, 5, 5)
