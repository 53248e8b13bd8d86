"""BatchNormalization and the layer-state tree of the torch port against
the JAX package.

- The layer's forward, train and eval, on CNN (NHWC), FF and RNN input, in
  float32 and bfloat16, from the same parameters and the same non-trivial
  running state: outputs and new state. float32 outputs within rtol 1e-6
  (atol 1e-6 of the largest output: the batch mean is summed in another
  order), bfloat16 outputs within one bfloat16 ulp; the state is float32 in
  both types, within rtol 1e-6.
- `lock_gamma_beta`, and gradients through the layer in train mode (1e-5
  relative norm).
- An MLN conv -> BN -> ReLU -> max pool -> output trained 3 `fit` steps
  from the same parameters: parameters, Adam state and BN state after each
  step (1e-5, relative or of the largest value in the layer); `score` and
  `compute_gradient_and_score` run on the running statistics and leave them
  as they are; `feed_forward(train=True)` normalizes by the batch and
  discards its new state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet

BF16_ULP = 2.0 ** -7   # the spacing of bfloat16 values, relative, at most
SHAPES = {"cnn": (4, 5, 6, 7), "ff": (16, 7), "rnn": (3, 5, 7)}


def _bn_case(kind, seed=0):
    """x with a mean far from 0 (so the pivot matters), gamma/beta and a
    running state that is not the initial one."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[kind]
    c = shape[-1]
    x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    params = {"gamma": (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32),
              "beta": (0.2 * rng.standard_normal(c)).astype(np.float32)}
    state = {"mean": (2.5 + 0.5 * rng.standard_normal(c)).astype(np.float32),
             "var": (3.0 + rng.random(c)).astype(np.float32)}
    return x, params, state


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _layers(**kw):
    return (port.BatchNormalization(n_out=7, activation="tanh", **kw),
            ref.BatchNormalization(n_out=7, activation="tanh", **kw))


def _run_both(kind, dtype, train, lock=False):
    x, params, state = _bn_case(kind)
    if dtype == "bfloat16":
        x = _bf16(x)
        params = {k: _bf16(v) for k, v in params.items()}
    if lock:
        params = {}
    pl, rl = _layers(lock_gamma_beta=lock)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    got, got_state = pl.forward_with_state(
        {k: torch.tensor(v).to(tdt) for k, v in params.items()},
        {k: torch.tensor(v) for k, v in state.items()},
        torch.tensor(x).to(tdt), train=train)
    want, want_state = rl.forward(
        {k: jnp.asarray(v, jdt) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(x, jdt), train=train)
    assert got.dtype == tdt and want.dtype == jdt
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            {k: v.numpy() for k, v in got_state.items()},
            {k: np.asarray(v) for k, v in want_state.items()}, state)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["cnn", "ff", "rnn"])
def test_forward_and_state_match_reference(kind, dtype, train):
    got, want, got_state, want_state, before = _run_both(kind, dtype, train)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    else:  # one rounding of float32 values that differ by their sum order
        assert (np.abs(got - want) <= BF16_ULP * np.abs(want)).all()
    for k in ("mean", "var"):
        assert got_state[k].dtype == np.float32 == want_state[k].dtype
        np.testing.assert_allclose(got_state[k], want_state[k], rtol=1e-6)
        if not train:   # evaluation leaves the running statistics as they are
            np.testing.assert_array_equal(got_state[k], before[k])


def test_lock_gamma_beta():
    pl, rl = _layers(lock_gamma_beta=True)
    assert not pl.has_params() and pl.init_params(torch.Generator()) == {}
    for train in (True, False):
        got, want, got_state, want_state, _ = _run_both("cnn", "float32", train,
                                                        lock=True)
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        np.testing.assert_allclose(got_state["var"], want_state["var"], rtol=1e-6)


def test_init_state_is_float32_and_forward_needs_it():
    layer = port.BatchNormalization(n_out=3)
    st = layer.init_state(torch.bfloat16)
    assert st["mean"].dtype == st["var"].dtype == torch.float32
    assert torch.equal(st["mean"], torch.zeros(3)) and torch.equal(st["var"], torch.ones(3))
    assert layer.param_reg("gamma") == (0.0, 0.0)
    with pytest.raises(TypeError, match="forward_with_state"):
        layer.forward(layer.init_params(torch.Generator()), torch.zeros(2, 3))


def _rel_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("kind", ["cnn", "ff"])
def test_gradients_in_train_mode_match_reference(kind):
    x, params, state = _bn_case(kind, seed=1)
    g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    pl, rl = _layers()
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    out, _ = pl.forward_with_state(pt, {k: torch.from_numpy(v) for k, v in state.items()},
                                   xt, train=True)
    (out * torch.from_numpy(g)).sum().backward()

    def f(p, xx):
        y, _ = rl.forward(p, {k: jnp.asarray(v) for k, v in state.items()}, xx,
                          train=True)
        return jnp.sum(y * g)

    want_p, want_x = jax.grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    assert _rel_err(xt.grad.numpy(), np.asarray(want_x)) < 1e-5
    for k in params:
        assert _rel_err(pt[k].grad.numpy(), np.asarray(want_p[k])) < 1e-5, k


# ------------------------------------------------------- the network's state

def _cnn_conf(pkg):
    return (pkg.NeuralNetConfiguration.builder()
            .seed(21)
            .weight_init(pkg.WeightInit.XAVIER)
            .updater(pkg.Adam(learning_rate=1e-2))
            .l2(1e-4)
            .list()
            .layer(pkg.ConvolutionLayer(kernel_size=(3, 3), n_out=6,
                                        convolution_mode=pkg.ConvolutionMode.SAME))
            .layer(pkg.BatchNormalization(decay=0.8))
            .layer(pkg.ActivationLayer(activation="relu"))
            .layer(pkg.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type=pkg.PoolingType.MAX,
                                        pooling_impl="mask"))
            .layer(pkg.OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.convolutional(10, 10, 3))
            .build())


def _data(n, seed=31):
    rng = np.random.default_rng(seed)
    # a mean away from 0, as images' are
    x = (0.5 + rng.standard_normal((n, 10, 10, 3))).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _ref_net(port_net):
    net = ref.MultiLayerNetwork(_cnn_conf(ref)).init()
    net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    net.opt_state = jax.tree_util.tree_map(
        jnp.asarray, port_params.opt_state_to_numpy(port_net.opt_state))
    net.state_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.state_to_numpy(port_net.state_tree))
    return net


class _Recorder:
    def __init__(self, port_side):
        self.port_side = port_side
        self.steps = []

    def iteration_done(self, model, iteration):
        if self.port_side:
            trees = (port_params.params_to_numpy(model.params_tree),
                     port_params.opt_state_to_numpy(model.opt_state),
                     port_params.state_to_numpy(model.state_tree))
        else:
            trees = tuple(jax.tree_util.tree_map(lambda a: np.array(a, copy=True), t)
                          for t in (model.params_tree, model.opt_state,
                                    model.state_tree))
        self.steps.append((iteration, float(model.score_value)) + trees)


def _assert_trees_close(got, want, what, tol=1e-5):
    """Every leaf within `tol` relative, or `tol` of the largest value in
    its layer: a train-mode BN takes the mean out of the cotangent of the
    layers below it, so their gradients carry the cancellation of float32
    sums in another order, and the bias of the conv feeding it has a
    gradient that is 0 but for rounding (8e-9 apart at 1e-2 of its
    layer's largest Adam moment)."""
    assert len(got) == len(want), what
    for i, (gl, wl) in enumerate(zip(got, want)):
        flat_g, tree_g = jax.tree_util.tree_flatten(gl)
        flat_w, tree_w = jax.tree_util.tree_flatten(wl)
        assert tree_g == tree_w, (what, i)
        scale = max((float(np.abs(w).max()) for w in flat_w), default=0.0)
        for j, (g, w) in enumerate(zip(flat_g, flat_w)):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                       err_msg=f"{what} layer {i} leaf {j}")


def test_mln_three_fit_steps_match_reference_with_state():
    port_net = port.MultiLayerNetwork(_cnn_conf(port)).init(device="cpu")
    assert [sorted(s) for s in port_net.state_tree] == \
        [[], ["mean", "var"], [], [], []]
    ref_net = _ref_net(port_net)
    x, y = _data(12)
    port_rec, ref_rec = _Recorder(True), _Recorder(False)
    port_net.listeners.append(port_rec)
    ref_net.listeners.append(ref_rec)
    port_net.fit(x, y, batch_size=4)
    ref_net.fit(x, y, batch_size=4, use_async=False)
    assert len(port_rec.steps) == len(ref_rec.steps) == 3
    for (pi, ps, pp, po, pst), (ri, rs, rp, ro, rst) in zip(port_rec.steps,
                                                           ref_rec.steps):
        assert pi == ri
        np.testing.assert_allclose(ps, rs, rtol=1e-5)
        _assert_trees_close(pp, rp, f"params {pi}")
        _assert_trees_close(po, ro, f"Adam {pi}")
        _assert_trees_close(pst, rst, f"BN state {pi}")
    # the running statistics moved and stay float32, off the autograd graph
    mean = port_net.state_tree[1]["mean"]
    assert mean.dtype == torch.float32 and not mean.requires_grad and mean.abs().sum() > 0
    # evaluation on the trained running statistics
    np.testing.assert_allclose(port_net.output(x), np.asarray(ref_net.output(x)),
                               rtol=1e-5, atol=1e-7)


def test_score_and_gradients_use_the_running_statistics():
    port_net = port.MultiLayerNetwork(_cnn_conf(port)).init(device="cpu")
    x, y = _data(8, seed=32)
    port_net.fit(x, y, batch_size=8)   # running statistics away from (0, 1)
    ref_net = _ref_net(port_net)
    before = [dict(s) for s in port_net.state_tree]
    np.testing.assert_allclose(port_net.score(x=x, y=y), ref_net.score(x=x, y=y),
                               rtol=1e-5)
    grads, s = port_net.compute_gradient_and_score(DataSet(x, y))
    want_g, want_s = ref_net.compute_gradient_and_score(RefDataSet(x, y))
    np.testing.assert_allclose(s, want_s, rtol=1e-5)
    got_g = port_params.params_to_numpy(grads)
    for gl, wl in zip(got_g, want_g):
        for k in wl:
            assert _rel_err(gl[k], np.asarray(wl[k])) < 1e-5, k
    # neither call, nor output or feed_forward, moved the state
    port_net.output(x)
    acts = port_net.feed_forward(x, train=True)
    want_acts = ref_net.feed_forward(x, train=True)
    np.testing.assert_allclose(acts[2], np.asarray(want_acts[2]), rtol=1e-5,
                               atol=1e-6)
    for st, b in zip(port_net.state_tree, before):
        for k in b:
            assert st[k] is b[k]
    # eval-mode activations differ from train-mode ones: the score used the
    # running statistics, not the batch's
    assert not np.allclose(port_net.feed_forward(x)[2], acts[2])
