"""Truncated BPTT, `rnn_time_step` and the recurrent carry of the torch
port's MultiLayerNetwork and ComputationGraph against the JAX package's.

- `fit` under TRUNCATED_BPTT with T = 10 and windows of 4 (4, 4 and a
  partial 2), features and labels masks, Adam and l2: after every window
  the score, parameters and Adam state equal the JAX package's (rtol 1e-4,
  atol 1e-6), as an MLN (GravesLSTM + LSTM + RnnOutputLayer) and as a graph
  (the same layers as nodes); the carry is detached between windows and
  dropped after the batch.
- Rank-2 labels under TRUNCATED_BPTT warn once and train as standard BPTT
  (the same parameters as a STANDARD configuration, and as the JAX
  package's, rtol 1e-5).
- `rnn_time_step` one step at a time and in chunks of 3 and 4 equals the
  JAX package's and `output` on the whole sequence (rtol 1e-5, atol 1e-6),
  on both network types.
- Another batch size raises RnnStateMismatchError (a ValueError) after
  resetting the carry; the bidirectional LSTM and attention raise
  NotImplementedError; `rnn_clear_previous_state` resets the carry, and
  `state_tree` (and so a checkpoint's state.npz) never holds h or c.
"""
import io
import logging
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.utils import model_serializer as port_ser
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref

B, T, F, C, L = 3, 10, 5, 3, 4


def _mln_conf(pkg, backprop="TRUNCATED_BPTT", tail="rnn"):
    b = (pkg.NeuralNetConfiguration.builder().seed(7)
         .updater(pkg.Adam(learning_rate=1e-2)).l2(1e-3).list()
         .layer(pkg.GravesLSTM(n_out=6, activation="tanh"))
         .layer(pkg.LSTM(n_out=4, activation="tanh")))
    if tail == "rnn":
        b.layer(pkg.RnnOutputLayer(n_out=C, activation="softmax", loss="mcxent"))
    else:   # rank-2 labels: pool over time first
        b.layer(pkg.GlobalPoolingLayer(pooling_type=pkg.PoolingType.AVG))
        b.layer(pkg.OutputLayer(n_out=C, activation="softmax", loss="mcxent"))
    return (b.set_input_type(pkg.InputType.recurrent(F))
            .backprop_type(getattr(pkg.BackpropType, backprop))
            .tbptt_fwd_length(L).tbptt_back_length(L).build())


def _graph_conf(pkg):
    g = (pkg.NeuralNetConfiguration.builder().seed(8)
         .updater(pkg.Adam(learning_rate=1e-2)).l2(1e-3).graph_builder())
    g.add_inputs("in")
    g.set_input_types(pkg.InputType.recurrent(F))
    g.add_layer("l1", pkg.GravesLSTM(n_out=6, activation="tanh"), "in")
    g.add_layer("l2", pkg.LSTM(n_out=4, activation="tanh"), "l1")
    g.add_layer("out", pkg.RnnOutputLayer(n_out=C, activation="softmax",
                                          loss="mcxent"), "l2")
    g.set_outputs("out")
    g.backprop_type(pkg.BackpropType.TRUNCATED_BPTT)
    g.tbptt_fwd_length(L)
    g.tbptt_back_length(L)
    return g.build()


def _data(seed=0, t=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, t, F)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, t))]
    fm = np.ones((B, t), np.float32)
    fm[1, t - 3:] = 0.0
    lm = fm.copy()
    lm[2, 1] = 0.0
    return x, y, fm, lm


def _carry_into(ref_net, port_net):
    """The JAX network takes the port network's parameters and Adam state."""
    to = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    ref_net.params_tree = to(port_params.params_to_numpy(port_net.params_tree))
    ref_net.opt_state = to(port_params.opt_state_to_numpy(port_net.opt_state))
    return ref_net


class _Recorder:
    def __init__(self, port_side):
        self.port_side, self.steps = port_side, []

    def iteration_done(self, model, iteration):
        if self.port_side:
            snap = (port_params.params_to_numpy(model.params_tree),
                    port_params.opt_state_to_numpy(model.opt_state))
            carry = model._rnn_carry
            leaves = port_params.tree_leaves(carry)
            assert leaves and all(t.grad_fn is None and not t.requires_grad
                                  for t in leaves)
        else:
            snap = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                          (model.params_tree, model.opt_state))
        self.steps.append((iteration, float(model.score_value)) + snap)


def _assert_steps_match(got, want, rtol=1e-4, atol=1e-6):
    assert [s[0] for s in got] == [s[0] for s in want]
    for (it, s_got, *trees_got), (_, s_want, *trees_want) in zip(got, want):
        np.testing.assert_allclose(s_got, s_want, rtol=rtol, err_msg=f"score {it}")
        for what, g, w in zip(("params", "Adam"), trees_got, trees_want):
            lg, lw = port_params.tree_leaves(g), jax.tree_util.tree_leaves(w)
            assert len(lg) == len(lw)
            for i, (a, b) in enumerate(zip(lg, lw)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                                           err_msg=f"{what} leaf {i} after step {it}")


def _no_carry_in_state(tree):
    layers = tree.values() if isinstance(tree, dict) else tree
    return all(not ({"h", "c"} & set(st)) for st in layers)


def test_mln_tbptt_matches_reference_after_every_window():
    net = port.MultiLayerNetwork(_mln_conf(port)).init(device="cpu")
    ref_net = _carry_into(ref.MultiLayerNetwork(_mln_conf(ref)).init(), net)
    x, y, fm, lm = _data()
    mine, theirs = _Recorder(True), _Recorder(False)
    net.listeners.append(mine)
    ref_net.listeners.append(theirs)
    net.fit(port.DataSet(x, y, fm, lm), batch_size=B)
    ref_net._fit_batch(ref.DataSet(x, y, fm, lm))
    assert net.iteration == ref_net.iteration == 3   # windows 4, 4, 2
    _assert_steps_match(mine.steps, theirs.steps)
    assert net._rnn_carry is None and _no_carry_in_state(net.state_tree)


def test_graph_tbptt_matches_reference_after_every_window():
    net = port.ComputationGraph(_graph_conf(port)).init(device="cpu")
    ref_net = _carry_into(ref.ComputationGraph(_graph_conf(ref)).init(), net)
    x, y, fm, lm = _data(seed=1)
    mine, theirs = _Recorder(True), _Recorder(False)
    net.listeners.append(mine)
    ref_net.listeners.append(theirs)
    net.fit(port.MultiDataSet([x], [y], [fm], [lm]), batch_size=B)
    ref_net.fit_batch(ref.MultiDataSet([x], [y], [fm], [lm]))
    assert net.iteration == ref_net.iteration == 3
    _assert_steps_match(mine.steps, theirs.steps)
    assert net._rnn_carry is None and _no_carry_in_state(net.state_tree)


def test_rank2_labels_warn_and_run_standard_bptt(caplog):
    net = port.MultiLayerNetwork(_mln_conf(port, tail="pool")).init(device="cpu")
    std = port.MultiLayerNetwork(_mln_conf(port, "STANDARD", "pool")).init(device="cpu")
    ref_net = _carry_into(ref.MultiLayerNetwork(_mln_conf(ref, tail="pool")).init(), net)
    x, _, _, _ = _data(seed=2)
    y = np.eye(C, dtype=np.float32)[[0, 2, 1]]
    with caplog.at_level(logging.WARNING):
        net.fit(x, y, batch_size=B, epochs=2)
    warned = [r for r in caplog.records if "rank-3" in r.getMessage()]
    assert len(warned) == 1   # once
    std.fit(x, y, batch_size=B, epochs=2)
    ref_net._fit_batch(ref.DataSet(x, y))
    ref_net._fit_batch(ref.DataSet(x, y))
    assert net.iteration == std.iteration == ref_net.iteration == 2
    for a, b, c in zip(port_params.tree_leaves(net.params_tree),
                       port_params.tree_leaves(std.params_tree),
                       jax.tree_util.tree_leaves(ref_net.params_tree)):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5, atol=1e-7)


def _streamed(step, x, chunks):
    out, s = [], 0
    for n in chunks:
        part = step(x[:, s] if n == 0 else x[:, s:s + n])
        out.append(part[:, None] if n == 0 else part)
        s += max(n, 1)
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("chunks", [[0] * T, [3, 4, 3]], ids=["steps", "chunks"])
def test_mln_rnn_time_step_matches_reference(chunks):
    net = port.MultiLayerNetwork(_mln_conf(port)).init(device="cpu")
    ref_net = _carry_into(ref.MultiLayerNetwork(_mln_conf(ref)).init(), net)
    x = _data(seed=3)[0]
    got = _streamed(net.rnn_time_step, x, chunks)
    want = _streamed(lambda a: np.asarray(ref_net.rnn_time_step(a)), x, chunks)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, net.output(x), rtol=1e-5, atol=1e-6)
    assert _no_carry_in_state(net.state_tree) and net._rnn_carry is not None
    net.rnn_clear_previous_state()
    assert net._rnn_carry is None
    np.testing.assert_allclose(net.rnn_time_step(x[:, 0]), got[:, 0], rtol=1e-6)


@pytest.mark.parametrize("chunks", [[0] * T, [3, 4, 3]], ids=["steps", "chunks"])
def test_graph_rnn_time_step_matches_reference(chunks):
    net = port.ComputationGraph(_graph_conf(port)).init(device="cpu")
    ref_net = _carry_into(ref.ComputationGraph(_graph_conf(ref)).init(), net)
    x = _data(seed=4)[0]
    got = _streamed(lambda a: net.rnn_time_step(a)[0], x, chunks)
    want = _streamed(lambda a: np.asarray(ref_net.rnn_time_step(a)[0]), x, chunks)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, net.output(x), rtol=1e-5, atol=1e-6)
    assert _no_carry_in_state(net.state_tree)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_batch_mismatch_raises_and_resets_the_carry(kind):
    net = (port.MultiLayerNetwork(_mln_conf(port)) if kind == "mln" else
           port.ComputationGraph(_graph_conf(port))).init(device="cpu")
    step = net.rnn_time_step if kind == "mln" else (lambda a: net.rnn_time_step(a)[0])
    x = _data(seed=5)[0]
    step(x[:, 0])
    with pytest.raises(port.RnnStateMismatchError, match="has been reset") as e:
        step(x[:2, 1])
    assert isinstance(e.value, ValueError)
    assert net._rnn_carry is None
    # the next caller starts from zeros
    np.testing.assert_allclose(step(x[:2, 1]), net.output(x[:2, 1:2])[:, 0],
                               rtol=1e-6)


def _streaming_confs(pkg):
    bi = (pkg.NeuralNetConfiguration.builder().seed(1).list()
          .layer(pkg.GravesBidirectionalLSTM(n_out=4, activation="tanh"))
          .layer(pkg.RnnOutputLayer(n_out=C, activation="softmax", loss="mcxent"))
          .set_input_type(pkg.InputType.recurrent(F)).build())
    att = (pkg.NeuralNetConfiguration.builder().seed(1).list()
           .layer(pkg.SelfAttentionLayer(n_out=4, n_heads=2))
           .layer(pkg.RnnOutputLayer(n_out=C, activation="softmax", loss="mcxent"))
           .set_input_type(pkg.InputType.recurrent(F)).build())
    g = pkg.NeuralNetConfiguration.builder().seed(1).graph_builder()
    g.add_inputs("in")
    g.set_input_types(pkg.InputType.recurrent(F))
    g.add_layer("bi", pkg.GravesBidirectionalLSTM(n_out=4, activation="tanh"), "in")
    g.add_layer("out", pkg.RnnOutputLayer(n_out=C, activation="softmax",
                                          loss="mcxent"), "bi")
    g.set_outputs("out")
    return {"bidirectional": bi, "attention": att, "graph_bidirectional": g.build()}


@pytest.mark.parametrize("which", ["bidirectional", "attention", "graph_bidirectional"])
def test_full_sequence_layers_refuse_streaming(which):
    conf = _streaming_confs(port)[which]
    net = (port.ComputationGraph if which.startswith("graph") else
           port.MultiLayerNetwork)(conf).init(device="cpu")
    with pytest.raises(NotImplementedError, match="rnn_time_step"):
        net.rnn_time_step(_data()[0])
    assert net._rnn_carry is None


def test_state_tree_and_checkpoint_never_hold_the_carry(tmp_path):
    net = port.MultiLayerNetwork(_mln_conf(port)).init(device="cpu")
    x, y, fm, lm = _data(seed=6)
    net.rnn_time_step(x[:, :3])
    assert set(net._rnn_carry[0]) == {"h", "c"} and net._rnn_carry[2] == {}
    assert _no_carry_in_state(net.state_tree)
    path = str(tmp_path / "rnn.zip")
    port_ser.save_model(net, path)
    with zipfile.ZipFile(path) as zf, np.load(io.BytesIO(
            zf.read(port_ser.STATE_ENTRY))) as z:
        assert [k for k in z.files if k != "__dtypes__"] == []
    # fit drops a streaming carry, as the JAX package's does
    net.fit(port.DataSet(x[:, :L], y[:, :L]), batch_size=B)
    assert net._rnn_carry is None
    net.rnn_time_step(x[:, 0])
    port_ser.load_checkpoint_state(net, path)
    assert net._rnn_carry is None
