"""The port's whole `fit` loop against the JAX package's.

From the same parameters and optimizer state, on the same numpy batches:

- `fit` with the defaults on both sides (pad to bucket, device prefetch) on
  a BatchNormalization network whose last batch is ragged: parameters,
  optimizer state and BN state after 6 steps. The pad rows enter BN's batch
  statistics in both packages; without padding the port's state differs.
- `steps_per_dispatch` groups (MultiLayerNetwork, ComputationGraph and a
  truncated-BPTT LSTM), `fit_batches` and `fit_batch_repeated`: bitwise the
  port's own single steps, and the JAX package's parameters and listener
  numbering.
- The argument checks, the etl attributes, the spans and the metrics.

Tolerance: rtol 1e-5 / atol 1e-7 on parameters and state, float32 on both
sides with sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.optimize import metrics as port_metrics
from deeplearning4j_torch.optimize import tracing as port_tracing
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as RefMultiDataSet

RTOL, ATOL = 1e-5, 1e-7


def _bn_conf(pkg, updater=None):
    return (pkg.NeuralNetConfiguration.builder()
            .seed(3)
            .updater(updater or pkg.Nesterovs(learning_rate=0.05, momentum=0.9))
            .list()
            .layer(pkg.BatchNormalization())
            .layer(pkg.DenseLayer(n_out=8, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(5))
            .build())


def _lstm_conf(pkg):
    return (pkg.NeuralNetConfiguration.builder()
            .seed(4)
            .updater(pkg.Sgd(learning_rate=0.1))
            .list()
            .layer(pkg.LSTM(n_in=3, n_out=6, activation="tanh"))
            .layer(pkg.RnnOutputLayer(n_in=6, n_out=2, activation="softmax",
                                      loss="mcxent"))
            .backprop_type(pkg.BackpropType.TRUNCATED_BPTT)
            .tbptt_fwd_length(3)
            .tbptt_back_length(3)
            .build())


def _graph_conf(pkg):
    return (pkg.NeuralNetConfiguration.builder()
            .seed(5)
            .updater(pkg.Adam(learning_rate=0.01))
            .graph_builder()
            .add_inputs("in")
            .add_layer("d1", pkg.DenseLayer(n_in=5, n_out=7, activation="relu"), "in")
            .add_layer("d2", pkg.DenseLayer(n_in=5, n_out=7, activation="tanh"), "in")
            .add_vertex("m", pkg.MergeVertex(), "d1", "d2")
            .add_layer("out", pkg.OutputLayer(n_in=14, n_out=3, activation="softmax",
                                              loss="mcxent"), "m")
            .set_outputs("out")
            .build())


def _data(n, seed=1, features=5, classes=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, features)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _seq(n, t, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (n, t))]
    return x, y


def _conv(tree, fn):
    return jax.tree_util.tree_map(jnp.asarray, fn(tree))


def _ref_of(port_net, ref_net):
    """`ref_net` (constructed, not initialized) holding the port network's
    parameters, optimizer state and layer state."""
    ref_net.params_tree = _conv(port_net.params_tree, port_params.params_to_numpy)
    ref_net.opt_state = _conv(port_net.opt_state, port_params.opt_state_to_numpy)
    ref_net.state_tree = _conv(port_net.state_tree, port_params.state_to_numpy)
    ref_net._rng = jax.random.PRNGKey(0)
    ref_net._build_jitted()
    ref_net._initialized = True
    return ref_net


def _assert_close(port_tree, ref_tree, what, to_numpy=port_params.params_to_numpy):
    got = jax.tree_util.tree_leaves(to_numpy(port_tree))
    want = jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} leaf {i}")


def _assert_equal_trees(a, b):
    la, lb = port_params.tree_leaves(a), port_params.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


class _Events:
    def __init__(self):
        self.events = []

    def iteration_done(self, model, iteration):
        self.events.append((iteration, float(model.score_value)))


def _port_mln(conf_fn=_bn_conf):
    return port.MultiLayerNetwork(conf_fn(port)).init(device="cpu")


def test_fit_defaults_match_reference_on_a_ragged_bn_tail():
    x, y = _data(10)  # batch 4: 4, 4 and a ragged 2, padded to 4
    port_net = _port_mln()
    ref_net = _ref_of(port_net, ref.MultiLayerNetwork(_bn_conf(ref)))
    unpadded = _port_mln()
    port_net.fit(x, y, epochs=2, batch_size=4)
    ref_net.fit(x, y, epochs=2, batch_size=4)
    unpadded.fit(x, y, epochs=2, batch_size=4, pad_to_bucket=False)
    assert port_net.iteration == ref_net.iteration == 6
    assert port_net.epoch == ref_net.epoch == 2
    _assert_close(port_net.params_tree, ref_net.params_tree, "params")
    _assert_close(port_net.opt_state, ref_net.opt_state, "opt")
    _assert_close(port_net.state_tree, ref_net.state_tree, "bn state",
                  port_params.state_to_numpy)
    np.testing.assert_allclose(float(port_net.score_value),
                               float(ref_net.score_value), rtol=RTOL)
    # the ragged tail's 2 pad rows move BN's running statistics
    mean_pad = port_net.state_tree[0]["mean"]
    assert not torch.allclose(mean_pad, unpadded.state_tree[0]["mean"],
                              rtol=1e-3, atol=0)


@pytest.mark.parametrize("prefetch_to_device", [True, False])
@pytest.mark.parametrize("use_async", [True, False])
def test_pipelines_are_bitwise_the_same(use_async, prefetch_to_device):
    x, y = _data(11, seed=7)
    nets = [_port_mln() for _ in range(2)]
    nets[0].fit(x, y, epochs=2, batch_size=4)
    nets[1].fit(x, y, epochs=2, batch_size=4, use_async=use_async,
                prefetch_to_device=prefetch_to_device)
    _assert_equal_trees(nets[0].params_tree, nets[1].params_tree)
    _assert_equal_trees(nets[0].state_tree, nets[1].state_tree)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_steps_per_dispatch_matches_single_steps_and_reference(kind):
    x, y = _data(14, seed=9)   # batch 4: 4, 4, 4, 2 -> padded, one group of 3
    if kind == "mln":
        make = lambda: _port_mln()
        ref_net = _ref_of(make(), ref.MultiLayerNetwork(_bn_conf(ref)))
    else:
        make = lambda: port.ComputationGraph(_graph_conf(port)).init(device="cpu")
        ref_net = _ref_of(make(), ref.ComputationGraph(_graph_conf(ref)))
    grouped, single = make(), make()
    ev_g, ev_s, ev_r = _Events(), _Events(), _Events()
    grouped.listeners.append(ev_g)
    single.listeners.append(ev_s)
    ref_net.listeners.append(ev_r)
    grouped.fit(x, y, batch_size=4, steps_per_dispatch=3)
    single.fit(x, y, batch_size=4)
    ref_net.fit(x, y, batch_size=4, steps_per_dispatch=3)
    _assert_equal_trees(grouped.params_tree, single.params_tree)
    _assert_equal_trees(grouped.opt_state, single.opt_state)
    assert ev_g.events == ev_s.events
    assert [i for i, _ in ev_g.events] == [i for i, _ in ev_r.events] == [1, 2, 3, 4]
    np.testing.assert_allclose([s for _, s in ev_g.events],
                               [s for _, s in ev_r.events], rtol=RTOL)
    _assert_close(grouped.params_tree, ref_net.params_tree, "params")


def test_tbptt_groups_and_repeats_match_reference():
    x, y = _seq(6, 7)   # windows 3, 3, 1: three optimizer steps per batch
    batches = [DataSet(x[:3], y[:3]), DataSet(x[3:], y[3:])]
    ref_batches = [RefDataSet(b.features, b.labels) for b in batches]
    make = lambda: port.MultiLayerNetwork(_lstm_conf(port)).init(device="cpu")
    grouped, single, repeated, looped = make(), make(), make(), make()
    ref_g = _ref_of(grouped, ref.MultiLayerNetwork(_lstm_conf(ref)))
    ref_r = _ref_of(grouped, ref.MultiLayerNetwork(_lstm_conf(ref)))
    evs = {k: _Events() for k in ("g", "rg", "r", "rr")}
    grouped.listeners.append(evs["g"])
    ref_g.listeners.append(evs["rg"])
    repeated.listeners.append(evs["r"])
    ref_r.listeners.append(evs["rr"])
    grouped.fit_batches(batches)
    ref_g.fit_batches(ref_batches)
    for b in batches:
        single._fit_batch(b)
    repeated.fit_batch_repeated(batches[0], 2)
    ref_r.fit_batch_repeated(ref_batches[0], 2)
    for _ in range(2):
        looped._fit_batch(batches[0])
    assert grouped.iteration == ref_g.iteration == 6
    assert repeated.iteration == ref_r.iteration == 6
    _assert_equal_trees(grouped.params_tree, single.params_tree)
    _assert_equal_trees(repeated.params_tree, looped.params_tree)
    # one listener event per batch, numbered per = windows apart
    assert [i for i, _ in evs["g"].events] == [i for i, _ in evs["rg"].events] == [3, 6]
    assert [i for i, _ in evs["r"].events] == [i for i, _ in evs["rr"].events] == [3, 6]
    for a, b in (("g", "rg"), ("r", "rr")):
        np.testing.assert_allclose([s for _, s in evs[a].events],
                                   [s for _, s in evs[b].events], rtol=RTOL)
    _assert_close(grouped.params_tree, ref_g.params_tree, "tbptt group")
    _assert_close(repeated.params_tree, ref_r.params_tree, "tbptt repeat")
    assert grouped._rnn_carry is None and repeated._rnn_carry is None


def test_tbptt_fit_with_steps_per_dispatch_matches_reference():
    x, y = _seq(8, 7, seed=5)
    port_net = port.MultiLayerNetwork(_lstm_conf(port)).init(device="cpu")
    ref_net = _ref_of(port_net, ref.MultiLayerNetwork(_lstm_conf(ref)))
    port_net.fit(x, y, batch_size=2, steps_per_dispatch=2)
    ref_net.fit(x, y, batch_size=2, steps_per_dispatch=2)
    assert port_net.iteration == ref_net.iteration == 12
    _assert_close(port_net.params_tree, ref_net.params_tree, "params")


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_batches_and_repeats_match_reference(kind):
    x, y = _data(8, seed=3)
    if kind == "mln":
        make = lambda: _port_mln()
        ref_of = lambda n: _ref_of(n, ref.MultiLayerNetwork(_bn_conf(ref)))
        batch, rbatch = (lambda a, b: DataSet(a, b)), (lambda a, b: RefDataSet(a, b))
    else:
        make = lambda: port.ComputationGraph(_graph_conf(port)).init(device="cpu")
        ref_of = lambda n: _ref_of(n, ref.ComputationGraph(_graph_conf(ref)))
        batch = lambda a, b: MultiDataSet([a], [b])
        rbatch = lambda a, b: RefMultiDataSet([a], [b])
    bs = [batch(x[i:i + 4], y[i:i + 4]) for i in (0, 4)]
    rbs = [rbatch(x[i:i + 4], y[i:i + 4]) for i in (0, 4)]
    grouped, repeated = make(), make()
    ref_g, ref_r = ref_of(grouped), ref_of(repeated)
    grouped.fit_batches(bs)
    ref_g.fit_batches(rbs)
    repeated.fit_batch_repeated(bs[0], 4)
    ref_r.fit_batch_repeated(rbs[0], 4)
    assert grouped.iteration == 2 and repeated.iteration == 4
    _assert_close(grouped.params_tree, ref_g.params_tree, "group")
    _assert_close(repeated.params_tree, ref_r.params_tree, "repeat")
    _assert_close(repeated.opt_state, ref_r.opt_state, "repeat opt",
                  port_params.opt_state_to_numpy)
    np.testing.assert_allclose(float(repeated.score_value),
                               float(ref_r.score_value), rtol=RTOL)


def test_fit_argument_checks_match_reference():
    x, y = _data(4)
    for pkg, net in (("port", _port_mln()),
                     ("ref", ref.MultiLayerNetwork(_bn_conf(ref)).init())):
        with pytest.raises(ValueError, match="custom step_fn"):
            net.fit(x, y, steps_per_dispatch=2, step_fn=lambda ds: None)
        with pytest.raises(ValueError, match="per-step hooks"):
            net.fit(x, y, steps_per_dispatch=2, sentinel=object())
        with pytest.raises(ValueError, match="resume=True"):
            net.fit(x, y, resume=True)
    graph = port.ComputationGraph(_graph_conf(port)).init(device="cpu")
    graph.conf.backprop_type = port.BackpropType.TRUNCATED_BPTT
    with pytest.raises(NotImplementedError, match="truncated BPTT"):
        graph.fit(x, y, steps_per_dispatch=2)
    with pytest.raises(NotImplementedError, match="truncated BPTT"):
        graph.fit_batches([MultiDataSet([x], [y])])
    from deeplearning4j_torch.parallel import (batch_sharded,
                                               data_parallel_mesh)
    sharded = _port_mln()
    sharded.fit(x, y, batch_size=2, prefetch_divisor=2,
                prefetch_sharding=batch_sharded(data_parallel_mesh(
                    devices=["cpu", "cpu"])))
    assert sharded.iteration == 2


def test_fit_reports_etl_spans_and_metrics():
    x, y = _data(9, seed=4)
    reg = port_metrics.registry()
    epochs0 = reg.counter("train_epochs_total").value()
    dispatch0 = reg.histogram("train_step_dispatch_ms").count
    iters0 = reg.counter("train_iterations_total").value()
    port_tracing.clear()
    port_tracing.enable(fence_every=1)
    try:
        net = _port_mln()
        net.fit(x, y, epochs=2, batch_size=4, steps_per_dispatch=2)
    finally:
        port_tracing.disable()
    names = [e["name"] for e in port_tracing.export_trace_events()["traceEvents"]]
    port_tracing.clear()
    for name in ("fit", "epoch", "step", "etl", "dispatch", "device"):
        assert name in names, name
    assert names.count("epoch") == 2 and names.count("step") == 6
    assert reg.counter("train_epochs_total").value() == epochs0 + 2
    assert reg.histogram("train_step_dispatch_ms").count == dispatch0 + 6
    assert reg.counter("train_iterations_total").value() == iters0 + 6
    assert reg.gauge("device_fence_wait_ms").value() >= 0
    assert net.last_etl_ms >= 0 and net.last_etl_h2d_ms > 0
    assert net.last_etl_host_ms >= 0
    host = _port_mln()
    host.fit(x, y, batch_size=4, use_async=False)
    assert host.last_etl_h2d_ms == 0.0 and host.last_etl_host_ms == host.last_etl_ms


def test_a_failing_batch_reraises_in_fit_and_stops_the_producer():
    class Broken(port.DataSetIterator):
        def __init__(self):
            self.i = 0

        def reset(self):
            self.i = 0

        def __next__(self):
            self.i += 1
            if self.i in (3, 4):   # the producer retries a poll once
                raise KeyError("bad batch 3")
            if self.i > 4:
                raise StopIteration
            x, y = _data(4, seed=self.i)
            return DataSet(x, y)

    net = _port_mln()
    with pytest.raises(KeyError, match="bad batch 3"):
        net.fit(Broken(), epochs=1)
    assert net.iteration == 2   # the two batches before the fault ran
