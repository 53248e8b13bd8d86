"""The port's asynchronous parameter server against the JAX package's.

The cases of tests/test_param_server.py on the CPU: the server's versioned
push/pull contract and its update through the model's updater chain (the
same gradients applied by both packages' servers give the same parameters,
rtol 1e-5), one worker at max_staleness=0 (the sequential fit, bitwise in
the port and within rtol 1e-5 of the JAX package's one-worker trainer),
several racing workers (drops, recovery, accuracy), the refusal of
stateful layers, and the HTTP node and client, across packages too (the
wire format is the JAX package's npz layout)."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as ref
from deeplearning4j_tpu.parallel import param_server as rps
import deeplearning4j_torch as port
from deeplearning4j_torch.parallel import param_server as tps
from deeplearning4j_torch.utils import params as port_params


def blobs(n=512, seed=0):
    """3-class Gaussian blobs."""
    rng = np.random.default_rng(seed)
    means = np.array([[2.0, 0.0], [-2.0, 1.5], [0.0, -2.5]], np.float32)
    x = np.concatenate([rng.normal(means[k], 0.6, (n // 3, 2))
                        for k in range(3)]).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.repeat(np.arange(3), n // 3)]
    order = rng.permutation(len(x))
    return x[order], y[order]


def conf(pkg, seed=7, lr=0.05, dropout=None):
    return (pkg.NeuralNetConfiguration.builder().seed(seed)
            .updater(pkg.Adam(lr)).list()
            .layer(pkg.DenseLayer(n_out=16, activation="relu",
                                  dropout_rate=dropout))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(2)).build())


def port_net(**kw):
    return port.MultiLayerNetwork(conf(port, **kw)).init(device="cpu")


def ref_twin(p):
    r = ref.MultiLayerNetwork(conf(ref)).init()
    to = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    r.params_tree = to(port_params.params_to_numpy(p.params_tree))
    r.opt_state = to(port_params.opt_state_to_numpy(p.opt_state))
    return r


def accuracy(net, x, y):
    return float((net.predict(x) == y.argmax(1)).mean())


def leaves_close(ref_tree, port_tree, rtol=1e-5, atol=1e-6):
    got = jax.tree_util.tree_leaves(port_params.params_to_numpy(port_tree))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            ref_tree))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_server_push_pull_contract_matches_jax():
    p = port_net()
    r = ref_twin(p)
    tsrv, rsrv = tps.ParameterServer(p, max_staleness=1), \
        rps.ParameterServer(r, max_staleness=1)
    assert tsrv.pull()[0] == rsrv.pull()[0] == 0
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        port_params.params_to_numpy(p.params_tree)) for _ in range(3)]
    got = [(tsrv.push(0, port_params.params_from_numpy(g, device="cpu")),
            rsrv.push(0, jax.tree_util.tree_map(jnp.asarray, g)))
           for g in grads]
    assert got == [(True, True), (True, True), (False, False)]
    assert tsrv.stats() == rsrv.stats() == {"version": 2, "applied": 2,
                                            "stale_drops": 1}
    leaves_close(rsrv.params, tsrv.params)
    # a pull hands out the tree as it stood: later pushes replace it
    _, before = tsrv.pull()
    tsrv.push(2, port_params.params_from_numpy(grads[0], device="cpu"))
    assert before is not tsrv.params


@pytest.mark.parametrize("dropout", [None, 0.3])
def test_one_worker_at_staleness_zero_is_the_sequential_fit(dropout):
    """One worker at max_staleness=0 applies every gradient on the newest
    parameters, in order, drawing dropout from the network's own stream:
    bitwise the network's sequential fit."""
    x, y = blobs(192, seed=3)
    seq, async_ = port_net(dropout=dropout), port_net(dropout=dropout)
    seq.fit(port.DataSet(x, y), epochs=2, batch_size=64, use_async=False,
            pad_to_bucket=False)
    tr = tps.ParameterServerTrainer(async_, workers=1, max_staleness=0)
    tr.fit(port.DataSet(x, y), epochs=2, batch_size=64)
    assert async_.iteration == seq.iteration == tr.server.applied == 6
    for a, b in zip(port_params.tree_leaves(seq.params_tree),
                    port_params.tree_leaves(async_.params_tree)):
        assert torch.equal(a, b)
    assert len(tr.timings) == 6


def test_one_worker_matches_jax_trainer():
    x, y = blobs(192, seed=4)
    p = port_net()
    r = ref_twin(p)
    tps.ParameterServerTrainer(p, workers=1, max_staleness=0).fit(
        port.DataSet(x, y), epochs=2, batch_size=64)
    rps.ParameterServerTrainer(r, workers=1, max_staleness=0).fit(
        ref.DataSet(x, y), epochs=2, batch_size=64)
    assert p.iteration == r.iteration == 6
    leaves_close(r.params_tree, p.params_tree)


def test_async_matches_sync_accuracy():
    x, y = blobs()
    sync = port_net()
    sync.fit(port.DataSet(x, y), epochs=12, batch_size=64)
    anet = port_net()
    tr = tps.ParameterServerTrainer(anet, devices=["cpu"] * 4, max_staleness=4)
    assert len(tr.devices) == 4
    tr.fit(port.DataSet(x, y), epochs=12, batch_size=64)
    assert accuracy(sync, x, y) > 0.95
    assert accuracy(anet, x, y) >= accuracy(sync, x, y) - 0.03
    assert anet.iteration == tr.server.applied > 0


def test_staleness_bound_drops_and_recovers():
    x, y = blobs(384, seed=1)
    net = port_net(seed=8)
    tr = tps.ParameterServerTrainer(net, workers=8, max_staleness=0)
    tr.fit(port.DataSet(x, y), epochs=10, batch_size=64)
    assert tr.server.stale_drops > 0
    assert tr.server.applied == net.iteration
    assert accuracy(net, x, y) > 0.9


def test_unbounded_staleness_no_drops():
    x, y = blobs(192, seed=2)
    net = port_net(seed=9)
    tr = tps.ParameterServerTrainer(net, workers=4, max_staleness=10**9)
    tr.fit(port.DataSet(x, y), epochs=4, batch_size=64)
    assert tr.server.stale_drops == 0 and tr.server.applied == 12


def test_computation_graph_trains_async():
    g = port.ComputationGraph(
        port.NeuralNetConfiguration.builder().seed(6).updater(port.Adam(0.05))
        .graph_builder().add_inputs("in")
        .add_layer("d", port.DenseLayer(n_out=16, activation="relu"), "in")
        .add_layer("out", port.OutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent"), "d")
        .set_outputs("out")
        .set_input_types(port.InputType.feed_forward(2)).build()
    ).init(device="cpu")
    x, y = blobs(384, seed=5)
    tr = tps.ParameterServerTrainer(g, workers=4, max_staleness=4)
    tr.fit(port.DataSet(x, y), epochs=10, batch_size=64)
    assert tr.server.applied == g.iteration > 0
    assert float((g.predict(x) == y.argmax(1)).mean()) > 0.9


def test_worker_errors_surface_after_the_restart_budget():
    from deeplearning4j_torch.utils import faults
    x, y = blobs(192, seed=6)
    net = port_net()
    tr = tps.ParameterServerTrainer(net, workers=2, max_worker_restarts=1)
    try:
        with faults.injected("ps.pull", "fail:*"):
            with pytest.raises(RuntimeError, match="worker failed"):
                tr.fit(port.DataSet(x, y), epochs=1, batch_size=64)
    finally:
        faults.reset()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_stateful_layers_rejected(pkg):
    m = port if pkg == "port" else ref
    c = (m.NeuralNetConfiguration.builder().updater(m.Sgd(0.1)).list()
         .layer(m.DenseLayer(n_out=4, activation="relu"))
         .layer(m.BatchNormalization())
         .layer(m.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
         .set_input_type(m.InputType.feed_forward(3)).build())
    if pkg == "port":
        net = m.MultiLayerNetwork(c).init(device="cpu")
        trainer = tps.ParameterServerTrainer
    else:
        net = m.MultiLayerNetwork(c).init()
        trainer = rps.ParameterServerTrainer
    with pytest.raises(NotImplementedError, match="stateful"):
        trainer(net)


def test_http_client_roundtrip_and_staleness():
    net = port_net()
    server = tps.ParameterServer(net, max_staleness=0)
    node = tps.ParameterServerHttpNode(server).start()
    try:
        client = tps.HttpParameterServerClient(node.url, net.params_tree)
        v0, params = client.pull()
        assert v0 == 0
        for a, b in zip(port_params.tree_leaves(params),
                        port_params.tree_leaves(net.params_tree)):
            assert torch.equal(a, b)
        zero = port_params.tree_map(torch.zeros_like, net.params_tree)
        assert client.push(0, zero)
        assert not client.push(0, zero)
        assert client.stats() == {"version": 1, "applied": 1,
                                  "stale_drops": 1}
    finally:
        node.stop()


def test_jax_client_talks_to_the_port_node():
    """The wire format is the JAX package's npz layout: the JAX client
    pulls the port node's parameters and its gradient push applies."""
    p = port_net()
    r = ref_twin(p)
    server = tps.ParameterServer(p, max_staleness=0)
    node = tps.ParameterServerHttpNode(server).start()
    try:
        client = rps.HttpParameterServerClient(node.url, r.params_tree)
        v0, params = client.pull()
        leaves_close(params, p.params_tree, rtol=0, atol=0)
        g = jax.tree_util.tree_map(lambda a: np.full(a.shape, 0.5, np.float32),
                                   r.params_tree)
        assert client.push(v0, g)
        rsrv = rps.ParameterServer(r, max_staleness=0)
        rsrv.push(0, jax.tree_util.tree_map(jnp.asarray, g))
        leaves_close(rsrv.params, server.params)
    finally:
        node.stop()


def test_remote_workers_converge_over_http():
    """Two remote workers (threads here, each its own network and HTTP
    client) push to one node; every accepted push is applied."""
    x, y = blobs(384, seed=9)
    net = port_net(lr=0.05)
    server = tps.ParameterServer(net, max_staleness=4)
    node = tps.ParameterServerHttpNode(server).start()
    counts = {}
    try:
        def work(w):
            counts[w] = tps.remote_worker_fit(
                port_net(lr=0.05), node.url, x[w::2], y[w::2], epochs=3,
                batch_size=32, seed=w)
        ts = [threading.Thread(target=work, args=(w,)) for w in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        node.stop()
    assert set(counts) == {0, 1} and min(counts.values()) > 0
    assert server.applied == sum(counts.values()) == server.version
    net.params_tree = server.params
    assert accuracy(net, x, y) > 0.9
