"""The port's ParallelWrapper against the JAX package's.

The cases of tests/test_parallel.py (sync data parallelism, padding, local
SGD, both network types, truncated BPTT) run through both wrappers from
the same parameters on the same batches: the JAX wrapper on its virtual
CPU devices, the port's on a mesh that lists the CPU once per shard.
Parameters (and updater state where the JAX test checks it) must agree
within rtol 1e-4 and atol 1e-5, the JAX tests' own tolerance (rtol 2e-4
where they allow it, for local SGD and truncated BPTT)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as RefMultiDataSet
from deeplearning4j_tpu.parallel import ParallelWrapper as RefWrapper
from deeplearning4j_tpu.parallel import data_parallel_mesh as ref_mesh
import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.nn.conf.builders import BackpropType as PortBPT
from deeplearning4j_tpu.nn.conf.builders import BackpropType as RefBPT
from deeplearning4j_torch.parallel import ParallelWrapper, mesh as port_mesh
from deeplearning4j_torch.utils import params as port_params
from test_torch_word2vec import one_torch_thread  # noqa: F401

SEQ, BATCH, NIN, NCLS = 12, 16, 6, 6


def cpu_mesh(w):
    return port_mesh.data_parallel_mesh(devices=["cpu"] * w)


def mlp_conf(pkg, seed=7, updater=None, bn=False):
    b = (pkg.NeuralNetConfiguration.builder().seed(seed)
         .updater(updater or pkg.Sgd(0.1)).list())
    if bn:
        b = b.layer(pkg.BatchNormalization())
    return (b.layer(pkg.DenseLayer(n_out=16, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(8)).build())


def graph_conf(pkg, seed=1):
    return (pkg.NeuralNetConfiguration.builder().seed(seed)
            .updater(pkg.Adam(0.01)).graph_builder()
            .add_inputs("in")
            .add_layer("d", pkg.DenseLayer(n_out=16, activation="relu"), "in")
            .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(pkg.InputType.feed_forward(8)).build())


def rnn_conf(pkg, bpt, seed=11, updater=None):
    return (pkg.NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or pkg.Sgd(0.1)).list()
            .layer(pkg.GravesLSTM(n_out=10, activation="tanh"))
            .layer(pkg.RnnOutputLayer(n_out=NCLS, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(NIN))
            .backprop_type(bpt.TRUNCATED_BPTT)
            .tbptt_fwd_length(5).tbptt_back_length(5).build())


def graph_rnn_conf(pkg, bpt, seed=12, updater=None):
    return (pkg.NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or pkg.Sgd(0.1)).graph_builder()
            .add_inputs("in")
            .add_layer("lstm", pkg.GravesLSTM(n_out=10, activation="tanh"), "in")
            .add_layer("out", pkg.RnnOutputLayer(n_out=NCLS, activation="softmax",
                                                 loss="mcxent"), "lstm")
            .set_outputs("out")
            .set_input_types(pkg.InputType.recurrent(NIN))
            .backprop_type(bpt.TRUNCATED_BPTT)
            .tbptt_fwd_length(5).tbptt_back_length(5).build())


def twins(make_conf, graph=False):
    """(JAX network, port network) holding the port's initial parameters
    and updater state."""
    net_cls = (ref.ComputationGraph, port.ComputationGraph) if graph else \
        (ref.MultiLayerNetwork, port.MultiLayerNetwork)
    p = net_cls[1](make_conf(port)).init(device="cpu")
    r = net_cls[0](make_conf(ref)).init()
    to = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    r.params_tree = to(port_params.params_to_numpy(p.params_tree))
    r.opt_state = to(port_params.opt_state_to_numpy(p.opt_state))
    return r, p


def data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=n)]
    return x, y


def rnn_data(seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, NIN, (batch, SEQ))
    x = np.eye(NIN, dtype=np.float32)[idx]
    y = np.eye(NCLS, dtype=np.float32)[np.roll(idx, -1, axis=1) % NCLS]
    return x, y


def assert_trees_close(ref_tree, port_tree, rtol=1e-4, atol=1e-5,
                       conv=port_params.params_to_numpy):
    got = jax.tree_util.tree_leaves(conv(port_tree))
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, ref_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Sync data parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 8])
def test_dp_equals_jax_wrapper(w):
    """Sync DP over W shards: the JAX wrapper (W virtual devices) and the
    port's (W shards on the CPU) take the same five steps."""
    x, y = data(64)
    r, p = twins(mlp_conf)
    rw, pw = RefWrapper(r, mesh=ref_mesh(w)), ParallelWrapper(p, mesh=cpu_mesh(w))
    for _ in range(5):
        rw.fit_batch(RefDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
    assert p.iteration == r.iteration == 5
    assert_trees_close(r.params_tree, p.params_tree)
    np.testing.assert_allclose(float(p.score_value), float(r.score_value),
                               rtol=1e-5)


def test_dp_equals_single_device_with_bn_and_dropout():
    """The port's sync step is the global-batch step: BatchNormalization's
    statistics over the whole batch and dropout's global mask included,
    so 8 shards match the plain step to float rounding."""
    x, y = data(64, seed=3)
    make = lambda: port.MultiLayerNetwork(
        (port.NeuralNetConfiguration.builder().seed(5).updater(port.Adam(0.01))
         .list().layer(port.BatchNormalization())
         .layer(port.DenseLayer(n_out=16, activation="relu", dropout_rate=0.3))
         .layer(port.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
         .set_input_type(port.InputType.feed_forward(8)).build())
    ).init(device="cpu")
    single, dp = make(), make()
    pw = ParallelWrapper(dp, mesh=cpu_mesh(8))
    for _ in range(4):
        single._fit_batch(DataSet(x, y))
        pw.fit_batch(DataSet(x, y))
    for a, b in zip(port_params.tree_leaves(single.params_tree) +
                    port_params.tree_leaves(single.state_tree),
                    port_params.tree_leaves(dp.params_tree) +
                    port_params.tree_leaves(dp.state_tree)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


def test_bn_sync_equals_jax_wrapper():
    x, y = data(64, seed=4)
    r, p = twins(lambda pkg: mlp_conf(pkg, bn=True))
    rw, pw = RefWrapper(r, mesh=ref_mesh(4)), ParallelWrapper(p, mesh=cpu_mesh(4))
    for _ in range(3):
        rw.fit_batch(RefDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
    assert_trees_close(r.params_tree, p.params_tree)
    assert_trees_close(r.state_tree, p.state_tree,
                       conv=port_params.state_to_numpy)


def test_dp_with_adam_learns_as_jax():
    x, y = data(128)
    r, p = twins(lambda pkg: mlp_conf(pkg, updater=pkg.Adam(0.01)))
    rw, pw = RefWrapper(r, mesh=ref_mesh(4)), ParallelWrapper(p, mesh=cpu_mesh(4))
    s0 = None
    for i in range(10):
        rw.fit_batch(RefDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
        if i == 0:
            s0 = float(p.score_value)
    assert float(p.score_value) < s0
    assert_trees_close(r.params_tree, p.params_tree)
    assert_trees_close(r.opt_state, p.opt_state,
                       conv=port_params.opt_state_to_numpy)


def test_fit_iterator_api_and_step_hooks():
    x, y = data(64)
    r, p = twins(mlp_conf)
    RefWrapper.builder(r).workers(8).build().fit(RefDataSet(x, y), epochs=2,
                                                 batch_size=32)
    pw = ParallelWrapper.builder(p).mesh(cpu_mesh(8)).prefetch_buffer(4).build()
    seen = []
    pw.step_hooks.append(seen.append)
    pw.fit(DataSet(x, y), epochs=2, batch_size=32)
    assert p.iteration == r.iteration == 4 and p.epoch == r.epoch == 2
    assert seen == [1, 2, 3, 4]
    assert_trees_close(r.params_tree, p.params_tree)


def test_graph_dp_fit_equals_jax():
    x, y = data(64)
    r, p = twins(graph_conf, graph=True)
    RefWrapper(r, mesh=ref_mesh(8)).fit(RefDataSet(x, y), epochs=3,
                                        batch_size=32)
    ParallelWrapper(p, mesh=cpu_mesh(8)).fit(DataSet(x, y), epochs=3,
                                             batch_size=32)
    assert p.iteration == r.iteration == 6
    assert_trees_close(r.params_tree, p.params_tree)


@pytest.mark.parametrize("n", [30, 37])
def test_padding_uneven_batch_equals_jax(n):
    """Pad rows carry zero loss weight, so an indivisible batch trains as
    the JAX wrapper's (and the single device's) does."""
    x, y = data(n)
    r, p = twins(mlp_conf)
    rw, pw = RefWrapper(r, mesh=ref_mesh(8)), ParallelWrapper(p, mesh=cpu_mesh(8))
    single = port.MultiLayerNetwork(mlp_conf(port)).init(device="cpu")
    for _ in range(4):
        rw.fit_batch(RefDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
        single._fit_batch(DataSet(x, y))
    assert p.iteration == 4 and np.isfinite(float(p.score_value))
    assert_trees_close(r.params_tree, p.params_tree, rtol=1e-5, atol=1e-6)
    assert_trees_close(port_params.params_to_numpy(single.params_tree),
                       p.params_tree, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Local SGD
# ---------------------------------------------------------------------------

def test_local_sgd_matches_jax_wrapper():
    W, F, rounds = 4, 3, 6
    x, y = data(32, seed=3)
    r, p = twins(lambda pkg: mlp_conf(pkg, updater=pkg.Nesterovs(
        0.05, momentum=0.9)))
    rw = RefWrapper(r, mesh=ref_mesh(W), averaging_frequency=F)
    pw = ParallelWrapper(p, mesh=cpu_mesh(W), averaging_frequency=F)
    for _ in range(rounds):
        rw.fit_batch(RefDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
    assert p.iteration == r.iteration == rounds
    assert_trees_close(r.params_tree, p.params_tree, rtol=2e-4)
    assert_trees_close(r.opt_state, p.opt_state, rtol=2e-4,
                       conv=port_params.opt_state_to_numpy)


def test_local_sgd_matches_manual_replicas_bitwise():
    """Each replica is an independent network on its shard, averaged every
    F steps: the port's wrapper is bitwise that manual loop."""
    W, F = 4, 3
    x, y = data(32, seed=3)
    conf = lambda: mlp_conf(port, updater=port.Nesterovs(0.05, momentum=0.9))
    nets = [port.MultiLayerNetwork(conf()).init(device="cpu") for _ in range(W)]
    for rnd in range(6):
        for i, n in enumerate(nets):
            n._fit_batch(DataSet(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8]))
        if (rnd + 1) % F == 0:
            for key in ("params_tree", "opt_state"):
                leaves = [port_params.tree_leaves(getattr(n, key)) for n in nets]
                avg = [torch.stack(ts).mean(0) for ts in zip(*leaves)]
                for n in nets:
                    setattr(n, key, port_params.tree_unflatten(
                        getattr(n, key), [a.clone() for a in avg]))
    local = port.MultiLayerNetwork(conf()).init(device="cpu")
    pw = ParallelWrapper(local, mesh=cpu_mesh(W), averaging_frequency=F)
    for _ in range(6):
        pw.fit_batch(DataSet(x, y))
    for a, b in zip(port_params.tree_leaves(nets[0].params_tree),
                    port_params.tree_leaves(local.params_tree)):
        assert torch.equal(a, b)


def test_local_sgd_uneven_batch_and_finalize():
    x, y = data(30, seed=5)
    net = port.MultiLayerNetwork(mlp_conf(port, updater=port.Adam(0.01))
                                 ).init(device="cpu")
    pw = ParallelWrapper(net, mesh=cpu_mesh(8), averaging_frequency=4)
    pw.fit(DataSet(x, y), epochs=5, batch_size=30)
    assert net.iteration == 5 and np.isfinite(float(net.score_value))
    assert pw._since_avg == 0  # fit's finalize averaged the partial window
    pw.shutdown()
    assert pw._replicas is None


def test_local_sgd_graph_matches_jax():
    x, y = data(64, seed=9)
    r, p = twins(graph_conf, graph=True)
    rw = RefWrapper(r, mesh=ref_mesh(4), averaging_frequency=2)
    pw = ParallelWrapper(p, mesh=cpu_mesh(4), averaging_frequency=2)
    s0 = None
    for i in range(6):
        rw.fit_batch(RefDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
        if i == 0:
            s0 = float(p.score_value)
    rw.finalize()
    pw.finalize()
    assert float(p.score_value) < s0
    assert_trees_close(r.params_tree, p.params_tree, rtol=2e-4)


# ---------------------------------------------------------------------------
# Truncated BPTT
# ---------------------------------------------------------------------------

def test_graph_tbptt_sync_dp_matches_jax():
    x, y = rnn_data()
    r, p = twins(lambda pkg: graph_rnn_conf(
        pkg, RefBPT if pkg is ref else PortBPT), graph=True)
    rw, pw = RefWrapper(r, mesh=ref_mesh(8)), ParallelWrapper(p, mesh=cpu_mesh(8))
    for _ in range(3):
        rw.fit_batch(RefMultiDataSet([x], [y]))
        pw.fit_batch(MultiDataSet([x], [y]))
    assert p.iteration == r.iteration == 9
    assert_trees_close(r.params_tree, p.params_tree, rtol=2e-4)


def test_mln_tbptt_sync_dp_matches_jax():
    x, y = rnn_data(seed=1)
    r, p = twins(lambda pkg: rnn_conf(pkg, RefBPT if pkg is ref else PortBPT))
    rw, pw = RefWrapper(r, mesh=ref_mesh(8)), ParallelWrapper(p, mesh=cpu_mesh(8))
    for _ in range(3):
        rw.fit_batch(RefDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
    assert p.iteration == r.iteration == 9
    assert_trees_close(r.params_tree, p.params_tree, rtol=2e-4)


def test_tbptt_indivisible_batch_rejected():
    x, y = rnn_data(seed=3, batch=15)
    net = port.MultiLayerNetwork(rnn_conf(port, PortBPT)).init(device="cpu")
    for freq in (1, 2):
        pw = ParallelWrapper(net, mesh=cpu_mesh(8), averaging_frequency=freq)
        with pytest.raises(ValueError, match="must divide"):
            pw.fit_batch(DataSet(x, y))
    assert net.iteration == 0


def test_graph_tbptt_local_sgd_matches_jax():
    W, F = 4, 2
    x, y = rnn_data(seed=4)
    upd = lambda pkg: pkg.Nesterovs(0.05, momentum=0.9)
    r, p = twins(lambda pkg: graph_rnn_conf(
        pkg, RefBPT if pkg is ref else PortBPT, seed=13, updater=upd(pkg)),
        graph=True)
    rw = RefWrapper(r, mesh=ref_mesh(W), averaging_frequency=F)
    pw = ParallelWrapper(p, mesh=cpu_mesh(W), averaging_frequency=F)
    for _ in range(2):
        rw.fit_batch(RefMultiDataSet([x], [y]))
        pw.fit_batch(MultiDataSet([x], [y]))
    assert p.iteration == r.iteration == 6
    assert_trees_close(r.params_tree, p.params_tree, rtol=5e-4, atol=2e-5)


def test_mln_tbptt_local_sgd_keeps_each_replicas_carry():
    """Local SGD over truncated-BPTT windows against the manual loop: each
    replica runs the window schedule on its shard with its own carry, and
    the parameters average every F windows (the carry never)."""
    W, F, chunk = 4, 2, BATCH // 4
    x, y = rnn_data(seed=2)
    conf = lambda: rnn_conf(port, PortBPT, updater=port.Nesterovs(
        0.05, momentum=0.9))
    nets = [port.MultiLayerNetwork(conf()).init(device="cpu") for _ in range(W)]
    steps = 0
    for _ in range(2):
        for n in nets:
            n.rnn_clear_previous_state()
            n._seed_recurrent_states(chunk)
        for start in range(0, SEQ, 5):
            for i, n in enumerate(nets):
                n._do_step(x[i * chunk:(i + 1) * chunk, start:start + 5],
                           y[i * chunk:(i + 1) * chunk, start:start + 5],
                           None, None)
            steps += 1
            if steps % F == 0:
                for key in ("params_tree", "opt_state"):
                    leaves = [port_params.tree_leaves(getattr(n, key))
                              for n in nets]
                    avg = [torch.stack(ts).mean(0) for ts in zip(*leaves)]
                    for n in nets:
                        setattr(n, key, port_params.tree_unflatten(
                            getattr(n, key), [a.clone() for a in avg]))
        for n in nets:
            n.rnn_clear_previous_state()
    local = port.MultiLayerNetwork(conf()).init(device="cpu")
    pw = ParallelWrapper(local, mesh=cpu_mesh(W), averaging_frequency=F)
    for _ in range(2):
        pw.fit_batch(DataSet(x, y))
    assert local.iteration == steps
    for a, b in zip(port_params.tree_leaves(nets[0].params_tree),
                    port_params.tree_leaves(local.params_tree)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Mesh, prefetch and early stopping
# ---------------------------------------------------------------------------

def test_mesh_helpers():
    m = cpu_mesh(4)
    assert m.shape == {"data": 4} and m.size == 4
    assert not port_mesh.is_multiprocess(m)
    assert m.local_devices() == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="more than once"):
        port_mesh.data_parallel_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="'data' axis"):
        ParallelWrapper(None, mesh=port_mesh.create_mesh(
            [2], ("model",), ["cpu", "cpu"]))
    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    padded, n = port_mesh.pad_batch_to_multiple(a, 4)
    assert n == 5 and padded.shape == (8, 2) and (padded[5:] == a[-1]).all()
    parts = port_mesh.shard_batch(m, {"x": padded})["x"]
    assert [tuple(t.shape) for t in parts] == [(2, 2)] * 4
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.shard_batch(m, a)
    reps = port_mesh.replicate(m, {"w": torch.ones(2)})
    assert list(reps) == [torch.device("cpu")]
    assert port_mesh.batch_sharded(m).device == torch.device("cpu")


def test_sharded_device_prefetch_stages_divisible_batches():
    from deeplearning4j_torch.data.iterators import (DevicePrefetchIterator,
                                                     ExistingDataSetIterator)
    x, y = data(12)
    base = ExistingDataSetIterator([DataSet(x[:8], y[:8]),
                                    DataSet(x[8:], y[8:])])
    it = DevicePrefetchIterator(base, sharding=port_mesh.batch_sharded(
        cpu_mesh(8)), batch_divisor=8)
    got = list(it)
    it.shutdown()
    assert isinstance(got[0].features, torch.Tensor)
    assert isinstance(got[1].features, np.ndarray)  # 4 rows: left on the host


def test_early_stopping_parallel_trainer():
    from deeplearning4j_torch import earlystopping as es
    x, y = data(64, seed=8)
    net = port.MultiLayerNetwork(mlp_conf(port, updater=port.Adam(0.01))
                                 ).init(device="cpu")
    conf = (es.EarlyStoppingConfiguration.builder()
            .epoch_termination_conditions(es.MaxEpochsTerminationCondition(3))
            .score_calculator(lambda m: m.score(DataSet(x, y)))
            .model_saver(es.InMemoryModelSaver()).build())
    pw = ParallelWrapper(net, mesh=cpu_mesh(4), averaging_frequency=2)
    result = es.EarlyStoppingParallelTrainer(conf, pw, DataSet(x, y),
                                             batch_size=16).fit()
    assert result.total_epochs == 3 and net.iteration == 12
    assert pw._since_avg == 0
    assert result.best_model is not None


def test_shard_group_collectives_under_thread_pressure():
    """More shard threads than cores, a switch interval of a microsecond:
    every shard gets its own result of every collective, in order (a shard
    that overwrote another's value, or read a result of the wrong round,
    breaks the sums)."""
    import sys
    from deeplearning4j_torch.nn import shards
    n, rounds = 16, 40
    group = shards.ShardGroup(n, timeout_s=60)
    ctxs = [shards.ShardContext(i, n, i, 1, n, group) for i in range(n)]

    def body(i):
        got = []
        for r in range(rounds):
            total = group.collective(i, (i, r), lambda vs: [
                sum(v[0] for v in vs) + k + 1000 * vs[0][1] for k in range(n)])
            got.append(total)
        return got

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = shards.run(n, body, ctxs)
    finally:
        sys.setswitchinterval(old)
    base = n * (n - 1) // 2
    assert results == [[base + i + 1000 * r for r in range(rounds)]
                       for i in range(n)]


def test_a_failing_shard_breaks_the_group_and_raises():
    from deeplearning4j_torch.nn import shards
    group = shards.ShardGroup(3, timeout_s=60)
    ctxs = [shards.ShardContext(i, 3, i, 1, 3, group) for i in range(3)]

    def body(i):
        if i == 1:
            raise ValueError("shard 1 fails")
        return group.collective(i, i, lambda vs: vs)
    with pytest.raises(ValueError, match="shard 1 fails"):
        shards.run(3, body, ctxs)
