"""The port's SequenceParallelWrapper against the JAX package's.

The cases of tests/test_sequence_parallel.py (fit, masks, data x seq, the
3-D data x model x seq mode, truncated BPTT, padding, ComputationGraph,
inference, the refusals) run through both wrappers from the same
parameters on the same batches: the JAX wrapper on the conftest's virtual
CPU devices, the port's on a mesh that lists the CPU once per shard (one
thread per shard, the ring's hops between them). Parameters within rtol
2e-4 and atol 2e-5 after the JAX tests' step counts, as there."""
import logging

import numpy as np
import pytest
import torch

import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as RefMultiDataSet
from deeplearning4j_tpu.nn.conf.builders import BackpropType as RefBPT
from deeplearning4j_tpu.nn.layers.attention import \
    SelfAttentionLayer as RefAttention
from deeplearning4j_tpu.parallel import SequenceParallelWrapper as RefSP
from deeplearning4j_tpu.parallel import seq_parallel_mesh as ref_mesh
import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.nn.conf.builders import BackpropType as PortBPT
from deeplearning4j_torch.nn.layers.attention import \
    SelfAttentionLayer as PortAttention
from deeplearning4j_torch.ops.attention import (active_sequence_parallel,
                                                sequence_parallel)
from deeplearning4j_torch.parallel import (SequenceParallelWrapper,
                                           seq_parallel_mesh)
from deeplearning4j_torch.parallel.mesh import ShardedLeaf, gather_replicated

from test_torch_parallel_wrapper import assert_trees_close, twins

TOL = dict(rtol=2e-4, atol=2e-5)
ATTN = {ref: RefAttention, port: PortAttention}
BPT = {ref: RefBPT, port: PortBPT}


def cpu_mesh(**kw):
    return seq_parallel_mesh(devices=["cpu"] * 8, **kw)


def conf(pkg, causal=False, seed=7, heads=4, tbptt=0):
    b = (pkg.NeuralNetConfiguration.builder().seed(seed).updater(pkg.Sgd(0.1))
         .list()
         .layer(ATTN[pkg](n_out=16, n_heads=heads, causal=causal))
         .layer(pkg.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
         .set_input_type(pkg.InputType.recurrent(8)))
    if tbptt:
        b = b.backprop_type(BPT[pkg].TRUNCATED_BPTT).tbptt_fwd_length(tbptt) \
            .tbptt_back_length(tbptt)
    return b.build()


def lstm_conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(15).updater(pkg.Sgd(0.1))
            .list()
            .layer(pkg.GravesLSTM(n_out=12, activation="tanh"))
            .layer(pkg.RnnOutputLayer(n_out=3, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(8))
            .backprop_type(BPT[pkg].TRUNCATED_BPTT).tbptt_fwd_length(8)
            .tbptt_back_length(8).build())


def graph_conf(pkg, seed=9):
    return (pkg.NeuralNetConfiguration.builder().seed(seed).updater(pkg.Sgd(0.1))
            .graph_builder().add_inputs("in")
            .add_layer("att", ATTN[pkg](n_out=16, n_heads=4, causal=True), "in")
            .add_layer("out", pkg.RnnOutputLayer(n_out=3, activation="softmax",
                                                 loss="mcxent"), "att")
            .set_outputs("out").set_input_types(pkg.InputType.recurrent(8))
            .build())


def data(seed=0, n=8, T=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, T, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, T))]
    return x, y


def whole(tree):
    return gather_replicated(tree)


def both_fit(make, steps, mesh_kw, x, y, fmask=None, lmask=None):
    r, p = twins(make)
    rw = RefSP(r, ref_mesh(**mesh_kw))
    pw = SequenceParallelWrapper(p, cpu_mesh(**mesh_kw))
    for _ in range(steps):
        rw.fit_batch(RefDataSet(x, y, fmask, lmask))
        pw.fit_batch(DataSet(x, y, fmask, lmask))
    return r, p, rw, pw


@pytest.mark.parametrize("causal", [False, True])
def test_fit_matches_jax(causal):
    x, y = data()
    r, p, _, pw = both_fit(lambda pkg: conf(pkg, causal), 3, {}, x, y)
    assert pw.seq_shards == 8
    assert p.iteration == r.iteration == 3
    assert_trees_close(r.params_tree, p.params_tree, **TOL)
    np.testing.assert_allclose(float(p.score_value), float(r.score_value),
                               rtol=1e-4)


def test_fit_matches_with_mask_and_dp():
    x, y = data(seed=3)
    fmask = np.ones((8, 16), np.float32)
    fmask[:, 12:] = 0.0
    r, p, _, pw = both_fit(conf, 2, dict(data_devices=2), x, y, fmask, fmask)
    assert (pw.data_shards, pw.seq_shards) == (2, 4)
    assert_trees_close(r.params_tree, p.params_tree, **TOL)


def test_output_matches():
    x, _ = data(seed=5)
    r, p = twins(lambda pkg: conf(pkg, causal=True))
    want = RefSP(r, ref_mesh()).output(x)
    got = SequenceParallelWrapper(p, cpu_mesh()).output(x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_tbptt_windows():
    x, y = data(seed=11)
    r, p, _, _ = both_fit(lambda pkg: conf(pkg, seed=9, tbptt=8), 2, {}, x, y)
    assert p.iteration == r.iteration == 4   # 2 batches x 2 windows
    assert_trees_close(r.params_tree, p.params_tree, **TOL)


def test_tbptt_short_final_window_runs_dense():
    x, y = data(seed=12, T=12)   # windows of 8 and 4; 4 does not divide 8
    r, p, rw, pw = both_fit(lambda pkg: conf(pkg, seed=9, tbptt=8), 1, {}, x, y)
    assert p.iteration == r.iteration == 2
    assert pw._warned_window and rw._warned_window
    assert_trees_close(r.params_tree, p.params_tree, **TOL)


def test_tbptt_indivisible_window_length_rejected_up_front():
    x, y = data(seed=12)
    r, p = twins(lambda pkg: conf(pkg, seed=9, tbptt=12))
    with pytest.raises(ValueError, match="tbptt_fwd_length") as want:
        RefSP(r, ref_mesh()).fit_batch(RefDataSet(x, y))
    with pytest.raises(ValueError, match="tbptt_fwd_length") as got:
        SequenceParallelWrapper(p, cpu_mesh()).fit_batch(DataSet(x, y))
    assert str(got.value) == str(want.value)
    assert p.iteration == 0


def test_tbptt_recurrent_carry_pads_with_batch():
    """An LSTM under the seq axis runs on its row block's gathered sequence;
    7 rows over 2 data shards pad one zero-weight row, carry included."""
    x, y = data(seed=16, n=7)
    r, p, _, pw = both_fit(lstm_conf, 1, dict(data_devices=2, seq_devices=4),
                           x, y)
    assert p.iteration == r.iteration == 2
    assert pw._warned_pad
    assert_trees_close(r.params_tree, p.params_tree, **TOL)


def test_short_final_batch_pads_with_zero_weight():
    x, y = data(n=9)
    r, p = twins(conf)
    rw = RefSP(r, ref_mesh(data_devices=2))
    pw = SequenceParallelWrapper(p, cpu_mesh(data_devices=2))
    rw.fit(RefDataSet(x, y), epochs=1, batch_size=8)
    pw.fit(DataSet(x, y), epochs=1, batch_size=8)
    assert p.iteration == r.iteration == 2 and pw._warned_pad
    assert_trees_close(r.params_tree, p.params_tree, **TOL)


def test_epoch_fit_loop_and_dense_path_unpolluted():
    x, y = data()
    net = port.MultiLayerNetwork(conf(port)).init(device="cpu")
    w = SequenceParallelWrapper(net, cpu_mesh())
    w.fit(DataSet(x, y), epochs=2, batch_size=8)
    assert net.epoch == 2 and net.iteration == 2
    assert active_sequence_parallel() is None
    net._fit_batch(DataSet(x, y))   # the plain dense path
    net.output(x)


def test_indivisible_time_rejected():
    x, y = data(T=12)
    r, p = twins(conf)
    with pytest.raises(ValueError, match="divide") as want:
        RefSP(r, ref_mesh()).fit_batch(RefDataSet(x, y))
    with pytest.raises(ValueError, match="divide") as got:
        SequenceParallelWrapper(p, cpu_mesh()).fit_batch(DataSet(x, y))
    assert str(got.value) == str(want.value)


def test_three_d_fit_matches_jax_and_is_sharded():
    """Data 2 x model 2 x seq 2: parameters sharded over "model", heads
    split over it in the ring."""
    x, y = data()
    r, p, _, pw = both_fit(conf, 2, dict(data_devices=2, model_devices=2), x, y)
    assert (pw.data_shards, pw.model_shards, pw.seq_shards) == (2, 2, 2)
    wq = p.params_tree[0]["Wq"]
    assert isinstance(wq, ShardedLeaf) and wq.dim == 1 and len(wq.slices) == 2
    assert "model" in tuple(r.params_tree[0]["Wq"].sharding.spec)
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


def test_indivisible_heads_replicate(caplog):
    x, y = data(seed=9)
    make = lambda pkg: conf(pkg, causal=True, heads=2)
    PortAttention._warned_head_fallback = False
    with caplog.at_level(logging.WARNING):
        r, p, _, pw = both_fit(make, 2, dict(model_devices=4), x, y)
    assert (pw.model_shards, pw.seq_shards) == (4, 2)
    assert "attention heads replicate" in caplog.text
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


def test_graph_fit_matches_jax():
    x, y = data(seed=11)
    r, p = twins(graph_conf, graph=True)
    rw = RefSP(r, ref_mesh(data_devices=2))
    pw = SequenceParallelWrapper(p, cpu_mesh(data_devices=2))
    for _ in range(2):
        rw.fit_batch(RefMultiDataSet([x], [y]))
        pw.fit_batch(MultiDataSet([x], [y]))
    assert_trees_close(r.params_tree, p.params_tree, **TOL)


def test_graph_indivisible_batch_pads_with_zero_weight():
    x, y = data(n=7)
    r, p = twins(graph_conf, graph=True)
    rw = RefSP(r, ref_mesh(data_devices=2))
    pw = SequenceParallelWrapper(p, cpu_mesh(data_devices=2))
    rw.fit_batch(RefMultiDataSet([x], [y]))
    pw.fit_batch(MultiDataSet([x], [y]))
    assert pw._warned_pad
    assert_trees_close(r.params_tree, p.params_tree, **TOL)


def test_graph_output_matches_with_mask():
    x, _ = data(seed=15)
    fmask = np.ones((8, 16), np.float32)
    fmask[:, 12:] = 0.0
    r, p = twins(lambda pkg: graph_conf(pkg, seed=21), graph=True)
    rw, pw = RefSP(r, ref_mesh()), SequenceParallelWrapper(p, cpu_mesh())
    np.testing.assert_allclose(pw.output(x, features_mask=fmask),
                               rw.output(x, features_mask=fmask),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        pw.output(np.zeros((8, 10, 8), np.float32))


def test_graph_multi_input_outputs():
    def make(pkg):
        return (pkg.NeuralNetConfiguration.builder().seed(13)
                .updater(pkg.Sgd(0.1)).graph_builder()
                .add_inputs("seq", "static")
                .add_layer("att", ATTN[pkg](n_out=16, n_heads=4, causal=True),
                           "seq")
                .add_layer("emb", pkg.DenseLayer(n_out=4, activation="tanh"),
                           "static")
                .add_layer("out", pkg.RnnOutputLayer(
                    n_out=3, activation="softmax", loss="mcxent"), "att")
                .add_layer("out2", pkg.OutputLayer(
                    n_out=2, activation="softmax", loss="mcxent"), "emb")
                .set_outputs("out", "out2")
                .set_input_types(pkg.InputType.recurrent(8),
                                 pkg.InputType.feed_forward(6)).build())
    rng = np.random.default_rng(14)
    xs = rng.standard_normal((8, 16, 8)).astype(np.float32)
    xstat = rng.standard_normal((8, 6)).astype(np.float32)
    r, p = twins(make, graph=True)
    want = RefSP(r, ref_mesh()).outputs(xs, xstat)
    pw = SequenceParallelWrapper(p, cpu_mesh())
    got = pw.outputs(xs, xstat)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        pw.outputs(np.zeros((8, 10, 8), np.float32), xstat)


def test_layer_falls_back_when_indivisible():
    """A time axis the seq axis does not divide runs single-device attention
    under the context, as the JAX package's does."""
    x, _ = data(T=10)
    net = port.MultiLayerNetwork(conf(port)).init(device="cpu")
    want = net.output(x)
    with sequence_parallel(cpu_mesh(), "seq", None):
        with torch.no_grad():
            got = net._forward(net.params_tree, net.state_tree,
                               net._as_input(x))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_refusals():
    """Packed segments do not compose with the ring (the JAX package's
    ValueError); BatchNormalization is refused under a seq axis."""
    def packed(pkg):
        return (pkg.NeuralNetConfiguration.builder().seed(1).list()
                .layer(ATTN[pkg](n_out=16, n_heads=4, packed_segments=True))
                .layer(pkg.RnnOutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"))
                .set_input_type(pkg.InputType.recurrent(8)).build())
    x, y = data()
    seg = np.ones((8, 16), np.float32)
    r, p = twins(packed)
    with pytest.raises(ValueError, match="packed_segments"):
        RefSP(r, ref_mesh()).fit_batch(RefDataSet(x, y, seg))
    with pytest.raises(ValueError, match="packed_segments"):
        SequenceParallelWrapper(p, cpu_mesh()).fit_batch(DataSet(x, y, seg))
    bn = (port.NeuralNetConfiguration.builder().seed(1).list()
          .layer(port.DenseLayer(n_out=8))
          .layer(port.BatchNormalization())
          .layer(port.RnnOutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
          .set_input_type(port.InputType.recurrent(8)).build())
    with pytest.raises(ValueError, match="BatchNormalization"):
        SequenceParallelWrapper(port.MultiLayerNetwork(bn).init(device="cpu"),
                                cpu_mesh())
    with pytest.raises(ValueError, match="'seq' axis"):
        SequenceParallelWrapper(p, port.parallel.data_parallel_mesh(
            devices=["cpu"] * 2))
