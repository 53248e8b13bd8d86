"""The port's TensorParallelWrapper against the JAX package's.

The cases of tests/test_tensor_parallel.py (dense, DP x TP, LSTM,
attention, truncated BPTT, a conv ComputationGraph, the epoch loops, an
indivisible batch, checkpoints taken while placed, kill/restore/resume,
materialize_local) run through both wrappers from the same parameters on
the same batches: the JAX wrapper on the conftest's virtual CPU devices,
the port's on a mesh that lists the CPU once per shard. Parameters within
rtol 2e-4 and atol 2e-5 after the JAX tests' step counts. The port's
placement is checked directly: each model shard holds only its block of
every sharded leaf and of its updater state."""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as RefMultiDataSet
from deeplearning4j_tpu.nn.conf.builders import BackpropType as RefBPT
from deeplearning4j_tpu.nn.layers.attention import \
    SelfAttentionLayer as RefAttention
from deeplearning4j_tpu.nn.layers.convolution import \
    ConvolutionLayer as RefConv
from deeplearning4j_tpu.parallel import TensorParallelWrapper as RefTP
from deeplearning4j_tpu.parallel import tensor_parallel_mesh as ref_mesh
import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.nn.conf.builders import BackpropType as PortBPT
from deeplearning4j_torch.nn.layers.attention import \
    SelfAttentionLayer as PortAttention
from deeplearning4j_torch.nn.layers.convolution import \
    ConvolutionLayer as PortConv
from deeplearning4j_torch.parallel import (TensorParallelWrapper,
                                           tensor_parallel_mesh)
from deeplearning4j_torch.parallel.mesh import ShardedLeaf
from deeplearning4j_torch.parallel.tensor import model_param_spec
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_torch.utils.model_serializer import (restore_model,
                                                         save_model)

from test_torch_parallel_wrapper import assert_trees_close, twins

TOL = dict(rtol=2e-4, atol=2e-5)
BPT = {ref: RefBPT, port: PortBPT}


def cpu_mesh(**kw):
    return tensor_parallel_mesh(devices=["cpu"] * 8, **kw)


def dense_conf(pkg, seed=3, norm=None, adam=False):
    b = pkg.NeuralNetConfiguration.builder().seed(seed).updater(
        pkg.Adam(0.01) if adam else pkg.Sgd(0.1))
    if norm:
        b = b.gradient_normalization(norm)
    return (b.list()
            .layer(pkg.DenseLayer(n_out=32, activation="tanh"))
            .layer(pkg.DenseLayer(n_out=16, activation="relu"))
            .layer(pkg.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(8)).build())


def lstm_conf(pkg, tbptt=False):
    b = (pkg.NeuralNetConfiguration.builder().seed(11 if tbptt else 7)
         .updater(pkg.Sgd(0.1)).list()
         .layer(pkg.GravesLSTM(n_out=16, activation="tanh"))
         .layer(pkg.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
         .set_input_type(pkg.InputType.recurrent(6)))
    if tbptt:
        b = b.backprop_type(BPT[pkg].TRUNCATED_BPTT).tbptt_fwd_length(5) \
            .tbptt_back_length(5)
    return b.build()


def attention_conf(pkg):
    attn = RefAttention if pkg is ref else PortAttention
    return (pkg.NeuralNetConfiguration.builder().seed(9).updater(pkg.Sgd(0.1))
            .list()
            .layer(attn(n_out=16, n_heads=4, causal=True))
            .layer(pkg.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.recurrent(8)).build())


def conv_graph_conf(pkg):
    conv = RefConv if pkg is ref else PortConv
    return (pkg.NeuralNetConfiguration.builder().seed(13).updater(pkg.Sgd(0.1))
            .graph_builder().add_inputs("in")
            .add_layer("c1", conv(kernel_size=(3, 3), stride=(1, 1),
                                  padding=(1, 1), n_out=16, activation="relu"),
                       "in")
            .add_layer("c2", conv(kernel_size=(3, 3), stride=(2, 2), n_out=8,
                                  activation="relu"), "c1")
            .add_layer("out", pkg.OutputLayer(n_out=3, activation="softmax",
                                              loss="mcxent"), "c2")
            .set_outputs("out")
            .set_input_types(pkg.InputType.convolutional(8, 8, 2)).build())


def ff_data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def seq_data(seed, n, t, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t, f)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, t))]
    return x, y


def whole(tree):
    from deeplearning4j_torch.parallel.mesh import gather_replicated
    return gather_replicated(tree)


def both(make, steps, x, y, graph=False, **mesh_kw):
    r, p = twins(make, graph=graph)
    rw = RefTP(r, ref_mesh(**mesh_kw))
    pw = TensorParallelWrapper(p, cpu_mesh(**mesh_kw))
    for _ in range(steps):
        if graph:
            rw.fit_batch(RefMultiDataSet([x], [y]))
            pw.fit_batch(MultiDataSet([x], [y]))
        else:
            rw.fit_batch(RefDataSet(x, y))
            pw.fit_batch(DataSet(x, y))
    return r, p, rw, pw


def test_dense_fit_matches_jax_and_is_sharded():
    x, y = ff_data()
    r, p, rw, pw = both(dense_conf, 3, x, y)
    assert pw.model_shards == 8
    report = pw.param_shard_report()
    assert report == {k: v for k, v in rw.param_shard_report().items()}
    assert report["0.W"] == (None, "model") and report["0.b"] == ("model",)
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)
    np.testing.assert_allclose(float(p.score_value), float(r.score_value),
                               rtol=1e-4)


def test_each_shard_holds_only_its_blocks():
    """Between steps model shard j holds block j of each sharded leaf and of
    its updater state (Adam's two moments), a 1/8 share of the whole."""
    def make(pkg):
        return (pkg.NeuralNetConfiguration.builder().seed(3)
                .updater(pkg.Adam(0.01)).list()
                .layer(pkg.DenseLayer(n_out=32, activation="tanh"))
                .layer(pkg.OutputLayer(n_out=8, activation="softmax",
                                       loss="mcxent"))
                .set_input_type(pkg.InputType.feed_forward(8)).build())
    x, _ = ff_data()
    y = np.eye(8, dtype=np.float32)[np.arange(16) % 8]
    r, p, rw, pw = both(make, 2, x, y)
    w = p.params_tree[0]["W"]
    assert isinstance(w, ShardedLeaf) and [tuple(s.shape) for s in w.slices] \
        == [(8, 4)] * 8
    m, v = p.opt_state[0]["W"]
    assert isinstance(m, ShardedLeaf) and tuple(m.slices[3].shape) == (8, 4)
    sizes = pw.shard_bytes()
    assert sizes["replicated"] == 0 and sizes["per_shard"] == \
        [sizes["whole"] // 8] * 8
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)
    assert_trees_close(r.opt_state, whole(p.opt_state), **TOL,
                       conv=port_params.opt_state_to_numpy)


def test_dp_x_tp_grid():
    x, y = ff_data(seed=5)
    r, p, _, pw = both(dense_conf, 2, x, y, data_devices=2)
    assert (pw.data_shards, pw.model_shards) == (2, 4)
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


def test_gradient_normalization_over_every_block():
    """A per-layer L2 renormalization takes its norm over all the blocks."""
    x, y = ff_data(seed=2)
    norm = {pkg: pkg.nn.updaters.GradientNormalization.RENORMALIZE_L2_PER_LAYER
            for pkg in (ref, port)}
    r, p, _, _ = both(lambda pkg: dense_conf(pkg, norm=norm[pkg]), 2, x, y,
                      data_devices=2)
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


@pytest.mark.parametrize("mode", ["renormalize_l2_per_param_type",
                                  "clip_element_wise_absolute_value",
                                  "clip_l2_per_layer", "clip_l2_per_param_type"])
def test_every_gradient_normalization_mode_over_the_blocks(mode):
    """The other normalization modes, with Adam's two moments per block: each
    norm over all the blocks, the scaling and the update block by block."""
    x, y = ff_data(seed=4)
    norm = {pkg: pkg.nn.updaters.GradientNormalization(mode) for pkg in (ref, port)}

    def make(pkg):
        conf = dense_conf(pkg, norm=norm[pkg], adam=True)
        for layer in conf.layers:
            layer.gradient_normalization_threshold = 0.05
        return conf
    r, p, _, _ = both(make, 2, x, y, data_devices=2)
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


def test_lstm_fit_matches():
    x, y = seq_data(2, 8, 10, 6)
    r, p, _, pw = both(lstm_conf, 2, x, y)
    assert any("model" in v for v in pw.param_shard_report().values())
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


def test_attention_fit_matches():
    x, y = seq_data(4, 4, 12, 8)
    r, p, _, pw = both(attention_conf, 2, x, y)
    assert pw.param_shard_report()["0.Wq"] == (None, "model")
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


def test_tbptt_windows_under_tp():
    x, y = seq_data(6, 8, 12, 6)
    r, p, _, _ = both(lambda pkg: lstm_conf(pkg, tbptt=True), 2, x, y)
    assert p.iteration == r.iteration == 6   # 2 batches x 3 windows
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


def test_graph_conv_fit_matches():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    r, p, _, pw = both(conv_graph_conf, 2, x, y, graph=True)
    assert pw.param_shard_report()["c1.W"] == (None, None, None, "model")
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


def test_graph_fit_epoch_loop_with_dp():
    conf = (port.NeuralNetConfiguration.builder().seed(2).updater(port.Sgd(0.1))
            .graph_builder().add_inputs("in")
            .add_layer("out", port.OutputLayer(n_out=2, activation="softmax",
                                               loss="mcxent", n_in=4), "in")
            .set_outputs("out").build())
    g = port.ComputationGraph(conf).init(device="cpu")
    w = TensorParallelWrapper(g, cpu_mesh(data_devices=2))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    w.fit(MultiDataSet([x], [y]), epochs=2, batch_size=8)
    assert g.epoch == 2


def test_indivisible_batch_rejected():
    x, y = ff_data(n=5)
    r, p = twins(dense_conf)
    with pytest.raises(ValueError, match="divide") as want:
        RefTP(r, ref_mesh(data_devices=2)).fit_batch(RefDataSet(x, y))
    with pytest.raises(ValueError, match="divide") as got:
        TensorParallelWrapper(p, cpu_mesh(data_devices=2)).fit_batch(
            DataSet(x, y))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="final batch of 5 examples"):
        TensorParallelWrapper(p, cpu_mesh(data_devices=2)).fit(
            DataSet(*ff_data(n=21)), batch_size=16)


def test_epoch_fit_loop():
    x, y = ff_data()
    r, p = twins(dense_conf)
    RefTP(r, ref_mesh()).fit(RefDataSet(x, y), epochs=2, batch_size=16)
    TensorParallelWrapper(p, cpu_mesh()).fit(DataSet(x, y), epochs=2,
                                             batch_size=16)
    assert p.epoch == r.epoch == 2
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


def test_save_while_placed_equals_materialized(tmp_path):
    x, y = ff_data()
    net = port.MultiLayerNetwork(dense_conf(port)).init(device="cpu")
    w = TensorParallelWrapper(net, cpu_mesh())
    for _ in range(2):
        w.fit_batch(DataSet(x, y))
    assert w.param_shard_report()
    path = str(tmp_path / "tp_placed.zip")
    save_model(net, path)
    restored = restore_model(path, device="cpu")
    w.materialize_local()
    for a, b in zip(port_params.tree_leaves(net.params_tree),
                    port_params.tree_leaves(restored.params_tree)):
        assert torch.equal(a, b)
    for a, b in zip(port_params.tree_leaves(net.opt_state),
                    port_params.tree_leaves(restored.opt_state)):
        assert torch.equal(a, b)


def test_kill_restore_resume_matches_uninterrupted(tmp_path):
    x, y = ff_data(seed=4)
    batches = [(x[i * 4:(i + 1) * 4], y[i * 4:(i + 1) * 4]) for i in range(3)]
    straight = port.MultiLayerNetwork(dense_conf(port)).init(device="cpu")
    ws = TensorParallelWrapper(straight, cpu_mesh())
    for b in batches:
        ws.fit_batch(DataSet(*b))
    victim = port.MultiLayerNetwork(dense_conf(port)).init(device="cpu")
    wv = TensorParallelWrapper(victim, cpu_mesh())
    for b in batches[:2]:
        wv.fit_batch(DataSet(*b))
    path = str(tmp_path / "tp_resume.zip")
    save_model(victim, path)
    del victim, wv
    resumed = restore_model(path, device="cpu")
    wr = TensorParallelWrapper(resumed, cpu_mesh())
    wr.fit_batch(DataSet(*batches[2]))
    assert wr.param_shard_report()
    assert resumed.iteration == straight.iteration == 3
    for a, b in zip(port_params.tree_leaves(whole(straight.params_tree)),
                    port_params.tree_leaves(whole(resumed.params_tree))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_materialize_local_roundtrip_resumes():
    x, y = ff_data(seed=9)
    r, p = twins(dense_conf)
    rw, pw = RefTP(r, ref_mesh()), TensorParallelWrapper(p, cpu_mesh())
    rw.fit_batch(RefDataSet(x, y))
    pw.fit_batch(DataSet(x, y))
    pw.materialize_local()
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in port_params.tree_leaves(p.params_tree))
    assert p.output(x).shape == (16, 4)
    rw.fit_batch(RefDataSet(x, y))
    pw.fit_batch(DataSet(x, y))   # places again
    assert pw.param_shard_report()
    assert_trees_close(r.params_tree, whole(p.params_tree), **TOL)


@pytest.mark.parametrize("shape,want", [((8, 32), (None, "model")),
                                        ((16, 3), ("model", None)),
                                        ((3,), ()), ((), ())])
def test_model_param_spec_is_the_jax_rule(shape, want):
    from deeplearning4j_tpu.parallel.tensor import model_param_spec as ref_spec
    a = np.zeros(shape, np.float32)
    assert model_param_spec(a, 8) == want == tuple(ref_spec(a, 8))
    assert model_param_spec(np.zeros(shape, np.int32), 8) == ()


def test_needs_a_model_axis():
    net = port.MultiLayerNetwork(dense_conf(port)).init(device="cpu")
    with pytest.raises(ValueError, match="'model' axis"):
        TensorParallelWrapper(net, port.parallel.data_parallel_mesh(
            devices=["cpu"] * 2))
