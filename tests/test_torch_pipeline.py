"""The port's PipelineParallelWrapper against the JAX package's.

The cases of tests/test_pipeline.py run through both wrappers from the same
parameters on the same batches: S stages x k layers x M microbatches of the
GPipe schedule (the JAX wrapper over the conftest's virtual CPU devices, the
port's over a mesh that lists the CPU once per stage), Adam and L2 with the
updater state, frozen layers, the epoch loop and materialize_local;
parameters within rtol 2e-4 and atol 2e-5. Every refusal of the JAX
package's `_validate_layers` and `fit_batch` is reproduced with its error
type and message."""
import numpy as np
import pytest

import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import DataSet as RefDataSet
from deeplearning4j_tpu.parallel import PipelineParallelWrapper as RefPP
from deeplearning4j_tpu.parallel import pipeline_mesh as ref_mesh
import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.parallel import (PipelineParallelWrapper,
                                           pipeline_mesh)
from deeplearning4j_torch.utils import params as port_params

from test_torch_parallel_wrapper import assert_trees_close, twins

TOL = dict(rtol=2e-4, atol=2e-5)


def cpu_mesh(stages):
    return pipeline_mesh(stages, devices=["cpu"] * stages)


def conf(pkg, n_body=4, adam=False, l2=0.0, seed=7, body=None):
    b = (pkg.NeuralNetConfiguration.builder().seed(seed)
         .updater(pkg.Adam(1e-2) if adam else pkg.Sgd(0.1)))
    if l2:
        b = b.l2(l2)
    lb = b.list()
    for i in range(n_body):
        lb = lb.layer(body(pkg, i) if body else
                      pkg.DenseLayer(n_in=16, n_out=16, activation="tanh"))
    return (lb.layer(pkg.OutputLayer(n_out=3, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(16)).build())


def data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


@pytest.mark.parametrize("stages,k,M", [(4, 1, 4), (2, 2, 8), (8, 1, 2)])
def test_fit_matches_jax(stages, k, M):
    x, y = data()
    r, p = twins(lambda pkg: conf(pkg, n_body=stages * k))
    rw = RefPP(r, ref_mesh(stages), n_microbatches=M)
    pw = PipelineParallelWrapper(p, cpu_mesh(stages), n_microbatches=M)
    for _ in range(3):
        rw.fit_batch(RefDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
    assert p.iteration == r.iteration == 3
    assert pw.bubble_fraction() == (stages - 1) / (M + stages - 1)
    rw.materialize_local()
    pw.materialize_local()
    assert_trees_close(r.params_tree, p.params_tree, **TOL)
    np.testing.assert_allclose(float(p.score_value), float(r.score_value),
                               rtol=1e-4)


def test_adam_and_l2_match():
    x, y = data(seed=3)
    r, p = twins(lambda pkg: conf(pkg, adam=True, l2=1e-3))
    rw, pw = RefPP(r, ref_mesh(4)), PipelineParallelWrapper(p, cpu_mesh(4))
    for _ in range(2):
        rw.fit_batch(RefDataSet(x, y))
        pw.fit_batch(DataSet(x, y))
    rw.materialize_local()
    pw.materialize_local()
    assert_trees_close(r.params_tree, p.params_tree, **TOL)
    assert_trees_close(r.opt_state, p.opt_state, **TOL,
                       conv=port_params.opt_state_to_numpy)


def test_stage_placement_evidence():
    """Every body parameter is reported on its stage; the stages' bytes add
    up to the whole network's, the output layer on the last stage."""
    net = port.MultiLayerNetwork(conf(port)).init(device="cpu")
    w = PipelineParallelWrapper(net, cpu_mesh(4))
    report = w.stage_shard_report()
    assert sorted({spec[1] for spec in report.values()}) == [0, 1, 2, 3]
    assert all(spec[0] == "stage" for spec in report.values())
    assert report["2.W"][1] == 2
    body = sum(t.numel() * 4 for t in port_params.tree_leaves(
        (net.params_tree[0], net.opt_state[0])))
    sizes = w.stage_bytes()
    assert sizes[:3] == [body] * 3 and sizes[3] > body
    assert sum(sizes) == sum(t.numel() * 4 for t in port_params.tree_leaves(
        (net.params_tree, net.opt_state)))


def test_materialize_then_plain_inference():
    x, y = data(seed=5)
    net = port.MultiLayerNetwork(conf(port)).init(device="cpu")
    w = PipelineParallelWrapper(net, cpu_mesh(4))
    w.fit_batch(DataSet(x, y))
    w.materialize_local()
    assert net.output(x).shape == (16, 3)
    net._fit_batch(DataSet(x, y))


def test_frozen_layers_not_trained():
    x, y = data(seed=7)
    body = lambda pkg, i: pkg.DenseLayer(n_in=16, n_out=16, activation="tanh",
                                         frozen=True)
    r, p = twins(lambda pkg: conf(pkg, n_body=2, seed=8, body=body))
    before = port_params.tree_copy(p.params_tree)
    rw, pw = RefPP(r, ref_mesh(2)), PipelineParallelWrapper(p, cpu_mesh(2))
    rw.fit_batch(RefDataSet(x, y))
    pw.fit_batch(DataSet(x, y))
    rw.materialize_local()
    pw.materialize_local()
    for b, a in zip(before[:2], p.params_tree[:2]):
        for k in b:
            assert np.array_equal(b[k].numpy(), a[k].numpy()), k
    assert not np.array_equal(before[-1]["W"].numpy(),
                              p.params_tree[-1]["W"].numpy())
    assert_trees_close(r.params_tree, p.params_tree, **TOL)


def test_epoch_fit_loop():
    x, y = data(n=32)
    r, p = twins(conf)
    rw = RefPP(r, ref_mesh(4), n_microbatches=4)
    rw.fit(RefDataSet(x, y), epochs=2, batch_size=16)
    w = PipelineParallelWrapper(p, cpu_mesh(4), n_microbatches=4)
    w.fit(DataSet(x, y), epochs=2, batch_size=16)
    assert p.epoch == r.epoch == 2 and p.iteration == r.iteration == 4
    rw.materialize_local()
    w.materialize_local()
    assert_trees_close(r.params_tree, p.params_tree, **TOL)


def _refusal(make, stages, err):
    """The JAX wrapper and the port's refuse `make`'s network alike."""
    messages = []
    for pkg, wrapper, mesh in ((ref, RefPP, ref_mesh(stages)),
                               (port, PipelineParallelWrapper,
                                cpu_mesh(stages))):
        conf_ = make(pkg)
        net = (pkg.ComputationGraph if hasattr(conf_, "network_inputs")
               else pkg.MultiLayerNetwork)(conf_)
        net = net.init(device="cpu") if pkg is port else net.init()
        with pytest.raises(err) as e:
            wrapper(net, mesh)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def _stack(layers_fn):
    def make(pkg):
        lb = pkg.NeuralNetConfiguration.builder().seed(1).updater(
            pkg.Sgd(0.1)).list()
        for layer in layers_fn(pkg):
            lb = lb.layer(layer)
        return (lb.layer(pkg.OutputLayer(n_out=3, activation="softmax",
                                         loss="mcxent"))
                .set_input_type(pkg.InputType.feed_forward(16)).build())
    return make


REFUSALS = {
    "heterogeneous": (_stack(lambda pkg: [
        pkg.DenseLayer(n_in=16, n_out=16, activation=a)
        for a in ("tanh", "relu", "tanh", "relu")]), 4, ValueError),
    "indivisible_stages": (lambda pkg: conf(pkg, n_body=3), 4, ValueError),
    "stateful": (_stack(lambda pkg: [pkg.BatchNormalization(n_out=16)] * 2),
                 2, ValueError),
    "n_in_n_out": (_stack(lambda pkg: [pkg.DenseLayer(n_in=16, n_out=8)] * 2),
                   2, ValueError),
    "dropout": (_stack(lambda pkg: [pkg.DenseLayer(
        n_in=16, n_out=16, activation="tanh", dropout_rate=0.5)] * 2), 2,
        ValueError),
    "gradient_normalization": (_stack(lambda pkg: [pkg.DenseLayer(
        n_in=16, n_out=16, gradient_normalization=pkg.nn.updaters
        .GradientNormalization.CLIP_L2_PER_LAYER)] * 2), 2, ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_are_the_jax_packages(case):
    make, stages, err = REFUSALS[case]
    _refusal(make, stages, err)


def test_graph_and_recurrent_and_preprocessor_refused():
    graph = (port.NeuralNetConfiguration.builder().seed(1).graph_builder()
             .add_inputs("in")
             .add_layer("out", port.OutputLayer(n_out=2, n_in=4), "in")
             .set_outputs("out").build())
    with pytest.raises(NotImplementedError, match="ComputationGraph DAGs"):
        PipelineParallelWrapper(port.ComputationGraph(graph).init(device="cpu"),
                                cpu_mesh(2))
    lstm = (port.NeuralNetConfiguration.builder().seed(1).list()
            .layer(port.GravesLSTM(n_in=4, n_out=4))
            .layer(port.GravesLSTM(n_in=4, n_out=4))
            .layer(port.RnnOutputLayer(n_out=3, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(port.InputType.recurrent(4)).build())
    with pytest.raises(ValueError, match="layer 0 is recurrent"):
        PipelineParallelWrapper(port.MultiLayerNetwork(lstm).init(device="cpu"),
                                cpu_mesh(2))
    cnn = (port.NeuralNetConfiguration.builder().seed(1).list()
           .layer(port.DenseLayer(n_out=12, activation="tanh"))
           .layer(port.DenseLayer(n_out=12, activation="tanh"))
           .layer(port.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
           .set_input_type(port.InputType.convolutional(2, 2, 3)).build())
    with pytest.raises(ValueError, match="preprocessor at layer 0"):
        PipelineParallelWrapper(port.MultiLayerNetwork(cnn).init(device="cpu"),
                                cpu_mesh(2))


def test_indivisible_microbatches_and_masks_rejected():
    x, y = data(n=10)
    r, p = twins(conf)
    for pkg_ds, w in ((RefDataSet, RefPP(r, ref_mesh(4), n_microbatches=4)),
                      (DataSet, PipelineParallelWrapper(p, cpu_mesh(4),
                                                        n_microbatches=4))):
        with pytest.raises(ValueError, match="must divide 4 microbatches"):
            w.fit_batch(pkg_ds(x, y))
        xm, ym = data()
        with pytest.raises(NotImplementedError, match="mask"):
            w.fit_batch(pkg_ds(xm, ym, labels_mask=np.ones((16, 1), np.float32)))
    with pytest.raises(ValueError, match="final batch of 10 examples"):
        PipelineParallelWrapper(p, cpu_mesh(4)).fit(DataSet(*data(n=26)),
                                                    batch_size=16)
