"""The torch port's ComputationGraph against the JAX package's.

- Every vertex type (and each ElementWiseVertex op), forward, output mask
  and output type, on the same numpy inputs (rtol 1e-6: one or two float32
  operations in another library).
- GlobalPoolingLayer in each pooling type, on NHWC input and on masked
  [batch, time, features] input (rtol 1e-6).
- The topological order and the configuration JSON of zoo GoogLeNet (with
  and without `fuse_siblings`) and of the `graph_merge` checkpoint's graph:
  each package's JSON builds the other's configuration, equal field by
  field, with the same order.
- A mini-inception graph (GoogLeNet's stem with both LRNs, two inception
  blocks at narrow widths, global average pooling, dense and output) at
  32x32x3, batch 4, dropout off, from the same parameters: `output` (rtol
  1e-5, atol 1e-6), `feed_forward_named`, `score`, the gradients per
  parameter (relative norm under 1e-5) and parameters and optimizer state
  after 3 `fit` steps (rtol 1e-5): float32 convolutions summed in another
  order on both sides.
- ParallelInference over a graph on the CPU, `fit_batches`,
  `fit_batch_repeated` and `evaluate` (once left for a later slice), and
  `params`/`set_params` against the JAX package's flat vector.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.nn.conf import graph_conf as port_gc
from deeplearning4j_torch.nn.graph import vertices as port_v
from deeplearning4j_torch.nn.layers import convolution as port_conv
from deeplearning4j_torch.parallel.inference import InferenceMode, ParallelInference
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.data.dataset import MultiDataSet as RefMultiDataSet
from deeplearning4j_tpu.models import zoo as ref_zoo
from deeplearning4j_tpu.nn.conf import graph_conf as ref_gc
from deeplearning4j_tpu.nn.conf import inputs as ref_inputs
from deeplearning4j_tpu.nn.graph import vertices as ref_v
from deeplearning4j_tpu.nn.layers import convolution as ref_conv
from deeplearning4j_tpu.utils import serde as ref_serde
from deeplearning4j_torch.nn.conf import inputs as port_inputs
from deeplearning4j_torch.utils import serde as port_serde
from test_torch_word2vec import one_torch_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _types(pkg, *specs):
    it = pkg.InputType
    make = {"ff": it.feed_forward, "rnn": it.recurrent, "cnn": it.convolutional}
    return [make[kind](*args) for kind, *args in specs]


_GAP_MASK = np.array([[1, 1, 0, 1, 0], [1, 0, 0, 0, 0]], np.float32)

# (id, class name, kwargs, input shapes, masks, input type specs)
VERTEX_CASES = [
    ("merge", "MergeVertex", {}, [(2, 3, 4, 5), (2, 3, 4, 2)], None,
     [("cnn", 3, 4, 5), ("cnn", 3, 4, 2)]),
    *[(f"elementwise_{op}", "ElementWiseVertex", {"op": op},
       [(2, 6), (2, 6)] if op == "subtract" else [(2, 6), (2, 6), (2, 6)], None,
       [("ff", 6)] * (2 if op == "subtract" else 3))
      for op in ("add", "subtract", "product", "average", "max")],
    ("subset", "SubsetVertex", {"from_idx": 1, "to_idx": 3}, [(2, 6)], None,
     [("ff", 6)]),
    ("stack", "StackVertex", {}, [(2, 5, 4), (3, 5, 4)],
     [np.ones((2, 5), np.float32), _GAP_MASK[:1].repeat(3, 0)],
     [("rnn", 4, 5), ("rnn", 4, 5)]),
    ("unstack", "UnstackVertex", {"from_idx": 1, "stack_size": 2}, [(4, 5, 3)],
     [np.tile(_GAP_MASK, (2, 1))], [("rnn", 3, 5)]),
    ("scale", "ScaleVertex", {"scale_factor": 2.5}, [(2, 6)], None, [("ff", 6)]),
    ("shift", "ShiftVertex", {"shift_factor": -0.5}, [(2, 6)], None, [("ff", 6)]),
    ("pool_helper", "PoolHelperVertex", {}, [(2, 5, 6, 3)], None,
     [("cnn", 5, 6, 3)]),
    ("reshape", "ReshapeVertex", {"new_shape": (3, 4)}, [(2, 12)], None,
     [("ff", 12)]),
    ("l2_normalize", "L2NormalizeVertex", {}, [(2, 3, 4)], None,
     [("rnn", 4, 3)]),
    ("l2", "L2Vertex", {}, [(2, 5), (2, 5)], None, [("ff", 5), ("ff", 5)]),
    ("preprocessor", "PreprocessorVertex", "cnn_to_ff", [(2, 3, 4, 2)], None,
     [("cnn", 3, 4, 2)]),
    ("last_time_step", "LastTimeStepVertex", {}, [(2, 5, 3)], [_GAP_MASK],
     [("rnn", 3, 5)]),
    ("last_time_step_unmasked", "LastTimeStepVertex", {}, [(2, 5, 3)], None,
     [("rnn", 3, 5)]),
    ("duplicate_to_time_series", "DuplicateToTimeSeriesVertex", {},
     [(2, 4), (2, 5, 3)], None, [("ff", 4), ("rnn", 3, 5)]),
]


def test_every_vertex_type_has_a_case():
    names = {c[1] for c in VERTEX_CASES}
    ported = {n for n, c in port_serde._REGISTRY.items()
              if isinstance(c, type) and issubclass(c, port_v.GraphVertex)
              and c is not port_v.GraphVertex}
    assert names == ported
    assert len(ported) == 14


def _vertex(pkg_v, pkg_inputs, cls, kwargs):
    if kwargs == "cnn_to_ff":
        kwargs = {"preprocessor": pkg_inputs.CnnToFeedForwardPreProcessor(3, 4, 2)}
    return getattr(pkg_v, cls)(**kwargs)


@pytest.mark.parametrize("case", VERTEX_CASES, ids=[c[0] for c in VERTEX_CASES])
def test_vertex_matches_reference(case):
    _, cls, kwargs, shapes, masks, specs = case
    xs = [_arr(s, seed=i) for i, s in enumerate(shapes)]
    got_v = _vertex(port_v, port_inputs, cls, kwargs)
    want_v = _vertex(ref_v, ref_inputs, cls, kwargs)
    got = got_v.forward([torch.from_numpy(x) for x in xs],
                        masks=None if masks is None else
                        [torch.from_numpy(m) for m in masks])
    want = want_v.forward([jnp.asarray(x) for x in xs],
                          masks=None if masks is None else
                          [jnp.asarray(m) for m in masks])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    got_m = got_v.output_mask(None if masks is None else
                              [torch.from_numpy(m) for m in masks] if masks
                              else [None] * len(xs)) if masks else \
        got_v.output_mask([None] * len(xs))
    want_m = want_v.output_mask([jnp.asarray(m) for m in masks] if masks
                                else [None] * len(xs))
    assert (got_m is None) == (want_m is None)
    if got_m is not None:
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    got_t = got_v.output_type(_types(port, *specs))
    want_t = want_v.output_type(_types(ref, *specs))
    assert json.loads(port_serde.to_json(got_t)) == json.loads(ref_serde.to_json(want_t))
    # the vertex's JSON loads in the other package
    assert json.loads(ref_serde.to_json(ref_serde.from_json(port_serde.to_json(got_v)))) \
        == json.loads(port_serde.to_json(got_v))


@pytest.mark.parametrize("ptype", ["MAX", "AVG", "SUM", "PNORM"])
@pytest.mark.parametrize("kind", ["cnn", "rnn_masked"])
def test_global_pooling_matches_reference(ptype, kind):
    got_l = port_conv.GlobalPoolingLayer(pooling_type=port_conv.PoolingType[ptype],
                                         pnorm=3, activation="identity")
    want_l = ref_conv.GlobalPoolingLayer(pooling_type=ref_conv.PoolingType[ptype],
                                         pnorm=3, activation="identity")
    if kind == "cnn":
        x, m = _arr((2, 5, 6, 4), seed=3), None
    else:
        x, m = _arr((2, 5, 4), seed=4), _GAP_MASK
    got = got_l.forward({}, torch.from_numpy(x),
                        mask=None if m is None else torch.from_numpy(m))
    want, _ = want_l.forward({}, {}, jnp.asarray(x),
                             mask=None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    it = (port.InputType.convolutional(5, 6, 4) if kind == "cnn"
          else port.InputType.recurrent(4, 5))
    assert got_l.set_input_type(it) == port.InputType.feed_forward(4)


# ------------------------------------------------------ configurations, order

def _graph_merge_json():
    import zipfile
    with zipfile.ZipFile(os.path.join(FIX, "checkpoints", "graph_merge.zip")) as zf:
        return zf.read("configuration.json").decode()


CONFS = {
    "googlenet": lambda pkg_zoo: pkg_zoo.GoogLeNet().conf(),
    "googlenet_fused": lambda pkg_zoo: pkg_zoo.GoogLeNet(fuse_siblings=True).conf(),
}


@pytest.mark.parametrize("name", sorted(CONFS) + ["graph_merge"])
def test_conf_json_and_order_match_reference(name):
    if name == "graph_merge":
        want = ref_gc.ComputationGraphConfiguration.from_json(_graph_merge_json())
        got = port_gc.ComputationGraphConfiguration.from_json(_graph_merge_json())
    else:
        got, want = CONFS[name](port_zoo), CONFS[name](ref_zoo)
    got_d, want_d = json.loads(got.to_json()), json.loads(want.to_json())
    assert got_d == want_d
    # each package's JSON builds the other's configuration
    assert json.loads(ref_gc.ComputationGraphConfiguration.from_json(
        got.to_json()).to_json()) == want_d
    assert json.loads(port_gc.ComputationGraphConfiguration.from_json(
        want.to_json()).to_json()) == got_d
    # Kahn's order recomputed from the nodes, in both packages
    order = port_gc._toposort(got.nodes, got.network_inputs)
    assert order == got.topo_order == want.topo_order == \
        ref_gc._toposort(want.nodes, want.network_inputs)


def test_toposort_takes_ready_nodes_in_insertion_order():
    conf = (port.NeuralNetConfiguration.builder().graph_builder()
            .add_inputs("in")
            .add_layer("z", port.DenseLayer(n_out=3), "in")
            .add_layer("a", port.DenseLayer(n_out=3), "in")
            .add_vertex("m", port.MergeVertex(), "a", "z")
            .add_layer("out", port.OutputLayer(n_out=2), "m")
            .set_outputs("out")
            .set_input_types(port.InputType.feed_forward(4))
            .build())
    assert conf.topo_order == ["z", "a", "m", "out"]
    with pytest.raises(ValueError, match="cycle"):
        port_gc._toposort({"a": port_gc.GraphNode(inputs=["b"]),
                           "b": port_gc.GraphNode(inputs=["a"])}, ["in"])
    with pytest.raises(ValueError, match="sinks"):
        (port.NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .add_layer("o", port.OutputLayer(n_out=2), "in")
         .add_layer("d", port.DenseLayer(n_out=2), "o").set_outputs("d").build())


# ------------------------------------------------------------ mini inception

def _mini_conf(pkg, pkg_zoo):
    """GoogLeNet's stem (both LRNs, at alpha 1e-2 so that the window term
    counts), two inception blocks of GoogLeNet's own `_inception` at narrow
    widths, global average pooling, dense and output; dropout off."""
    g = (pkg.NeuralNetConfiguration.builder()
         .seed(11)
         .activation("relu")
         .updater(pkg.Nesterovs(learning_rate=1e-2, momentum=0.9))
         .weight_init(pkg.WeightInit.XAVIER)
         .l2(2e-4)
         .graph_builder())
    g.add_inputs("input")
    g.set_input_types(pkg.InputType.convolutional(32, 32, 3))
    g.add_layer("cnn1", pkg.ConvolutionLayer(
        kernel_size=(7, 7), stride=(2, 2), padding=(3, 3), n_out=8,
        bias_init=0.2), "input")
    g.add_layer("max1", pkg.SubsamplingLayer(
        kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
        pooling_type=pkg.PoolingType.MAX), "cnn1")
    g.add_layer("lrn1", pkg.LocalResponseNormalization(alpha=1e-2), "max1")
    g.add_layer("cnn2", pkg.ConvolutionLayer(kernel_size=(1, 1), n_out=8,
                                             bias_init=0.2), "lrn1")
    g.add_layer("cnn3", pkg.ConvolutionLayer(kernel_size=(3, 3), padding=(1, 1),
                                             n_out=12, bias_init=0.2), "cnn2")
    g.add_layer("lrn2", pkg.LocalResponseNormalization(alpha=1e-2), "cnn3")
    g.add_layer("max2", pkg.SubsamplingLayer(
        kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
        pooling_type=pkg.PoolingType.MAX), "lrn2")
    block = pkg_zoo.GoogLeNet()._inception
    x = block(g, "3a", [[4], [4, 6], [2, 3], [3]], "max2")
    x = block(g, "3b", [[5], [4, 6], [2, 4], [3]], x)
    g.add_layer("avgpool", pkg.GlobalPoolingLayer(pooling_type=pkg.PoolingType.AVG), x)
    g.add_layer("fc1", pkg.DenseLayer(n_out=10), "avgpool")
    g.add_layer("output", pkg.OutputLayer(n_out=5, activation="softmax",
                                          loss="mcxent"), "fc1")
    g.set_outputs("output")
    return g.build()


def _ref_graph(conf, port_net):
    """A JAX-package graph holding the port graph's parameters and optimizer
    state (carried with params_to_numpy/opt_state_to_numpy)."""
    net = ref.ComputationGraph(conf)
    net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    net.opt_state = jax.tree_util.tree_map(
        jnp.asarray, port_params.opt_state_to_numpy(port_net.opt_state))
    net.state_tree = {n: conf.nodes[n].layer.init_state() for n in net._layer_nodes}
    net._rng = jax.random.PRNGKey(0)
    net._build_jitted()
    net._initialized = True
    return net


def _data(n, seed=21):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    return x, y


def _rel_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def mini():
    port_net = port.ComputationGraph(_mini_conf(port, port_zoo)).init(device="cpu")
    conf = _mini_conf(ref, ref_zoo)
    assert json.loads(conf.to_json()) == json.loads(port_net.conf.to_json())
    return port_net, conf


def test_mini_inception_output_and_activations(mini):
    port_net, conf = mini
    ref_net = _ref_graph(conf, port_net)
    x, _ = _data(4)
    np.testing.assert_allclose(port_net.output(x), np.asarray(ref_net.output(x)),
                               rtol=1e-5, atol=1e-6)
    got, want = port_net.feed_forward_named(x), ref_net.feed_forward_named(x)
    # the port's dict in the walk's order; the JAX package's jit sorts it
    assert list(got) == ["input"] + port_net.conf.topo_order
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(port_net.predict(x), np.argmax(port_net.output(x), -1))


def test_mini_inception_score_and_gradients(mini):
    port_net, conf = mini
    ref_net = _ref_graph(conf, port_net)
    x, y = _data(4)
    got_g, got_s = port_net.compute_gradient_and_score(DataSet(x, y))
    (want_s, _), want_g = jax.value_and_grad(ref_net._loss_pure, has_aux=True)(
        ref_net.params_tree, ref_net.state_tree, {"input": jnp.asarray(x)},
        {"output": jnp.asarray(y)}, {}, {}, None, False)
    np.testing.assert_allclose(got_s, float(want_s), rtol=1e-6)
    np.testing.assert_allclose(port_net.score(DataSet(x, y)),
                               ref_net.score(RefMultiDataSet([x], [y])), rtol=1e-6)
    got_g = port_params.params_to_numpy(got_g)
    assert sorted(got_g) == sorted(want_g)
    for node, wl in want_g.items():
        assert sorted(got_g[node]) == sorted(wl), node
        for k in wl:
            assert _rel_err(got_g[node][k], np.asarray(wl[k])) < 1e-5, (node, k)


def test_mini_inception_three_fit_steps(mini):
    _, conf = mini
    port_net = port.ComputationGraph(_mini_conf(port, port_zoo)).init(device="cpu")
    ref_net = _ref_graph(conf, port_net)
    x, y = _data(12, seed=22)
    port_net.fit(x, y, batch_size=4)
    ref_net.fit(x, y, batch_size=4, use_async=False)
    assert port_net.iteration == ref_net.iteration == 3
    assert port_net.epoch == ref_net.epoch == 1
    np.testing.assert_allclose(float(port_net.score_value),
                               float(ref_net.score_value), rtol=1e-5)
    for what, got, want in (
            ("params", port_params.params_to_numpy(port_net.params_tree),
             ref_net.params_tree),
            ("opt", port_params.opt_state_to_numpy(port_net.opt_state),
             ref_net.opt_state)):
        flat_g, tree_g = jax.tree_util.tree_flatten(got)
        flat_w, tree_w = jax.tree_util.tree_flatten(want)
        assert tree_g == tree_w, what
        for i, (g, w) in enumerate(zip(flat_g, flat_w)):
            # params O(0.1-1), Nesterov velocities O(lr): atol below both
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-8,
                                       err_msg=f"{what} leaf {i}")


def test_fit_takes_multidataset_and_iterators(mini):
    _, _ = mini
    x, y = _data(8, seed=23)
    nets = [port.ComputationGraph(_mini_conf(port, port_zoo)).init(device="cpu")
            for _ in range(3)]
    nets[0].fit(x, y, batch_size=4)
    nets[1].fit(MultiDataSet([x], [y]), batch_size=4)
    nets[2].fit(iter([DataSet(x[:4], y[:4]), MultiDataSet([x[4:]], [y[4:]])]))
    for net in nets[1:]:
        assert net.iteration == 2
        for a, b in zip(port_params.tree_leaves(nets[0].params_tree),
                        port_params.tree_leaves(net.params_tree)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_params_set_params_round_trip_matches_reference_layout(mini):
    port_net, conf = mini
    ref_net = _ref_graph(conf, port_net)
    flat = port_net.params()
    np.testing.assert_array_equal(flat, np.asarray(ref_net.params()))
    assert flat.size == port_net.num_params()
    other = port.ComputationGraph(port_net.conf).init(seed=99, device="cpu")
    other.set_params(flat)
    for a, b in zip(port_params.tree_leaves(port_net.params_tree),
                    port_params.tree_leaves(other.params_tree)):
        assert torch.equal(a, b)
        assert a.is_contiguous(memory_format=torch.channels_last) == \
            b.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        other.set_params(flat[:-1])
    assert "Total params" in port_net.summary()


def test_later_paths_raise_naming_their_item(mini):
    """The paths this test once held to NotImplementedError (fit_batches,
    fit_batch_repeated, evaluate) are ported: a group is bitwise the same
    batches fitted one by one, a repeat the same batch fitted in a loop, and
    evaluate counts the argmax hits of `output`."""
    port_net, _ = mini
    nets = [port.ComputationGraph(_mini_conf(port, port_zoo)).init(device="cpu")
            for _ in range(4)]
    (x1, y1), (x2, y2) = _data(4, seed=21), _data(4, seed=22)
    b1, b2 = MultiDataSet([x1], [y1]), MultiDataSet([x2], [y2])
    nets[0].fit_batches([b1, b2])
    nets[1].fit_batch(b1)
    nets[1].fit_batch(b2)
    nets[2].fit_batch_repeated(b1, 2)
    nets[3].fit_batch(b1)
    nets[3].fit_batch(b1)
    for a, b in ((nets[0], nets[1]), (nets[2], nets[3])):
        assert a.iteration == b.iteration == 2
        for name in a.params_tree:
            for k in a.params_tree[name]:
                assert torch.equal(a.params_tree[name][k], b.params_tree[name][k])
        assert torch.equal(a.score_value, b.score_value)
    ev = port_net.evaluate(x1, y1, batch_size=3)
    hits = int((port_net.predict(x1) == np.argmax(y1, -1)).sum())
    assert ev.num_examples() == 4 and ev.accuracy() == hits / 4
    # rnn_time_step is ported (tests/test_torch_tbptt.py): a graph without a
    # recurrent node streams as `output` computes
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_net.rnn_time_step(x)[0], port_net.output(x))


def test_graph_init_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_zoo.GoogLeNet(num_labels=10, input_shape=(32, 32, 3)).init()


def test_parallel_inference_serves_a_graph(mini):
    port_net, _ = mini
    rng = np.random.default_rng(5)
    reqs = [rng.standard_normal((k, 32, 32, 3)).astype(np.float32) for k in (1, 3, 2, 4)]
    with ParallelInference(port_net, inference_mode=InferenceMode.BATCHED,
                           batch_limit=8) as pi:
        pi.warmup()
        assert pi.warmed_buckets == [1, 2, 4, 8]
        outs = [pi.output(x) for x in reqs]
    for x, out in zip(reqs, outs):
        np.testing.assert_allclose(out, port_net.output(x), rtol=1e-6, atol=1e-7)
    two_out = (port.NeuralNetConfiguration.builder().graph_builder()
               .add_inputs("in")
               .add_layer("o1", port.OutputLayer(n_out=2), "in")
               .add_layer("o2", port.OutputLayer(n_out=2), "in")
               .set_outputs("o1", "o2")
               .set_input_types(port.InputType.feed_forward(3)).build())
    net = port.ComputationGraph(two_out).init(device="cpu")
    assert [o.shape for o in net.outputs(np.zeros((2, 3), np.float32))] == [(2, 2)] * 2
    with pytest.raises(ValueError, match="one input and one output"):
        ParallelInference(net, inference_mode=InferenceMode.SEQUENTIAL)
