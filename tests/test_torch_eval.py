"""The port's evaluation against the JAX package's, on the same outputs.

- Evaluation (top-1 and top-3, class-index and one-hot labels, [batch,
  time, classes] series with a mask, merge, stats), RegressionEvaluation
  (with a time-series mask) and EvaluationBinary: every statistic exactly
  (the same numpy arithmetic), and tensors accepted where numpy is.
- ROC (exact and thresholded), ROCBinary and ROCMultiClass: AUC, AUPRC and
  curves exactly, merged accumulators too.
- MultiLayerNetwork.evaluate / evaluate_regression and
  ComputationGraph.evaluate against the JAX package's on the same
  parameters: the confusion matrix exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.eval import evaluation as ev
from deeplearning4j_torch.eval import roc
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.eval import evaluation as ref_ev
from deeplearning4j_tpu.eval import roc as ref_roc


def _probs(rng, shape):
    p = rng.random(shape)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _cls_case(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "series":
        lab = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (5, 6))]
        return lab, _probs(rng, (5, 6, 4)), (rng.random((5, 6)) > 0.3).astype(np.float32)
    if kind == "indices":
        return rng.integers(0, 4, 20), rng.integers(0, 4, 20), None
    lab = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 20)]
    return lab, _probs(rng, (20, 4)), None


def _eval_stats(e):
    return ([e.accuracy(), e.precision(), e.recall(), e.f1(), e.top_n_accuracy(),
             e.num_examples()] + [m(c) for c in range(e.n_classes)
                                  for m in (e.precision, e.recall, e.f1)],
            e.confusion.copy(), e.stats())


# rank-1 class-index predictions support top-1 only, as in the JAX package
@pytest.mark.parametrize("kind,top_n", [("onehot", 1), ("onehot", 3), ("indices", 1),
                                        ("series", 1), ("series", 3)])
def test_evaluation_matches_reference(kind, top_n):
    got, want = ev.Evaluation(top_n=top_n), ref_ev.Evaluation(top_n=top_n)
    for seed in (0, 1):
        lab, pred, mask = _cls_case(kind, seed)
        got.eval(torch.as_tensor(lab), torch.as_tensor(pred),
                 None if mask is None else torch.as_tensor(mask))
        want.eval(lab, pred, mask)
    g, w = _eval_stats(got), _eval_stats(want)
    assert g[0] == w[0] and g[2] == w[2]
    np.testing.assert_array_equal(g[1], w[1])
    other, ref_other = ev.Evaluation(top_n=top_n), ref_ev.Evaluation(top_n=top_n)
    lab, pred, mask = _cls_case(kind, 7)
    other.eval(lab, pred, mask)
    ref_other.eval(lab, pred, mask)
    np.testing.assert_array_equal(got.merge(other).confusion,
                                  want.merge(ref_other).confusion)
    assert got.top_n_accuracy() == want.top_n_accuracy()


@pytest.mark.parametrize("series", [False, True])
def test_regression_and_binary_evaluation_match_reference(series):
    rng = np.random.default_rng(3)
    shape = (4, 5, 3) if series else (20, 3)
    lab = rng.standard_normal(shape).astype(np.float32)
    pred = (lab + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    mask = (rng.random(shape[:2]) > 0.2).astype(np.float32) if series else None
    r, rr = ev.RegressionEvaluation(), ref_ev.RegressionEvaluation()
    r.eval(lab, torch.as_tensor(pred), mask)
    rr.eval(lab, pred, mask)
    for c in range(3):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "r_squared", "correlation"):
            assert getattr(r, m)(c) == getattr(rr, m)(c), (m, c)
    assert r.stats() == rr.stats()
    b, rb = ev.EvaluationBinary(), ref_ev.EvaluationBinary()
    pl, pp = (lab > 0).astype(np.float32), 1 / (1 + np.exp(-pred))
    b.eval(pl, pp, mask)
    rb.eval(pl, pp, mask)
    for c in range(3):
        for m in ("accuracy", "precision", "recall", "f1"):
            assert getattr(b, m)(c) == getattr(rb, m)(c), (m, c)


@pytest.mark.parametrize("steps", [0, 10])
def test_roc_family_matches_reference(steps):
    rng = np.random.default_rng(5)
    y = rng.integers(0, 2, 50)
    p = np.clip(0.3 * y + 0.7 * rng.random(50), 0, 1)
    keep = (rng.random(50) > 0.2).astype(np.float32)
    for labels, preds, mask in ((y, np.stack([1 - p, p], 1), None),
                                (y[:, None], p[:, None], keep)):
        one, ref_one = roc.ROC(steps), ref_roc.ROC(steps)
        one.eval(torch.as_tensor(labels), preds, mask)
        ref_one.eval(labels, preds, mask)
        assert one.calculate_auc() == ref_one.calculate_auc()
        assert one.calculate_auprc() == ref_one.calculate_auprc()
        for a, b in zip(one.get_roc_curve(), ref_one.get_roc_curve()):
            np.testing.assert_array_equal(a, b)
        assert one.stats() == ref_one.stats()
    labels = np.eye(3)[rng.integers(0, 3, 40)]
    probs = _probs(rng, (40, 3))
    for cls, ref_cls in ((roc.ROCMultiClass, ref_roc.ROCMultiClass),
                         (roc.ROCBinary, ref_roc.ROCBinary)):
        a, b = cls(steps), ref_cls(steps)
        a.eval(labels, probs)
        b.eval(labels, probs)
        assert [a.calculate_auc(c) for c in range(3)] == \
            [b.calculate_auc(c) for c in range(3)]
        assert a.calculate_average_auc() == b.calculate_average_auc()
        assert a.stats() == b.stats()


def test_roc_merge_matches_reference():
    rng = np.random.default_rng(9)
    parts = [(rng.integers(0, 2, 30), rng.random(30)) for _ in range(3)]
    for steps in (0, 8):
        got, want = roc.ROC(steps), ref_roc.ROC(steps)
        for y, p in parts:
            g, w = roc.ROC(steps), ref_roc.ROC(steps)
            g.eval(y, p)
            w.eval(y, p)
            got.merge(g)
            want.merge(w)
        assert got.calculate_auc() == want.calculate_auc()
        assert got.calculate_auprc() == want.calculate_auprc()


def _conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(2).list()
            .layer(pkg.DenseLayer(n_out=6, activation="relu"))
            .layer(pkg.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(5)).build())


def test_network_evaluate_matches_reference():
    port_net = port.MultiLayerNetwork(_conf(port)).init(device="cpu")
    ref_net = ref.MultiLayerNetwork(_conf(ref)).init()
    ref_net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((37, 5)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 37)]
    got, want = port_net.evaluate(x, y, batch_size=8), ref_net.evaluate(x, y, batch_size=8)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.num_examples() == 37
    yr = rng.standard_normal((37, 4)).astype(np.float32)
    r, rr = port_net.evaluate_regression(x, yr), ref_net.evaluate_regression(x, yr)
    np.testing.assert_allclose([r.mean_squared_error(c) for c in range(4)],
                               [rr.mean_squared_error(c) for c in range(4)], rtol=1e-5)
    # a single-output graph evaluates as the MultiLayerNetwork does
    graph = (port.NeuralNetConfiguration.builder().seed(2).graph_builder()
             .add_inputs("in")
             .add_layer("d", port.DenseLayer(n_in=5, n_out=6, activation="relu"), "in")
             .add_layer("out", port.OutputLayer(n_in=6, n_out=4, activation="softmax",
                                                loss="mcxent"), "d")
             .set_outputs("out").build())
    g = port.ComputationGraph(graph).init(device="cpu")
    g.params_tree = {"d": port_net.params_tree[0], "out": port_net.params_tree[1]}
    np.testing.assert_array_equal(g.evaluate(x, y, batch_size=5).confusion,
                                  want.confusion)
