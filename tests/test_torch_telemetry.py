"""The port's shape-churn guard against the JAX package's.

- One sequence of `shape_signature`/`note_step_signature` calls gives the
  same counts, offenders, `recompile_churn_total{fn}` values and one-shot
  warning in both packages.
- The hooks fire from `fit` and `output` of both network types, under the
  JAX package's labels, with the same signature counts.
- The threshold variable (`DL4JTORCH_RECOMPILE_CHURN_THRESHOLD`) works, and
  a bad value falls back to the default as in the JAX package.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
import deeplearning4j_tpu as ref
from deeplearning4j_torch.optimize import metrics as pmetrics
from deeplearning4j_torch.optimize import telemetry as ptel
from deeplearning4j_tpu.optimize import metrics as rmetrics
from deeplearning4j_tpu.optimize import telemetry as rtel

from test_torch_word2vec import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_guards(monkeypatch):
    monkeypatch.delenv(ptel.ENV_CHURN_THRESHOLD, raising=False)
    monkeypatch.delenv(rtel.ENV_CHURN_THRESHOLD, raising=False)
    ptel.reset_churn()
    rtel.reset_churn()
    yield
    ptel.reset_churn()
    rtel.reset_churn()


def _churn(reg, label):
    return reg.registry().counter("recompile_churn_total").value(fn=label)


def _warnings(caplog, logger):
    return [r for r in caplog.records if r.name == logger and r.levelno == logging.WARNING]


def test_signatures_equal_and_metadata_only():
    x = np.zeros((4, 3), np.float32)
    assert ptel.shape_signature(torch.from_numpy(x), None, np.zeros(2, np.int64)) == \
        rtel.shape_signature(jnp.asarray(x), None, np.zeros(2, np.int64)) == \
        (((4, 3), "float32"), None, ((2,), "int64"))
    # a meta tensor has no data at all: the signature reads metadata only
    meta = torch.empty((2, 5), device="meta", dtype=torch.bfloat16)
    assert ptel.shape_signature(meta) == (((2, 5), "bfloat16"),)


def test_same_sequence_same_outcome(monkeypatch, caplog):
    monkeypatch.setenv(ptel.ENV_CHURN_THRESHOLD, "2")
    monkeypatch.setenv(rtel.ENV_CHURN_THRESHOLD, "2")
    caplog.set_level(logging.WARNING)
    calls = [("a", (1, 3)), ("a", (2, 3)), ("a", (1, 3)), ("b", (5,)), ("a", (3, 3)),
             ("a", (4, 3)), ("b", (6,)), ("a", (4, 3)), ("c", (1,)), ("b", (7,)),
             ("b", (8,))]
    labels = {lbl: f"t{id(calls) & 0xffff:04x}-{lbl}" for lbl in "abc"}
    before = {l: (_churn(pmetrics, l), _churn(rmetrics, l)) for l in labels.values()}
    for lbl, shape in calls:
        a = np.zeros(shape, np.float32)
        got = ptel.note_step_signature(labels[lbl], ptel.shape_signature(torch.from_numpy(a)))
        want = rtel.note_step_signature(labels[lbl], rtel.shape_signature(jnp.asarray(a)))
        assert got == want
    assert ptel.churn_offenders() == rtel.churn_offenders()
    assert ptel.churn_offenders(top=1) == [(labels["a"], 4)]
    for l in labels.values():
        assert _churn(pmetrics, l) - before[l][0] == _churn(rmetrics, l) - before[l][1]
    assert _churn(pmetrics, labels["a"]) - before[labels["a"]][0] == 2
    got_w = _warnings(caplog, "deeplearning4j_torch.optimize.telemetry")
    want_w = _warnings(caplog, "deeplearning4j_tpu.optimize.telemetry")
    assert len(got_w) == len(want_w) == 2   # one for "a", one for "b"
    assert "cuDNN" in got_w[0].getMessage() and "XLA" not in got_w[0].getMessage()


def _mlp(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(2).updater(pkg.Sgd(0.1)).list()
            .layer(pkg.DenseLayer(n_out=4, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(3)).build())


def _graph(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(2).updater(pkg.Sgd(0.1))
            .graph_builder().add_inputs("in")
            .add_layer("d", pkg.DenseLayer(n_out=4, activation="tanh"), "in")
            .add_layer("out", pkg.OutputLayer(n_out=2, activation="softmax",
                                              loss="mcxent"), "d")
            .set_outputs("out").set_input_types(pkg.InputType.feed_forward(3)).build())


def _drive(net, fit_kw):
    """Two fits (batch 4, then batch 3 with a ragged tail) and outputs at
    three batch sizes."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 10)]
    net.fit(x[:8], y[:8], epochs=1, batch_size=4, **fit_kw)
    net.fit(x, y, epochs=1, batch_size=3, pad_to_bucket=False, **fit_kw)
    for n in (1, 2, 5, 2):
        net.output(x[:n])


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_hooks_fire_under_the_reference_labels(kind):
    make, cls = (_mlp, "MultiLayerNetwork") if kind == "mln" else (_graph, "ComputationGraph")
    p = getattr(port, cls)(make(port)).init(device="cpu")
    r = getattr(ref, cls)(make(ref)).init()
    _drive(p, {})
    _drive(r, {"use_async": False})
    tag = f"{id(p) & 0xffff:04x}"
    assert p._probe_tag == tag
    got = dict(ptel.churn_offenders(top=10))
    want = {lbl.rsplit("#", 1)[0]: n for lbl, n in rtel.churn_offenders(top=10)}
    assert got == {f"{k}#{tag}": n for k, n in want.items()}
    # batch 4, batch 3 and its ragged tail of 1; outputs at 1, 2 and 5 rows
    assert want == {f"{kind}_train_step": 3, f"{kind}_output": 3}


def test_threshold_variable(monkeypatch, caplog):
    caplog.set_level(logging.WARNING)
    assert ptel.churn_threshold() == ptel.DEFAULT_CHURN_THRESHOLD == 5
    assert ptel.ENV_CHURN_THRESHOLD == "DL4JTORCH_RECOMPILE_CHURN_THRESHOLD"
    monkeypatch.setenv(ptel.ENV_CHURN_THRESHOLD, "not-a-number")
    assert ptel.churn_threshold() == 5
    monkeypatch.setenv(rtel.ENV_CHURN_THRESHOLD, "1")   # the JAX package's has no effect
    assert ptel.churn_threshold() == 5
    monkeypatch.setenv(ptel.ENV_CHURN_THRESHOLD, "1")
    net = port.MultiLayerNetwork(_mlp(port)).init(device="cpu")
    label = f"mln_output#{net._probe_tag}"
    before = _churn(pmetrics, label)
    for n in (1, 2, 3):
        net.output(np.zeros((n, 3), np.float32))
    assert _churn(pmetrics, label) - before == 2
    assert len(_warnings(caplog, "deeplearning4j_torch.optimize.telemetry")) == 1
    assert ptel.churn_offenders()[0] == (label, 3)
