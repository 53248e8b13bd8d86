"""The port's listeners against the JAX package's, on the same training run
(one small dense net, the same parameters and batches in both packages).

- ScoreIterationListener: the same lines (scores to 6 decimals, rtol 1e-5
  read back).
- CollectScoresIterationListener: the same (iteration, score) pairs (rtol
  1e-5).
- ParamAndGradientIterationListener: the same header and rows (rtol 1e-5,
  atol 1e-7 on the values).
- EvaluativeListener (per epoch and per N iterations) and
  ComposableIterationListener: the same evaluations.
- PerformanceListener: a report per `frequency` with the etl split, written
  into the metrics registry; no compile count (torch compiles nothing per
  shape).
- CheckpointListener in directory mode (files kept and pruned as the JAX
  package keeps them) and in manager mode (the manager's cadence).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeplearning4j_torch as port
from deeplearning4j_torch.optimize import listeners as L
from deeplearning4j_torch.optimize import metrics as port_metrics
from deeplearning4j_torch.optimize.resilience import CheckpointManager
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.optimize import listeners as RL


def _conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(6)
            .updater(pkg.Sgd(learning_rate=0.2)).list()
            .layer(pkg.DenseLayer(n_out=6, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(4)).build())


def _pair():
    port_net = port.MultiLayerNetwork(_conf(port)).init(device="cpu")
    ref_net = ref.MultiLayerNetwork(_conf(ref)).init()
    ref_net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    return port_net, ref_net


def _data(n=20, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _fit_both(port_l, ref_l, epochs=2, batch_size=5):
    port_net, ref_net = _pair()
    port_net.set_listeners(*port_l)
    ref_net.set_listeners(*ref_l)
    x, y = _data()
    port_net.fit(x, y, epochs=epochs, batch_size=batch_size)
    ref_net.fit(x, y, epochs=epochs, batch_size=batch_size, use_async=False)
    return port_net, ref_net


def _scores(lines):
    return [(l.split()[3], float(l.split()[-1])) for l in lines]


def test_score_and_collect_listeners_match_reference():
    got, want = [], []
    pc, rc = L.CollectScoresIterationListener(2), RL.CollectScoresIterationListener(2)
    _fit_both([L.ScoreIterationListener(3, printer=got.append), pc],
              [RL.ScoreIterationListener(3, printer=want.append), rc])
    assert len(got) == len(want) == 2
    for (gi, gs), (wi, ws) in zip(_scores(got), _scores(want)):
        assert gi == wi
        np.testing.assert_allclose(gs, ws, rtol=1e-5)
    assert [i for i, _ in pc.scores] == [i for i, _ in rc.scores] == [2, 4, 6, 8]
    np.testing.assert_allclose([s for _, s in pc.scores], [s for _, s in rc.scores],
                               rtol=1e-5)


def test_param_and_gradient_listener_matches_reference():
    got, want = [], []
    _fit_both([L.ParamAndGradientIterationListener(frequency=2, printer=got.append)],
              [RL.ParamAndGradientIterationListener(frequency=2, printer=want.append)])
    assert got[0] == want[0]   # the header
    assert len(got) == len(want) == 5
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose([float(v) for v in g.split("\t")],
                                   [float(v) for v in w.split("\t")],
                                   rtol=1e-5, atol=1e-7)


def test_evaluative_and_composable_listeners_match_reference():
    x, y = _data(12, seed=8)
    pe = L.EvaluativeListener(x, y, frequency=3, each_epoch=True, callback=lambda m, e: None)
    re = RL.EvaluativeListener(x, y, frequency=3, each_epoch=True, callback=lambda m, e: None)
    pc, rc = L.CollectScoresIterationListener(), RL.CollectScoresIterationListener()
    _fit_both([L.ComposableIterationListener(pe, pc)],
              [RL.ComposableIterationListener(re, rc)])
    assert len(pe.evaluations) == len(re.evaluations) == 2 + 2
    for g, w in zip(pe.evaluations, re.evaluations):
        np.testing.assert_array_equal(g.confusion, w.confusion)
    assert len(pc.scores) == len(rc.scores) == 8


def test_performance_listener_reports_etl_and_writes_the_registry():
    lines = []
    perf = L.PerformanceListener(frequency=2, printer=lines.append)
    perf.set_batch_size(5)
    port_net, _ = _fit_both([perf], [])
    reg = port_metrics.registry()
    assert len(lines) == 3   # reports at 4, 6, 8 after the first at 2
    assert all("batches/sec" in l and "samples/sec" in l and "etl" in l
               and "h2d" in l for l in lines)
    assert not any("compil" in l for l in lines)
    assert not hasattr(perf, "last_compile_delta")
    assert reg.gauge("train_score").value() == pytest.approx(float(port_net.score_value))
    assert reg.gauge("train_batches_per_sec").value() > 0
    quiet = L.PerformanceListener(frequency=2, printer=lines.append, fence=False)
    _fit_both([quiet], [])
    assert lines[-1].endswith("[dispatch-side]")


def test_checkpoint_listener_matches_reference_file_sets(tmp_path):
    pd, rd = tmp_path / "port", tmp_path / "ref"
    pl = L.CheckpointListener(str(pd), every_n_iterations=3, every_n_epochs=1,
                              keep_last=2)
    rl = RL.CheckpointListener(str(rd), every_n_iterations=3, every_n_epochs=1,
                               keep_last=2)
    _fit_both([pl], [rl])
    assert sorted(os.listdir(pd)) == sorted(os.listdir(rd)) == \
        ["checkpoint_epoch_2.zip", "checkpoint_iter_6.zip"]
    restored = port.restore_model(str(pd / "checkpoint_epoch_2.zip"), device="cpu")
    assert restored.iteration == 8 and restored.epoch == 2
    mgr = CheckpointManager(str(tmp_path / "mgr"), save_every_n_iterations=4,
                            keep_last=5)
    _fit_both([mgr.listener()], [])
    assert [r["iteration"] for r in mgr.checkpoints()] == [4, 8]
    with pytest.raises(ValueError, match="exactly one"):
        L.CheckpointListener()
