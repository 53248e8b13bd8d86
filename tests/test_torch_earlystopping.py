"""The port's early stopping against the JAX package's.

From the same parameters, the same data and the same configuration:

- each epoch termination condition (MaxEpochs, ScoreImprovement with and
  without a minimum, BestScore) and iteration condition (MaxScore,
  InvalidScore on a NaN batch): the same termination reason, details, best
  epoch, total epochs and score per epoch (rtol 1e-5);
- the best model from InMemoryModelSaver and from LocalFileModelSaver
  answers as the network did when it was saved (bitwise, on the CPU), and
  matches the JAX package's best model (rtol 1e-5, atol 1e-7);
- the termination conditions alone, on the same score sequences;
- EarlyStoppingGraphTrainer over a ComputationGraph, and
  EarlyStoppingParallelTrainer over a two-shard ParallelWrapper, which
  trains as the plain fit does.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeplearning4j_torch as port
from deeplearning4j_torch import earlystopping as es
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu import earlystopping as res


def _conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(9)
            .updater(pkg.Sgd(learning_rate=0.3)).list()
            .layer(pkg.DenseLayer(n_out=8, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(4)).build())


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int) + (x[:, 1] > 1)]
    return x, y


TRAIN, HELD = _data(24, 1), _data(16, 2)


def _nets():
    port_net = port.MultiLayerNetwork(_conf(port)).init(device="cpu")
    ref_net = ref.MultiLayerNetwork(_conf(ref)).init()
    ref_net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    return port_net, ref_net


def _held_loss(model):
    return model.score(x=HELD[0], y=HELD[1])


def _configure(mod, epoch_conds, iter_conds, saver, calculator=_held_loss):
    b = (mod.EarlyStoppingConfiguration.builder()
         .epoch_termination_conditions(*epoch_conds)
         .iteration_termination_conditions(*iter_conds)
         .score_calculator(calculator)
         .model_saver(saver)
         .save_last_model(True))
    return b.build()


CASES = {
    "max_epochs": lambda m: ([m.MaxEpochsTerminationCondition(3)], []),
    "score_improvement": lambda m: (
        [m.ScoreImprovementEpochTerminationCondition(1, min_improvement=0.05),
         m.MaxEpochsTerminationCondition(12)], []),
    "best_score": lambda m: ([m.BestScoreEpochTerminationCondition(0.9),
                              m.MaxEpochsTerminationCondition(12)], []),
    "max_score": lambda m: ([m.MaxEpochsTerminationCondition(5)],
                            [m.MaxScoreIterationTerminationCondition(0.5)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_result_matches_reference(case):
    port_net, ref_net = _nets()
    got = es.EarlyStoppingTrainer(
        _configure(es, *CASES[case](es), es.InMemoryModelSaver()), port_net,
        *TRAIN, batch_size=8).fit(max_epochs=20)
    want = res.EarlyStoppingTrainer(
        _configure(res, *CASES[case](res), res.InMemoryModelSaver()), ref_net,
        *TRAIN, batch_size=8).fit(max_epochs=20)
    assert got.termination_reason.value == want.termination_reason.value
    assert got.termination_details == want.termination_details
    assert (got.best_model_epoch, got.total_epochs) == \
        (want.best_model_epoch, want.total_epochs)
    assert sorted(got.score_vs_epoch) == sorted(want.score_vs_epoch)
    np.testing.assert_allclose([got.score_vs_epoch[k] for k in sorted(got.score_vs_epoch)],
                               [want.score_vs_epoch[k] for k in sorted(want.score_vs_epoch)],
                               rtol=1e-5)
    if got.best_model_epoch > 0:
        best = jax.tree_util.tree_leaves(
            port_params.params_to_numpy(got.best_model.params_tree))
        for g, w in zip(best, jax.tree_util.tree_leaves(want.best_model.params_tree)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)
    assert not any(type(l).__name__ == "_IterCheck" for l in port_net.listeners)


def test_invalid_score_stops_on_a_nan_batch():
    x, y = TRAIN[0].copy(), TRAIN[1]
    x[9, 0] = np.nan
    results = []
    for mod, net in zip((es, res), _nets()):
        conf = _configure(mod, [mod.MaxEpochsTerminationCondition(4)],
                          [mod.InvalidScoreIterationTerminationCondition()],
                          mod.InMemoryModelSaver())
        results.append(mod.EarlyStoppingTrainer(conf, net, x, y, batch_size=8).fit())
    got, want = results
    assert got.termination_reason.value == want.termination_reason.value == \
        "iteration_termination"
    assert got.termination_details == want.termination_details == "InvalidScore()"
    assert got.total_epochs == want.total_epochs == 0


def test_local_file_saver_restores_the_best_model_bitwise(tmp_path):
    port_net, _ = _nets()
    saver = es.LocalFileModelSaver(str(tmp_path))
    seen = {}
    inner = saver.save_best_model

    def remember(model, score):
        inner(model, score)
        seen["answer"] = model.output(HELD[0])
        seen["epoch"] = model.epoch

    saver.save_best_model = remember
    result = es.EarlyStoppingTrainer(
        _configure(es, [es.MaxEpochsTerminationCondition(3)], [], saver),
        port_net, *TRAIN, batch_size=8).fit()
    best = result.best_model
    assert best.device.type == "cpu" and best.epoch == seen["epoch"]
    np.testing.assert_array_equal(best.output(HELD[0]), seen["answer"])
    assert (tmp_path / "latestModel.zip").exists()


def test_in_memory_saver_keeps_copies_not_aliases():
    port_net, _ = _nets()
    saver = es.InMemoryModelSaver()
    saver.save_best_model(port_net, 1.0)
    answer = port_net.output(HELD[0])
    port_net.fit(*TRAIN, batch_size=8)
    best = saver.get_best_model()
    assert best.epoch == 0 and best is not port_net
    np.testing.assert_array_equal(best.output(HELD[0]), answer)
    assert not np.array_equal(port_net.output(HELD[0]), answer)


@pytest.mark.parametrize("scores", [[3.0, 2.0, 2.5, 2.4, 1.0], [1.0, 1.0, 1.0],
                                    [5.0, 4.9, 4.85, 4.84, 4.83]])
def test_termination_conditions_match_reference(scores):
    def run(mod):
        conds = [mod.ScoreImprovementEpochTerminationCondition(2, 0.01),
                 mod.BestScoreEpochTerminationCondition(1.5),
                 mod.MaxEpochsTerminationCondition(4)]
        out = []
        for c in conds:
            c.initialize()
            out.append([c.terminate(e + 1, s) for e, s in enumerate(scores)])
        its = [mod.MaxScoreIterationTerminationCondition(2.9),
               mod.InvalidScoreIterationTerminationCondition()]
        out.append([[c.terminate(s) for s in scores + [math.inf]] for c in its])
        return out, [str(c) for c in conds + its]
    assert run(es) == run(res)


def test_graph_trainer_and_parallel_trainer():
    conf = (port.NeuralNetConfiguration.builder().seed(9)
            .updater(port.Sgd(learning_rate=0.3)).graph_builder()
            .add_inputs("in")
            .add_layer("d", port.DenseLayer(n_in=4, n_out=8, activation="tanh"), "in")
            .add_layer("out", port.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                               loss="mcxent"), "d")
            .set_outputs("out").build())
    graph = port.ComputationGraph(conf).init(device="cpu")
    result = es.EarlyStoppingGraphTrainer(
        _configure(es, [es.MaxEpochsTerminationCondition(2)], [],
                   es.InMemoryModelSaver(),
                   lambda m: m.score(port.DataSet(*HELD))),
        graph, *TRAIN, batch_size=8).fit()
    assert result.total_epochs == 2 and graph.iteration == 6
    assert isinstance(result.best_model, port.ComputationGraph)
    from deeplearning4j_torch.parallel import ParallelWrapper, data_parallel_mesh
    mln = port.MultiLayerNetwork(
        (port.NeuralNetConfiguration.builder().seed(9)
         .updater(port.Sgd(learning_rate=0.3)).list()
         .layer(port.DenseLayer(n_in=4, n_out=8, activation="tanh"))
         .layer(port.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="mcxent")).build())).init(device="cpu")
    single = port.MultiLayerNetwork(mln.conf.clone()).init(device="cpu")
    wrapper = ParallelWrapper(mln, mesh=data_parallel_mesh(
        devices=["cpu", "cpu"]))
    result = es.EarlyStoppingParallelTrainer(
        _configure(es, [es.MaxEpochsTerminationCondition(2)], [],
                   es.InMemoryModelSaver()), wrapper, *TRAIN,
        batch_size=8).fit()
    single.fit(*TRAIN, epochs=2, batch_size=8)
    assert result.total_epochs == 2 and mln.iteration == single.iteration == 6
    np.testing.assert_allclose(mln.params(), single.params(), rtol=1e-5,
                               atol=1e-6)
