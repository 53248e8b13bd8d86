"""The port's batch solvers against the JAX package's.

From the same parameters of a small dense net (a 3x3 convolution in
front, so the flat vector holds an HWIO kernel), on the same full batch:

- the flat parameter vector is the JAX package's (`utils/params.py`
  leaf order, the JAX package's layout) and round-trips bitwise;
- `backtrack_line_search` takes the JAX package's step on the same
  direction;
- LineGradientDescent, ConjugateGradient and LBFGS through `fit_solver`
  (the configuration's `optimization_algo`): the per-iteration scores (rtol
  1e-5) and the final parameters (rtol 1e-5, atol 1e-7) after 4 iterations;
- `solver_for` refuses SGD.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
from deeplearning4j_torch.optimize import solvers
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.optimize import solvers as ref_solvers


def _conf(pkg, algo):
    return (pkg.NeuralNetConfiguration.builder().seed(12)
            .optimization_algo(getattr(pkg.OptimizationAlgorithm, algo)).list()
            .layer(pkg.ConvolutionLayer(kernel_size=(3, 3), n_out=2, activation="tanh"))
            .layer(pkg.DenseLayer(n_out=6, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.convolutional(5, 5, 2)).build())


def _data(n=12, seed=13):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5, 5, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _pair(algo="LBFGS"):
    port_net = port.MultiLayerNetwork(_conf(port, algo)).init(device="cpu")
    ref_net = ref.MultiLayerNetwork(_conf(ref, algo)).init()
    ref_net.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(port_net.params_tree))
    return port_net, ref_net


def test_flat_vector_is_the_reference_one_and_round_trips():
    port_net, ref_net = _pair()
    x, y = _data()
    prob = solvers._FlatProblem(port_net, x, y)
    want = ref_solvers._FlatProblem(ref_net, x, y)
    np.testing.assert_array_equal(prob.flat0.numpy(), np.asarray(want.flat0))
    np.testing.assert_array_equal(prob.flat0.numpy(), port_params.flatten_params(
        port_net.params_tree))
    before = port_params.tree_map(torch.clone, port_net.params_tree)
    prob.commit(prob.flat0)
    for a, b in zip(port_params.tree_leaves(before),
                    port_params.tree_leaves(port_net.params_tree)):
        assert torch.equal(a, b) and a.stride() == b.stride()
    f, g = prob.value_and_grad(prob.flat0)
    rf, rg = want.value_and_grad(want.flat0)
    np.testing.assert_allclose(float(f), float(rf), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(prob.value(prob.flat0)), float(f), rtol=1e-7)


def test_line_search_takes_the_reference_step():
    port_net, ref_net = _pair()
    x, y = _data()
    prob, want = solvers._FlatProblem(port_net, x, y), ref_solvers._FlatProblem(ref_net, x, y)
    f, g = prob.value_and_grad(prob.flat0)
    rf, rg = want.value_and_grad(want.flat0)
    for scale in (1.0, 40.0):   # a full step, and one that must shrink
        w, fw = solvers.backtrack_line_search(prob.value, prob.flat0, -scale * g,
                                              float(f), g)
        rw, rfw = ref_solvers.backtrack_line_search(want.value, want.flat0, -scale * rg,
                                                    float(rf), rg)
        np.testing.assert_allclose(fw, rfw, rtol=1e-5)
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("algo", ["LINE_GRADIENT_DESCENT", "CONJUGATE_GRADIENT",
                                  "LBFGS"])
def test_solvers_match_reference(algo):
    port_net, ref_net = _pair(algo)
    x, y = _data()
    got = port_net.fit_solver(x, y, max_iterations=4, tolerance=0.0)
    want = ref_net.fit_solver(x, y, max_iterations=4, tolerance=0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the score returned is the committed parameters' score
    assert got == pytest.approx(port_net.score(x=x, y=y), rel=1e-6)
    solver = solvers.solver_for(port_net.conf.optimization_algo, max_iterations=4,
                                tolerance=0.0)
    ref_solver = ref_solvers.solver_for(ref_net.conf.optimization_algo,
                                        max_iterations=4, tolerance=0.0)
    again, ref_again = _pair(algo)
    solver.optimize(again, x, y)
    ref_solver.optimize(ref_again, x, y)
    np.testing.assert_allclose(solver.scores, ref_solver.scores, rtol=1e-5)
    assert solver.scores[-1] < solver.scores[0]
    for g, w in zip(jax.tree_util.tree_leaves(port_params.params_to_numpy(
            again.params_tree)), jax.tree_util.tree_leaves(ref_again.params_tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)


def test_solver_for_refuses_sgd():
    with pytest.raises(ValueError, match="no batch solver"):
        solvers.solver_for(port.OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT)
