"""The torch port's updater math, schedules and gradient normalization
against the JAX package.

The same numpy gradients and the same starting state go through both
packages' `update` (N = 3 steps, the state carried), `current_rate` and
`normalize_layer_gradients`. Tolerance rtol 1e-6 / atol 1e-7 on float32
elementwise math; the layer norms are sums in another order, so the
normalization cases take rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nn import updaters as port_up
from deeplearning4j_tpu.nn import updaters as ref_up

RTOL, ATOL = 1e-6, 1e-7
STEPS = 3

UPDATERS = ["Sgd", "NoOp", "Nesterovs", "Adam", "AdaMax", "AdaGrad",
            "AdaDelta", "RmsProp"]
SCHEDULES = [
    ("Schedule", {}), ("ExponentialSchedule", {"decay_rate": 0.7}),
    ("InverseSchedule", {"gamma": 0.3, "power": 1.5}),
    ("PolySchedule", {"power": 2.0, "max_iterations": 9}),
    ("SigmoidSchedule", {"gamma": 0.5, "step_size": 4}),
    ("StepSchedule", {"decay_rate": 0.5, "step_size": 3}),
    ("MapSchedule", {"schedule": {2: 0.05, 5: 0.01}}),
]
ITERATIONS = [0, 1, 2, 3, 5, 7, 12]


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {"W": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}


def _np(tree):
    """Nested dict/tuple of arrays or tensors -> the same of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_np(v) for v in tree)
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _assert_tree_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol)
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w, rtol, atol)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _run_steps(ref_u, port_u, iterations):
    params = _grads(-1)
    ref_state = ref_u.init({k: jnp.asarray(v) for k, v in params.items()})
    port_state = port_u.init({k: torch.from_numpy(v) for k, v in params.items()})
    _assert_tree_close(port_state, ref_state)
    for step, it in enumerate(iterations):
        g = _grads(step)
        ref_upd, ref_state = ref_u.update(
            {k: jnp.asarray(v) for k, v in g.items()}, ref_state,
            jnp.asarray(it, jnp.int32))
        port_upd, port_state = port_u.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, port_state, it)
        _assert_tree_close(port_upd, ref_upd)
        _assert_tree_close(port_state, ref_state)


@pytest.mark.parametrize("name", UPDATERS)
def test_updater_steps_match_reference(name):
    kw = {"learning_rate": 0.05} if name != "AdaDelta" else {}
    _run_steps(getattr(ref_up, name)(**kw), getattr(port_up, name)(**kw),
               range(STEPS))


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s for s, _ in SCHEDULES])
def test_schedule_under_sgd_matches_reference(name, kw):
    ref_u = ref_up.Sgd(learning_rate=0.1, schedule=getattr(ref_up, name)(**kw))
    port_u = port_up.Sgd(learning_rate=0.1,
                         schedule=getattr(port_up, name)(**kw))
    for it in ITERATIONS:
        got = port_u.current_rate(it)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.item(), float(ref_u.current_rate(jnp.asarray(it, jnp.int32))),
            rtol=RTOL)
    _run_steps(ref_u, port_u, ITERATIONS[::2][:STEPS + 1])


@pytest.mark.parametrize("mode", list(port_up.GradientNormalization),
                         ids=lambda m: m.name)
@pytest.mark.parametrize("scale", [0.05, 3.0], ids=["under", "over"])
def test_gradient_normalization_matches_reference(mode, scale):
    g = {k: v * scale for k, v in _grads(7).items()}
    ref_mode = ref_up.GradientNormalization(mode.value)
    want = ref_up.normalize_layer_gradients(
        {k: jnp.asarray(v) for k, v in g.items()}, ref_mode, 0.5)
    got = port_up.normalize_layer_gradients(
        {k: torch.from_numpy(v) for k, v in g.items()}, mode, 0.5)
    _assert_tree_close(got, want, rtol=1e-5)
    # a layer without parameters passes through every mode
    assert port_up.normalize_layer_gradients({}, mode, 0.5) == {}
