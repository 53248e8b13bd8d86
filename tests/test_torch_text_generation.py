"""Zoo TextGenerationLSTM of the torch port against the JAX package's.

- The configuration's JSON equals the JAX package's (two GravesLSTM(256,
  tanh), RnnOutputLayer(mcxent, softmax), RmsProp 0.1, l2 1e-3, Xavier,
  truncated BPTT 50/50), and the parameter leaves follow
  `zoo_param_manifest.json`.
- At the JAX package's test size (tests/test_zoo.py: 12 labels, one-hot
  inputs of 10 steps, batch 2, the zoo's 256 units) from the same
  parameters: `output` (rtol 1e-5, atol 1e-6); the score and gradients of
  one 50-step window (relative norm per leaf 1e-5); one `fit` batch of 60
  steps, two truncated-BPTT windows (50 and 10), after which the score, the
  parameters and RmsProp's state are held to the JAX package's (relative
  norm per leaf 1e-4). The fit runs RmsProp with epsilon 1e-2 in place of
  the zoo's 1e-8 in both packages, as the mini ResNet's test does: a step
  is lr g / (sqrt(v) + eps), so where an element of g is 1e-9 of its
  leaf's (RW's smallest) eps 1e-8 turns the float32 rounding of g into the
  same share of a 0.45 step, 2.7e-3 of the leaf after two windows.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

import deeplearning4j_torch as port
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
from deeplearning4j_tpu.models import zoo as ref_zoo

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LABELS, STEPS = 12, 10


def _one_hot(shape, seed):
    rng = np.random.default_rng(seed)
    return np.eye(LABELS, dtype=np.float32)[rng.integers(0, LABELS, shape)]


def _pair(epsilon=None):
    model = dict(num_labels=LABELS, input_shape=(STEPS, LABELS))
    net = port_zoo.TextGenerationLSTM(**model).init(device="cpu")
    ref_net = ref_zoo.TextGenerationLSTM(**model).init()
    if epsilon is not None:
        for layer in net.layers + ref_net.layers:
            layer.updater = dataclasses.replace(layer.updater, epsilon=epsilon)
    to = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    ref_net.params_tree = to(port_params.params_to_numpy(net.params_tree))
    ref_net.opt_state = to(port_params.opt_state_to_numpy(net.opt_state))
    return net, ref_net


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_conf_and_leaf_order_match_reference():
    mine, theirs = port_zoo.TextGenerationLSTM().conf(), ref_zoo.TextGenerationLSTM().conf()
    assert json.loads(mine.to_json()) == json.loads(theirs.to_json())
    assert mine.backprop_type == port.BackpropType.TRUNCATED_BPTT
    assert mine.tbptt_fwd_length == mine.tbptt_back_length == 50
    with open(os.path.join(FIX, "zoo_param_manifest.json")) as f:
        manifest = json.load(f)["TextGenerationLSTM"]
    tree = port_zoo.TextGenerationLSTM().init(device="cpu").params_tree
    named = tuple({p: f"{i}/{p}" for p in lp} for i, lp in enumerate(tree))
    groups = {}
    for leaf in port_params.tree_leaves(named):
        i, pname = leaf.split("/")
        groups.setdefault(int(i), []).append(pname)
    assert [[k, v] for k, v in groups.items()] == manifest
    assert [tuple(t.shape) for t in tree[0].values()] == \
        [(26, 1024), (256, 1024), (1024,), (256,), (256,), (256,)]


def test_output_matches_reference():
    net, ref_net = _pair()
    x = _one_hot((2, STEPS), seed=0)
    got = net.output(x)
    assert got.shape == (2, STEPS, LABELS)
    np.testing.assert_allclose(got, np.asarray(ref_net.output(x)), rtol=1e-5, atol=1e-6)


def test_window_gradients_match_reference():
    net, ref_net = _pair()
    x, y = _one_hot((2, 50), seed=1), _one_hot((2, 50), seed=2)
    grads, score = net.compute_gradient_and_score(port.DataSet(x, y))
    want, want_score = ref_net.compute_gradient_and_score(ref.DataSet(x, y))
    np.testing.assert_allclose(score, want_score, rtol=1e-5)
    got = port_params.tree_leaves(port_params.params_to_numpy(grads))
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want) == 14
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a, np.asarray(b)) < 1e-5, i


def test_tbptt_fit_matches_reference():
    net, ref_net = _pair(epsilon=1e-2)
    x, y = _one_hot((2, 60), seed=1), _one_hot((2, 60), seed=2)
    net.fit(x, y, batch_size=2)
    ref_net._fit_batch(ref.DataSet(x, y))
    assert net.iteration == ref_net.iteration == 2   # windows of 50 and 10
    assert net._rnn_carry is None
    np.testing.assert_allclose(float(net.score_value), float(ref_net.score_value),
                               rtol=1e-5)
    for what, mine, theirs in (("params", net.params_tree, ref_net.params_tree),
                               ("RmsProp", net.opt_state, ref_net.opt_state)):
        got = port_params.tree_leaves(port_params.params_to_numpy(mine))
        want = jax.tree_util.tree_leaves(theirs)
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert _rel(a, np.asarray(b)) < 1e-4, (what, i)
