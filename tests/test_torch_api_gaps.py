"""The gaps the port had in modules already ported, closed and held to the
JAX package.

- Every public name of the JAX package's `__init__` (and of its `data`
  package) imports from the port's.
- `MultiLayerNetwork.params` / `set_params` round-trip bitwise, and `clone`
  copies parameters, optimizer state, layer state and counters, sharing no
  storage; `summary()` prints the JAX package's text for LeNet and AlexNet.
- `model_selector` builds every `ZooType` (the same members as the JAX
  package's), with the JAX package's configuration JSON.
- `ImageNetLabels` decodes as the JAX package's from a small file the test
  writes.
- A registered activation survives a configuration's JSON round trip.
- The fault grammar: over 30 calls every form fires on the JAX package's
  call numbers; `kill:` and arming from the environment run in a child
  process; `reset`, `call_count`, `fired_count` and `injected`.
"""
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch as port
import deeplearning4j_torch.data as port_data
from deeplearning4j_torch.models import labels as port_labels
from deeplearning4j_torch.models import zoo as port_zoo
from deeplearning4j_torch.ops import activations as port_act
from deeplearning4j_torch.utils import faults as port_faults
from deeplearning4j_torch.utils import params as port_params
import deeplearning4j_tpu as ref
import deeplearning4j_tpu.data as ref_data
from deeplearning4j_tpu.models import labels as ref_labels
from deeplearning4j_tpu.models import zoo as ref_zoo
from deeplearning4j_tpu.utils import faults as ref_faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public(mod):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not isinstance(v, types.ModuleType))


@pytest.mark.parametrize("pair", ["package", "data"])
def test_every_reference_export_imports_from_the_port(pair):
    want, got = (ref, port) if pair == "package" else (ref_data, port_data)
    missing = [n for n in _public(want) if not hasattr(got, n)]
    assert not missing
    if pair == "package":
        assert port.__version__ == ref.__version__
        for name in ("AutoEncoder", "VariationalAutoencoder", "RBM", "Evaluation",
                     "MnistDataSetIterator", "CSVRecordReader", "TransferLearning"):
            assert getattr(port, name).__module__.startswith("deeplearning4j_torch")


def _mlp(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(3)
            .updater(pkg.Adam(learning_rate=1e-2)).list()
            .layer(pkg.ConvolutionLayer(kernel_size=(2, 2), n_out=3, activation="relu"))
            .layer(pkg.BatchNormalization())
            .layer(pkg.DenseLayer(n_out=6, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(pkg.InputType.convolutional(5, 5, 2)).build())


def _xy(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 5, 5, 2)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def test_params_and_set_params_round_trip_bitwise():
    net = port.MultiLayerNetwork(_mlp(port)).init(device="cpu")
    flat = net.params()
    assert flat.shape == (net.num_params(),) and flat.dtype == np.float32
    want = ref.MultiLayerNetwork(_mlp(ref)).init()
    want.params_tree = jax.tree_util.tree_map(
        jnp.asarray, port_params.params_to_numpy(net.params_tree))
    np.testing.assert_array_equal(flat, np.asarray(want.params()))
    before = port_params.tree_copy(net.params_tree)
    net.set_params(flat + 1.0)
    np.testing.assert_array_equal(net.params(), flat + 1.0)
    assert net.params_tree[0]["W"].is_contiguous(memory_format=torch.channels_last)
    net.set_params(flat)
    for a, b in zip(port_params.tree_leaves(before),
                    port_params.tree_leaves(net.params_tree)):
        assert torch.equal(a, b) and a.stride() == b.stride()
    with pytest.raises(ValueError):
        net.set_params(flat[:-1])


def test_clone_copies_every_tree_and_counter():
    net = port.MultiLayerNetwork(_mlp(port)).init(device="cpu")
    x, y = _xy()
    net.fit(x, y, batch_size=4)
    twin = net.clone()
    assert (twin.iteration, twin.epoch) == (net.iteration, net.epoch) == (2, 1)
    for tree in ("params_tree", "opt_state", "state_tree"):
        a, b = (port_params.tree_leaves(getattr(m, tree)) for m in (net, twin))
        assert len(a) == len(b) > 0
        for u, v in zip(a, b):
            assert torch.equal(u, v) and u.data_ptr() != v.data_ptr()
    np.testing.assert_array_equal(twin.output(x), net.output(x))
    twin.fit(x, y, batch_size=4)   # training the clone leaves the original
    net2 = net.clone()
    np.testing.assert_array_equal(net2.output(x), net.output(x))
    assert not np.array_equal(twin.output(x), net.output(x))
    fresh = port.MultiLayerNetwork(_mlp(port)).clone()
    assert not fresh._initialized


@pytest.mark.parametrize("name,kw", [("LeNet", {}), ("AlexNet", dict(
    input_shape=(60, 60, 3), num_labels=10))])
def test_summary_is_the_reference_text(name, kw):
    got = getattr(port_zoo, name)(**kw).init(device="cpu").summary()
    want_net = getattr(ref_zoo, name)(**kw).conf()
    want = ref.MultiLayerNetwork(want_net)
    assert port.MultiLayerNetwork(getattr(port_zoo, name)(**kw).conf()).summary() \
        == want.summary()   # uninitialized: "?" counts
    want._initialized = True
    want.params_tree = jax.eval_shape(
        lambda: tuple(l.init_params(jax.random.PRNGKey(0)) for l in want.layers))
    want.num_params = lambda: sum(int(np.prod(a.shape)) for a in
                                  jax.tree_util.tree_leaves(want.params_tree))
    assert got == want.summary()


def test_model_selector_covers_every_zoo_type():
    assert [(t.name, t.value) for t in port_zoo.ZooType] == \
        [(t.name, t.value) for t in ref_zoo.ZooType]
    for t in port_zoo.ZooType:
        model = port_zoo.model_selector(t, num_labels=7)
        want = ref_zoo.model_selector(ref_zoo.ZooType[t.name], num_labels=7)
        assert type(model).__name__ == type(want).__name__
        assert model.conf().to_json() == want.conf().to_json(), t
    with pytest.raises(ValueError):
        port_zoo.model_selector("lenet")


def test_imagenet_labels_decode_as_the_reference(tmp_path):
    path = tmp_path / "imagenet_class_index.json"
    path.write_text(json.dumps({str(i): [f"n{i:08d}", f"class {i}"] for i in range(6)}))
    got, want = port_labels.ImageNetLabels(str(path)), ref_labels.ImageNetLabels(str(path))
    assert len(got) == 6 and got.get_label(4) == "class 4" and got.wnid(2) == want.wnid(2)
    p = np.random.default_rng(2).random((3, 6)).astype(np.float32)
    assert got.decode_predictions(p, top=3) == want.decode_predictions(p, top=3)
    assert got.decode_predictions(p[0], top=1) == want.decode_predictions(p[0], top=1)
    with pytest.raises(ValueError, match="classes"):
        got.decode_predictions(p[:, :5])


def test_registered_activation_survives_json():
    port_act.register_activation("Cube3", lambda x: 3.0 * x * x * x)
    conf = (port.NeuralNetConfiguration.builder().seed(1).list()
            .layer(port.DenseLayer(n_out=4, activation="cube3"))
            .layer(port.OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(port.InputType.feed_forward(3)).build())
    back = port.MultiLayerConfiguration.from_json(conf.to_json())
    assert back.layers[0].activation == "cube3"
    net = port.MultiLayerNetwork(back).init(device="cpu")
    x = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    hidden = net.feed_forward(x)[1]
    pre = x @ net.params_tree[0]["W"].numpy() + net.params_tree[0]["b"].numpy()
    np.testing.assert_allclose(hidden, 3.0 * pre ** 3, rtol=1e-5)


# ------------------------------------------------------------- fault grammar

SPECS = ["fail:2", "fail:1,3", "fail:2-4", "fail:2/5", "fail:*", "fail:",
         "fail:1-3,10/7,29", "delay:3/4@0", "delay:*@0"]


def _fired(faults, spec, calls=30):
    faults.inject("grammar.point", spec)
    try:
        out = []
        for n in range(1, calls + 1):
            before = faults.fired_count("grammar.point")
            try:
                faults.fire("grammar.point")
            except faults.FaultInjected:
                pass
            if faults.fired_count("grammar.point") > before:
                out.append(n)
        assert faults.call_count("grammar.point") == calls
        return out
    finally:
        faults.clear("grammar.point")


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_fires_on_the_reference_calls(spec):
    got = _fired(port_faults, spec)
    assert got == _fired(ref_faults, spec)
    assert got   # every form selects something in 30 calls


@pytest.mark.parametrize("spec", ["boom:1", "fail:0", "fail:0/3", "fail:2/0",
                                  "fail:a-b", "delay:1", "delay:1@-5"])
def test_fault_grammar_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError):
        ref_faults.inject("grammar.bad", spec)
    with pytest.raises(ValueError):
        port_faults.inject("grammar.bad", spec)


def test_environment_arming_reset_and_counters(monkeypatch):
    assert port_faults._env_var("serve.pack-x") == "DL4JTPU_FAULT_SERVE_PACK_X"
    monkeypatch.setenv("DL4JTPU_FAULT_GRAMMAR_ENV", "fail:2")
    port_faults.reset()
    try:
        port_faults.fire("grammar.env")
        with pytest.raises(port_faults.FaultInjected, match="call #2"):
            port_faults.fire("grammar.env")
        assert (port_faults.call_count("grammar.env"),
                port_faults.fired_count("grammar.env")) == (2, 1)
        port_faults.clear("grammar.env")   # a cleared point does not re-arm
        port_faults.fire("grammar.env")
        port_faults.fire("grammar.env")
        assert port_faults.call_count("grammar.env") == 0
        with port_faults.injected("grammar.env", "fail:1"):   # explicit wins
            with pytest.raises(port_faults.FaultInjected):
                port_faults.fire("grammar.env")
        port_faults.reset()   # forgets the clear: the variable arms again
        port_faults.fire("grammar.env")
        assert port_faults.check("grammar.env") is True
    finally:
        monkeypatch.delenv("DL4JTPU_FAULT_GRAMMAR_ENV")
        port_faults.reset()


_CHILD = r"""
import importlib.util, sys
sys.modules["jax"] = None
# the module alone (it is stdlib-only): the child need not import torch
spec = importlib.util.spec_from_file_location(
    "faults", "deeplearning4j_torch/utils/faults.py")
faults = importlib.util.module_from_spec(spec)
spec.loader.exec_module(faults)
for n in range(1, 6):
    faults.fire("crash.point")
    print(n, flush=True)
"""


@pytest.mark.parametrize("spec,code,printed", [
    ("kill:3", -9, "1 2"), ("fail:2-3", 1, "1"), ("delay:*@1", 0, "1 2 3 4 5")])
def test_env_armed_child_process(spec, code, printed):
    env = dict(os.environ, DL4JTPU_FAULT_CRASH_POINT=spec)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == code
    assert proc.stdout.split() == printed.split()
