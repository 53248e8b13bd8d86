"""The port's Keras import (`deeplearning4j_torch/keras_import`) against the
JAX package's on the CPU: every fixture imported by both packages gives the
same parameter and state trees, bitwise leaf by leaf, and the recorded
outputs at tests/test_keras_import.py's tolerances; the imported nets train;
the refusals raise the same exceptions; and `KerasBackendServer` answers
/fit and /predict as the JAX package's does."""
import json
import os
import shutil
import urllib.error

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from deeplearning4j_torch.keras_import import (  # noqa: E402
    InvalidKerasConfigurationException, KerasModelImport,
    UnsupportedKerasConfigurationException)
from deeplearning4j_torch.serving import KerasBackendServer  # noqa: E402
from deeplearning4j_torch.utils import params as param_utils  # noqa: E402
from deeplearning4j_torch.utils.http_server import json_request  # noqa: E402
from deeplearning4j_tpu.keras_import import KerasModelImport as RefImport  # noqa: E402
from deeplearning4j_tpu.keras_import import reader as ref_reader  # noqa: E402
from deeplearning4j_tpu.serving import KerasBackendServer as RefServer  # noqa: E402

from test_torch_word2vec import one_torch_thread  # noqa: E402,F401

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "keras")
# (fixture, imported as a graph, rtol, atol against the recorded outputs)
CASES = [("mlp", False, 1e-4, 1e-5), ("cnn", False, 1e-3, 1e-4),
         ("lstm", False, 1e-4, 1e-5), ("act_tail", False, 1e-4, 1e-5),
         ("relu_tail", False, 1e-4, 1e-5), ("cnn_cf", False, 1e-4, 1e-5),
         ("functional", True, 1e-4, 1e-5), ("lstm_last", True, 1e-4, 1e-5),
         ("mlp", True, 1e-4, 1e-5), ("mnist_cnn", False, 1e-5, 1e-7)]


def h5(name):
    return os.path.join(FIX, f"{name}.h5")


@pytest.fixture(scope="module")
def expected():
    e = dict(np.load(os.path.join(FIX, "expected.npz")))
    m = np.load(os.path.join(FIX, "mnist_cnn_expected.npz"))
    e["mnist_cnn_x"], e["mnist_cnn_y"] = m["x"][:16], m["y"][:16]
    return e


def importers(graph):
    if graph:
        return KerasModelImport.import_keras_model_and_weights, \
            RefImport.import_keras_model_and_weights
    return KerasModelImport.import_keras_sequential_model_and_weights, \
        RefImport.import_keras_sequential_model_and_weights


def leaves_bitwise(port_tree, ref_tree):
    mine = param_utils.tree_leaves(param_utils.params_to_numpy(port_tree))
    theirs = [np.asarray(a) for a in param_utils.tree_leaves(ref_tree)]
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def inputs(expected, name):
    x = expected[f"{name}_x"]
    return x.transpose(0, 2, 3, 1) if name == "cnn_cf" else x   # the networks are NHWC


@pytest.mark.parametrize("name, graph, rtol, atol", CASES,
                         ids=[f"{c[0]}-{'graph' if c[1] else 'seq'}" for c in CASES])
def test_import_equals_the_jax_package(expected, name, graph, rtol, atol):
    port_imp, ref_imp = importers(graph)
    mine, theirs = port_imp(h5(name), device="cpu"), ref_imp(h5(name))
    leaves_bitwise(mine.params_tree, theirs.params_tree)
    state = [a for a in param_utils.tree_leaves(theirs.state_tree)]
    if state:
        leaves_bitwise(mine.state_tree, theirs.state_tree)
    got = mine.output(inputs(expected, name))
    np.testing.assert_allclose(got, expected[f"{name}_y"], rtol=rtol, atol=atol)
    assert [type(layer).__name__ for layer in getattr(mine, "layers", [])] == \
        [type(layer).__name__ for layer in getattr(theirs, "layers", [])]


def test_the_mnist_cnn_fixture_is_full_width():
    net = KerasModelImport.import_keras_sequential_model_and_weights(
        h5("mnist_cnn"), device="cpu")
    assert net.num_params() == 1_199_882
    assert [type(layer).__name__ for layer in net.layers] == [
        "ConvolutionLayer", "ConvolutionLayer", "SubsamplingLayer", "DropoutLayer",
        "DenseLayer", "DropoutLayer", "OutputLayer"]
    assert net.layers[-1].loss == "mcxent"


@pytest.mark.parametrize("name", ["mlp", "act_tail", "relu_tail"])
def test_imported_net_trains(expected, name):
    """The terminal layer is a loss head: `fit` lowers the score."""
    net = KerasModelImport.import_keras_sequential_model_and_weights(h5(name), device="cpu")
    x = expected[f"{name}_x"]
    y = np.eye(3, dtype=np.float32)[np.arange(len(x)) % 3]
    before = net.score(x=x, y=y)
    net.fit(x, y, epochs=20, batch_size=len(x))
    assert net.score(x=x, y=y) < before


def test_weights_land_on_the_requested_device():
    net = KerasModelImport.import_keras_sequential_model_and_weights(h5("cnn"), device="cpu")
    leaves = param_utils.tree_leaves(net.params_tree)
    assert all(t.device.type == "cpu" for t in leaves)
    kernel = net.params_tree[0]["W"]
    assert kernel.shape == (8, 1, 3, 3)   # Keras's HWIO [3, 3, 1, 8] as the port's OIHW


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KerasModelImport.import_keras_sequential_model_and_weights(h5("mlp"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KerasBackendServer()


def test_keras2_style_sequential_without_input_layer(tmp_path, expected):
    """A Keras 2 file (no InputLayer; batch_input_shape on the first layer),
    rewritten here with h5py, imports as a graph without losing the first
    layer, in both packages."""
    dst = str(tmp_path / "k2.h5")
    shutil.copy(h5("mlp"), dst)
    with h5py.File(dst, "r+") as f:
        cfg = json.loads(f.attrs["model_config"])
        layers = cfg["config"]["layers"]
        shape = layers[0]["config"].get("batch_shape") or \
            layers[0]["config"].get("batch_input_shape")
        layers.pop(0)
        layers[0]["config"]["batch_input_shape"] = shape
        f.attrs["model_config"] = json.dumps(cfg)
    mine = KerasModelImport.import_keras_model_and_weights(dst, device="cpu")
    theirs = RefImport.import_keras_model_and_weights(dst)
    leaves_bitwise(mine.params_tree, theirs.params_tree)
    np.testing.assert_allclose(mine.output(expected["mlp_x"]), expected["mlp_y"],
                               rtol=1e-4, atol=1e-5)


def rewrite_config(tmp_path, name, edit):
    dst = str(tmp_path / f"{name}_edited.h5")
    shutil.copy(h5(name), dst)
    with h5py.File(dst, "r+") as f:
        cfg = json.loads(f.attrs["model_config"])
        edit(cfg["config"]["layers"])
        f.attrs["model_config"] = json.dumps(cfg)
    return dst


def _reshape(layers):
    layers.insert(2, {"class_name": "Reshape",
                      "config": {"name": "rs", "target_shape": [16]}})


def _mixed_format(layers):
    layers[1]["config"]["data_format"] = "channels_first"
    layers[3]["config"]["data_format"] = "channels_last"


def _unknown_layer(layers):
    layers[1]["class_name"] = "SeparableConv2D"


def _bad_activation(layers):
    layers[1]["config"]["activation"] = "mish"


@pytest.mark.parametrize("name, graph, edit, exc, match", [
    ("functional", False, None, "Invalid", "Not a Sequential"),
    ("cnn_cf", True, None, "Unsupported", "sequential"),
    ("mlp", False, _reshape, "Unsupported", "Reshape"),
    ("cnn", False, _mixed_format, "Unsupported", "mixed orderings"),
    ("cnn", False, _unknown_layer, "Unsupported", "SeparableConv2D"),
    ("mlp", False, _bad_activation, "Unsupported", "mish"),
], ids=["functional_as_sequential", "channels_first_graph", "reshape",
        "mixed_data_format", "unknown_layer", "unknown_activation"])
def test_refusals_raise_the_same_exceptions(tmp_path, name, graph, edit, exc, match):
    path = h5(name) if edit is None else rewrite_config(tmp_path, name, edit)
    port_imp, ref_imp = importers(graph)
    port_exc = {"Invalid": InvalidKerasConfigurationException,
                "Unsupported": UnsupportedKerasConfigurationException}[exc]
    ref_exc = {"Invalid": ref_reader.InvalidKerasConfigurationException,
               "Unsupported": ref_reader.UnsupportedKerasConfigurationException}[exc]
    with pytest.raises(port_exc, match=match):
        port_imp(path, device="cpu")
    with pytest.raises(ref_exc, match=match):
        ref_imp(path)


def test_missing_weights_and_config_refused(tmp_path):
    """A layer with parameters and no weights in the file, and a file with
    no model_config, raise InvalidKerasConfigurationException in both."""
    dst = str(tmp_path / "no_weights.h5")
    shutil.copy(h5("mlp"), dst)
    with h5py.File(dst, "r+") as f:
        del f["model_weights/d2"]
    with pytest.raises(InvalidKerasConfigurationException, match="No weights"):
        KerasModelImport.import_keras_sequential_model_and_weights(dst, device="cpu")
    with pytest.raises(ref_reader.InvalidKerasConfigurationException, match="No weights"):
        RefImport.import_keras_sequential_model_and_weights(dst)
    bare = str(tmp_path / "bare.h5")
    with h5py.File(bare, "w", libver="earliest") as f:
        f.create_dataset("x", data=np.ones(2, np.float32))
    with pytest.raises(InvalidKerasConfigurationException, match="model_config"):
        KerasModelImport.import_keras_sequential_model_and_weights(bare, device="cpu")


def test_backend_server_against_the_jax_package(expected):
    x = expected["mlp_x"].tolist()
    y = np.eye(3)[np.arange(len(x)) % 3].tolist()
    body = {"model_path": h5("mlp"), "features": x, "labels": y, "epochs": 5,
            "batch_size": 5}
    with KerasBackendServer(device="cpu") as mine, RefServer() as theirs:
        fits = [json_request(s.url + "/fit", body, timeout=120) for s in (mine, theirs)]
        assert fits[0]["handle"] == fits[1]["handle"] == "model-0"
        assert fits[0]["iterations"] == fits[1]["iterations"] == 5
        np.testing.assert_allclose(fits[0]["score"], fits[1]["score"], rtol=1e-4)
        preds = [np.asarray(json_request(s.url + "/predict",
                                         {"handle": "model-0", "features": x},
                                         timeout=60)["predictions"])
                 for s in (mine, theirs)]
        assert preds[0].shape == (len(x), 3)
        np.testing.assert_allclose(preds[0], preds[1], rtol=1e-5)
        assert json_request(mine.url + "/health") == json_request(theirs.url + "/health") \
            == {"status": "ok", "models": 1}
        for s in (mine, theirs):
            with pytest.raises(urllib.error.HTTPError) as e:
                json_request(s.url + "/predict", {"handle": "nope", "features": x})
            assert e.value.code == 400
