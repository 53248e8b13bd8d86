"""The port's ml/ estimators against the JAX package's.

Both estimators fit from the JAX package's initial parameters (the port's
`_build` is patched in the test to carry them) on the same data in the
same order: `predict_proba` and the predictions within atol 1e-5, the
classifier's accuracy and the regressor's R² within 1e-5. The sklearn
parameter contract as tests/test_ml_estimators.py checks it, plus `device`.
"""
import jax
import numpy as np
import pytest

import deeplearning4j_torch as port
import deeplearning4j_tpu as ref
from deeplearning4j_torch import ml as pml
from deeplearning4j_torch.ml import estimator as pest
from deeplearning4j_torch.utils import params as port_params
from deeplearning4j_tpu import ml as rml

from test_torch_word2vec import one_torch_thread  # noqa: F401


def _clf_conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(1).updater(pkg.Adam(0.05))
            .list()
            .layer(pkg.DenseLayer(n_out=16, activation="relu"))
            .layer(pkg.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(pkg.InputType.feed_forward(4)).build())


def _reg_conf(pkg):
    return (pkg.NeuralNetConfiguration.builder().seed(2).updater(pkg.Adam(0.02))
            .list()
            .layer(pkg.DenseLayer(n_out=16, activation="tanh"))
            .layer(pkg.OutputLayer(n_out=1, activation="identity", loss="mse"))
            .set_input_type(pkg.InputType.feed_forward(3)).build())


@pytest.fixture
def carried_build(monkeypatch):
    """The port estimator's `_build` starts from the JAX package's initial
    parameters and updater state, on the CPU."""
    def build(self):
        conf = self.conf_builder()
        r = ref.MultiLayerNetwork(self.ref_conf()).init(seed=self.seed)
        p = port.MultiLayerNetwork(conf).init(seed=self.seed, device=self.device)
        to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
        p.params_tree = port_params.params_from_numpy(to_np(r.params_tree), self.device)
        p.opt_state = port_params.opt_state_from_numpy(to_np(r.opt_state), self.device)
        return p
    monkeypatch.setattr(pest._BaseEstimator, "_build", build)


def _pair(cls_name, make_conf, **kw):
    r = getattr(rml, cls_name)(lambda: make_conf(ref), **kw)
    p = getattr(pml, cls_name)(lambda: make_conf(port), device="cpu", **kw)
    p.ref_conf = lambda: make_conf(ref)
    return r, p


def test_classifier_matches_reference(carried_build):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((150, 4)).astype(np.float32)
    y = np.array([10, 20, 30])[(X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)]
    r, p = _pair("MLNClassifier", _clf_conf, epochs=4, batch_size=32)
    r.fit(X, y)
    p.fit(X, y)
    assert p.net_.device.type == "cpu"
    np.testing.assert_allclose(p.predict_proba(X), r.predict_proba(X), atol=1e-5)
    assert np.array_equal(p.predict(X), r.predict(X))
    assert set(p.predict(X[:5])) <= {10, 20, 30}
    assert abs(p.score(X, y) - r.score(X, y)) <= 1e-5
    onehot = np.eye(3, dtype=np.float32)[np.searchsorted([10, 20, 30], y)]
    assert abs(p.score(X, onehot) - r.score(X, onehot)) <= 1e-5


def test_regressor_matches_reference(carried_build):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((200, 3)).astype(np.float32)
    y = 2.0 * X[:, 0] - X[:, 1] + 0.1 * rng.standard_normal(200)
    r, p = _pair("MLNRegressor", _reg_conf, epochs=6, batch_size=50)
    r.fit(X, y)
    p.fit(X, y)
    np.testing.assert_allclose(p.predict(X), r.predict(X), atol=1e-5)
    assert p.predict(X[:7]).shape == (7,)
    assert abs(p.score(X, y) - r.score(X, y)) <= 1e-5


@pytest.mark.parametrize("cls_name", ["MLNClassifier", "MLNRegressor"])
def test_params_contract(cls_name):
    est = getattr(pml, cls_name)(lambda: _clf_conf(port), epochs=40, batch_size=32,
                                 device="cpu")
    want = getattr(rml, cls_name)(lambda: _clf_conf(ref), epochs=40, batch_size=32)
    params = est.get_params()
    assert set(params) == set(want.get_params()) | {"device"}
    assert params["device"] == "cpu" and params["epochs"] == 40
    clone = type(est)(**params)   # sklearn's clone: the constructor from get_params
    assert clone.get_params() == params
    est.set_params(epochs=5, device="cuda")
    assert (est.epochs, est.device) == (5, "cuda")
    with pytest.raises(ValueError, match="Unknown parameter 'bogus'"):
        est.set_params(bogus=1)
    unfitted = type(est)(lambda: _clf_conf(port))
    with pytest.raises(RuntimeError, match="fit"):
        getattr(unfitted, "predict_proba", unfitted.predict)(np.zeros((1, 4), np.float32))


def test_default_device_is_cuda():
    """Without `device`, the estimator builds on CUDA, and without a GPU
    that raises instead of training on the CPU."""
    import torch
    est = pml.MLNClassifier(lambda: _clf_conf(port), epochs=1)
    assert est.get_params()["device"] is None
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.fit(np.zeros((4, 4), np.float32), np.array([0, 1, 2, 0]))
