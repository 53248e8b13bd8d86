"""Scikit-learn-compatible estimator wrappers.

Port of `deeplearning4j_tpu/ml/estimator.py` (reference dl4j-spark-ml's
SparkDl4jNetwork.scala, an ML-pipeline Estimator producing a Model with
transform()), re-expressed as the sklearn fit/predict/score duck type so
the nets drop into sklearn Pipelines, GridSearchCV, cross_val_score, etc.
without sklearn being a dependency of this package.

The network is built on `device`: CUDA unless the caller asks for the CPU
(``device="cpu"``), as every entry point of the port. `device` is an
estimator parameter, so ``get_params``/``set_params`` and a clone keep it.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..utils.device import DeviceLike


class _BaseEstimator:
    def __init__(self, conf_builder: Callable[[], object], *,
                 epochs: int = 10, batch_size: int = 32,
                 seed: Optional[int] = None, device: DeviceLike = None):
        self.conf_builder = conf_builder
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.device = device
        self.net_ = None

    # sklearn contract -----------------------------------------------------
    def get_params(self, deep: bool = True) -> dict:
        return {"conf_builder": self.conf_builder, "epochs": self.epochs,
                "batch_size": self.batch_size, "seed": self.seed,
                "device": self.device}

    def set_params(self, **params) -> "_BaseEstimator":
        valid = self.get_params()
        for k, v in params.items():
            if k not in valid:  # hasattr would accept methods/fitted state
                raise ValueError(f"Unknown parameter {k!r}; valid: "
                                 f"{sorted(valid)}")
            setattr(self, k, v)
        return self

    def _build(self):
        from ..nn.multilayer import MultiLayerNetwork
        conf = self.conf_builder()
        net = MultiLayerNetwork(conf)
        return net.init(seed=self.seed, device=self.device)

    def _check_fitted(self):
        if self.net_ is None:
            raise RuntimeError("Call fit() first")


class MLNClassifier(_BaseEstimator):
    """Classifier over a MultiLayerConfiguration factory.

        clf = MLNClassifier(lambda: my_conf(), epochs=20)
        clf.fit(X, y).predict(X_new)

    `y` may be integer class labels or one-hot rows."""

    def fit(self, X, y) -> "MLNClassifier":
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        if y.ndim == 1:  # integer labels → one-hot
            self.classes_ = np.unique(y)
            idx = np.searchsorted(self.classes_, y)
            y1h = np.eye(len(self.classes_), dtype=np.float32)[idx]
        else:
            self.classes_ = np.arange(y.shape[1])
            y1h = np.asarray(y, np.float32)
        self.net_ = self._build()
        self.net_.fit(X, y1h, epochs=self.epochs,
                      batch_size=self.batch_size)
        return self

    def predict_proba(self, X) -> np.ndarray:
        self._check_fitted()
        return np.asarray(self.net_.output(np.asarray(X, np.float32)))

    def predict(self, X) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(X), axis=-1)]

    def score(self, X, y) -> float:
        """Mean accuracy (the sklearn classifier scoring contract)."""
        y = np.asarray(y)
        if y.ndim > 1:
            y = self.classes_[np.argmax(y, axis=-1)]
        return float(np.mean(self.predict(X) == y))


class MLNRegressor(_BaseEstimator):
    """Regressor over a MultiLayerConfiguration factory (output layer
    should carry an mse/mae loss)."""

    def fit(self, X, y) -> "MLNRegressor":
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        self.net_ = self._build()
        self.net_.fit(X, y, epochs=self.epochs, batch_size=self.batch_size)
        return self

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        out = np.asarray(self.net_.output(np.asarray(X, np.float32)))
        return out[:, 0] if out.shape[-1] == 1 else out

    def score(self, X, y) -> float:
        """R² (the sklearn regressor scoring contract)."""
        y = np.asarray(y, np.float32).reshape(-1)
        pred = np.asarray(self.predict(X)).reshape(-1)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / max(ss_tot, 1e-12)
