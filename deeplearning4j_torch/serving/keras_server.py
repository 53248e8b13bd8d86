"""Keras-backend training server.

Reference parity: deeplearning4j-keras (452 LoC): a py4j GatewayServer
(keras/Server.java:15-18) exposing DeepLearning4jEntryPoint.fit() — a
Keras user ships an HDF5 model (+ batched HDF5 data) and the JVM trains
it. Here the transport is stdlib HTTP+JSON (utils/http_server) and the
import path is the framework's own Keras HDF5 importer:

  POST /fit     {"model_path": "...h5", "features": [...], "labels":
                 [...], "epochs": n, "batch_size": n}
                → trains the imported model, returns final score and a
                  handle id
  POST /predict {"handle": id, "features": [...]} → predictions
  GET  /health

Port of `deeplearning4j_tpu/serving/keras_server.py`: the imported model
lives and trains on the server's device (CUDA unless `device` says
otherwise).
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from ..utils.device import DeviceLike, resolve_device
from ..utils.http_server import JsonHttpServer


class KerasBackendServer(JsonHttpServer):
    def __init__(self, port: int = 0, pool_size: int = 8,
                 device: DeviceLike = None):
        super().__init__(
            get_routes={"/health": self._health},
            post_routes={"/fit": self._fit, "/predict": self._predict},
            port=port, pool_size=pool_size, expose_metrics=True)
        #: where imported models live and train (default: CUDA)
        self.device = resolve_device(device)
        self._models: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._next_id = 0

    def _health(self, _):
        return 200, {"status": "ok", "models": len(self._models)}

    def _fit(self, req: dict):
        from ..keras_import import KerasModelImport
        net = KerasModelImport.import_keras_sequential_model_and_weights(
            req["model_path"], device=self.device)
        x = np.asarray(req["features"], np.float32)
        y = np.asarray(req["labels"], np.float32)
        net.fit(x, y, epochs=int(req.get("epochs", 1)),
                batch_size=int(req.get("batch_size", 32)))
        with self._lock:
            handle = f"model-{self._next_id}"
            self._next_id += 1
            self._models[handle] = net
        return 200, {"handle": handle, "score": float(net.score_value),
                     "iterations": net.iteration}

    def _predict(self, req: dict):
        with self._lock:
            net = self._models.get(req.get("handle"))
        if net is None:
            raise KeyError(f"unknown handle {req.get('handle')!r}")
        out = net.output(np.asarray(req["features"], np.float32))
        return 200, {"predictions": np.asarray(out).tolist()}
