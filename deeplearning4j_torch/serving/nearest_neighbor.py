"""Nearest-neighbor serving: facade + REST server.

Reference parity: deeplearning4j-nearestneighbor-server's
NearestNeighborsServer.java (Play REST over a VPTree'd corpus; POST /knn
with {ndarray, k} → base64-NDArray JSON DTOs, nearestneighbor/model/) and
NearestNeighbor.java (the per-request search).

Port of `deeplearning4j_tpu/serving/nearest_neighbor.py`: queries batch
into one brute-force top-k on the GPU (clustering/vptree.knn_brute_force)
over a corpus that stays on the device; VPTree remains available for
host-side serving. Play is replaced by stdlib http.server with plain-JSON
DTOs (float lists, not base64 java NDArrays)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..clustering.vptree import VPTree, knn_brute_force
from ..utils.device import DeviceLike, resolve_device
from ..utils.http_server import JsonHttpServer


class NearestNeighbor:
    """One-shot k-NN over a corpus (reference NearestNeighbor.java)."""

    def __init__(self, points, metric: str = "euclidean",
                 use_device: bool = True, device: DeviceLike = None):
        self.points = np.asarray(points, np.float32)
        self.metric = metric
        self.use_device = use_device
        self._tree: Optional[VPTree] = None
        self._corpus: Optional[torch.Tensor] = None
        if use_device:
            #: where the corpus lives and the searches run (default: CUDA)
            self.device = resolve_device(device)
            self._corpus = torch.as_tensor(self.points, device=self.device)
        else:
            self._tree = VPTree(self.points, metric=metric)

    def search(self, query, k: int):
        """→ (indices [Q, k] or [k], distances) — device top-k by default,
        VPTree on host otherwise."""
        q = np.asarray(query, np.float32)
        single = q.ndim == 1
        if self.use_device:
            idx, dist = knn_brute_force(self._corpus, q, k, self.metric,
                                        device=self.device)
            return (idx[0], dist[0]) if single else (idx, dist)
        if single:
            return self._tree.search(q, k)
        pairs = [self._tree.search(row, k) for row in q]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))


class NearestNeighborsServer(JsonHttpServer):
    """REST k-NN server (reference NearestNeighborsServer.java).

    Endpoints:
      POST /knn    {"point": [...] | [[...]], "k": n} →
                   {"results": [{"index": i, "distance": d}, ...]} (or a
                   list of such result lists for batched queries)
      GET  /health → {"status": "ok", "corpus": N, "dim": D}
    """

    def __init__(self, points, port: int = 0, metric: str = "euclidean",
                 use_device: bool = True, pool_size: int = 8,
                 device: DeviceLike = None):
        super().__init__(get_routes={"/health": self._health},
                         post_routes={"/knn": self._knn}, port=port,
                         pool_size=pool_size, expose_metrics=True)
        self.nn = NearestNeighbor(points, metric=metric,
                                  use_device=use_device, device=device)

    def _health(self, _):
        return 200, {"status": "ok",
                     "corpus": int(self.nn.points.shape[0]),
                     "dim": int(self.nn.points.shape[1])}

    def _knn(self, req: dict):
        point = np.asarray(req["point"], np.float32)
        k = int(req.get("k", 5))
        idx, dist = self.nn.search(point, k)
        if point.ndim == 1:
            results = [{"index": int(i), "distance": float(d)}
                       for i, d in zip(idx, dist)]
        else:
            results = [[{"index": int(i), "distance": float(d)}
                        for i, d in zip(row_i, row_d)]
                       for row_i, row_d in zip(idx, dist)]
        return 200, {"results": results}
