"""KMeans clustering.

Reference parity: clustering/kmeans/KMeansClustering.java (Lloyd
iterations over a generic cluster framework, clustering/algorithm/).

Port of `deeplearning4j_tpu/clustering/kmeans.py`: each Lloyd iteration is
a few device operations on torch tensors — the [N, D] x [D, K] distance
product, the argmin assignment (the first centroid among equal distances)
and the centroid update, whose per-cluster sums are one `index_add_` (the
JAX package multiplies by a one-hot matrix; the sums are the same, in
another order) — instead of the reference's per-point Java loops. The
initial centroids are the JAX package's numpy draw, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..utils.device import DeviceLike, resolve_device


class KMeansClustering:
    def __init__(self, k: int, max_iterations: int = 100,
                 tolerance: float = 1e-4, seed: int = 0,
                 metric: str = "euclidean", device: DeviceLike = None):
        self.k = int(k)
        self.max_iterations = int(max_iterations)
        self.tolerance = float(tolerance)
        self.seed = int(seed)
        if metric != "euclidean":
            raise ValueError("KMeans supports euclidean distance")
        #: where the iterations run (default: CUDA, raising when there is none)
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.iterations_run = 0

    @staticmethod
    def _step(points: Tensor, centroids: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """One Lloyd iteration: (new centroids, [N] assignment, the largest
        centroid shift, a 0-d tensor)."""
        d2 = ((points * points).sum(-1)[:, None]
              - 2.0 * (points @ centroids.T)
              + (centroids * centroids).sum(-1)[None, :])
        assign = torch.argmin(d2, dim=-1)
        k = centroids.shape[0]
        sums = torch.zeros_like(centroids).index_add_(0, assign, points)
        counts = torch.bincount(assign, minlength=k).to(points.dtype)[:, None]
        # empty cluster keeps its previous centroid (reference applies the
        # same rule via its empty-cluster handling strategy)
        new_c = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                            centroids)
        shift = torch.linalg.norm(new_c - centroids, dim=-1).max()
        return new_c, assign, shift

    def _points(self, points) -> Tensor:
        if isinstance(points, Tensor):
            return points.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(points, np.float32), device=self.device)

    def fit(self, points) -> "KMeansClustering":
        pts = self._points(points)
        n = pts.shape[0]
        if n < self.k:
            raise ValueError(f"{n} points < k={self.k}")
        rng = np.random.default_rng(self.seed)
        init_idx = rng.choice(n, size=self.k, replace=False)
        c = pts[torch.as_tensor(init_idx, device=self.device)]
        for i in range(self.max_iterations):
            c, _, shift = self._step(pts, c)
            self.iterations_run = i + 1
            if float(shift) < self.tolerance:
                break
        self.centroids = c.cpu().numpy()
        return self

    def predict(self, points) -> np.ndarray:
        if self.centroids is None:
            raise RuntimeError("Call fit() first")
        _, assign, _ = self._step(self._points(points),
                                  torch.as_tensor(self.centroids, device=self.device))
        return assign.to(torch.int32).cpu().numpy()

    def inertia(self, points) -> float:
        """Sum of squared distances to the assigned centroid."""
        pts = np.asarray(points, np.float32)
        a = self.predict(pts)
        return float(((pts - self.centroids[a]) ** 2).sum())
