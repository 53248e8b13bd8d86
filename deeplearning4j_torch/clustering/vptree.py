"""VPTree k-NN index + brute-force device k-NN.

Reference parity: clustering/vptree/VPTree.java (vantage-point tree over
INDArray rows, metric euclidean/cosine; the index behind the
nearest-neighbor server) and the brute-force scan it falls back to.

Port of `deeplearning4j_tpu/clustering/vptree.py`. `VPTree` and
`_distances` are host numpy, copied: the same seed gives the same tree and
the same answers. `knn_brute_force` is the device path: one [Q, D] x [D, N]
product and a top-k on the GPU, ordered as `jax.lax.top_k` orders it (the
lower index first among equal distances, at the k-th place too), which
`torch.topk` does not promise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..utils.device import DeviceLike, resolve_device


def _distances(metric: str, corpus: np.ndarray, q: np.ndarray) -> np.ndarray:
    if metric == "euclidean":
        return np.linalg.norm(corpus - q, axis=-1)
    if metric == "cosine":
        cn = np.linalg.norm(corpus, axis=-1) * max(np.linalg.norm(q), 1e-12)
        return 1.0 - (corpus @ q) / np.clip(cn, 1e-12, None)
    raise ValueError(f"Unknown metric {metric!r}")


class _Node:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional["_Node"] = None   # dist <= threshold
        self.outside: Optional["_Node"] = None


class VPTree:
    """Exact vantage-point tree (reference VPTree.java surface:
    search(target, k) → indices + distances)."""

    def __init__(self, points, metric: str = "euclidean", seed: int = 0):
        self.points = np.asarray(points, np.float64)
        if self.points.ndim != 2:
            raise ValueError("VPTree needs [n, d] points")
        self.metric = metric
        self._rng = np.random.default_rng(seed)
        idx = list(range(self.points.shape[0]))
        self.root = self._build(idx)

    def _build(self, idx: List[int]) -> Optional[_Node]:
        if not idx:
            return None
        # random vantage point (reference picks randomly too)
        vp_pos = int(self._rng.integers(0, len(idx)))
        idx[0], idx[vp_pos] = idx[vp_pos], idx[0]
        vp = idx[0]
        node = _Node(vp)
        rest = idx[1:]
        if not rest:
            return node
        d = _distances(self.metric, self.points[rest], self.points[vp])
        median = float(np.median(d))
        node.threshold = median
        inside = [rest[i] for i in range(len(rest)) if d[i] <= median]
        outside = [rest[i] for i in range(len(rest)) if d[i] > median]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    def search(self, target, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest (indices, distances), ascending distance."""
        target = np.asarray(target, np.float64).reshape(-1)
        k = min(k, self.points.shape[0])
        # bounded max-heap as (neg_dist, idx) list
        import heapq
        heap: List[Tuple[float, int]] = []
        tau = np.inf

        def visit(node: Optional[_Node]):
            nonlocal tau
            if node is None:
                return
            d = float(_distances(self.metric,
                                 self.points[node.index][None], target)[0])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau = -heap[0][0]
            elif d < tau:
                heapq.heapreplace(heap, (-d, node.index))
                tau = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d <= node.threshold:
                visit(node.inside)
                if d + tau > node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau <= node.threshold:
                    visit(node.inside)

        visit(self.root)
        pairs = sorted(((-nd, i) for nd, i in heap))
        return (np.array([i for _, i in pairs]),
                np.array([d for d, _ in pairs]))


def knn_distances(corpus: Tensor, queries: Tensor, metric: str) -> Tensor:
    """[Q, N] distances from each query to each corpus row: the expansion
    ||c||^2 - 2 q.c + ||q||^2, clamped at 0 and square-rooted, or one minus
    the cosine similarity."""
    if metric == "euclidean":
        d2 = ((corpus * corpus).sum(-1)[None, :] - 2.0 * (queries @ corpus.T)
              + (queries * queries).sum(-1)[:, None])
        return torch.sqrt(torch.clamp(d2, min=0.0))
    if metric == "cosine":
        cn = (torch.linalg.norm(corpus, dim=-1)[None, :]
              * torch.linalg.norm(queries, dim=-1)[:, None])
        return 1.0 - (queries @ corpus.T) / torch.clamp(cn, min=1e-12)
    raise ValueError(f"Unknown metric {metric!r}")


def smallest_k(d: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k smallest entries of each row of `d`: ([Q, k] columns, [Q, k]
    values), ascending, the lower column first among equal values, and at
    the k-th place the lowest columns of those equal to it (the order of
    `jax.lax.top_k(-d, k)`)."""
    q = d.shape[0]
    if k == 0:
        return (torch.zeros((q, 0), dtype=torch.int64, device=d.device),
                d[:, :0])
    kth = torch.topk(d, k, dim=1, largest=False, sorted=True).values[:, k - 1:k]
    chosen = d < kth
    ties = torch.nonzero(d == kth)            # row-major: columns ascending
    rows = ties[:, 0]
    need = k - chosen.sum(1)                   # places left for the ties
    first = torch.searchsorted(rows, torch.arange(q, device=d.device))
    rank = torch.arange(rows.numel(), device=d.device) - first[rows]
    keep = ties[rank < need[rows]]
    chosen[keep[:, 0], keep[:, 1]] = True
    cols = torch.nonzero(chosen)[:, 1].view(q, k)
    values, order = torch.sort(d.gather(1, cols), dim=1, stable=True)
    return cols.gather(1, order), values


def _on_device(a, device: torch.device) -> Tensor:
    if isinstance(a, Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def knn_brute_force(corpus, queries, k: int, metric: str = "euclidean",
                    device: DeviceLike = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched exact k-NN on `device` (default: CUDA, raising when there is
    none). `corpus` and `queries` are arrays or tensors (a tensor already on
    the device is not copied). Returns ([Q, k] int32 indices, [Q, k]
    float32 distances) as numpy arrays, ascending, k = min(k, N)."""
    dev = resolve_device(device)
    c = _on_device(corpus, dev)
    if isinstance(queries, Tensor):
        q = _on_device(queries, dev)
        q = q[None] if q.ndim == 1 else q
    else:
        q = _on_device(np.atleast_2d(np.asarray(queries, np.float32)), dev)
    k = min(int(k), c.shape[0])
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    idx, dist = smallest_k(knn_distances(c, q, metric), k)
    return (idx.to(torch.int32).cpu().numpy(), dist.cpu().numpy())
