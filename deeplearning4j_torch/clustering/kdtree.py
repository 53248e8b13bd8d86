"""KDTree: axis-aligned spatial index.

Reference parity: clustering/kdtree/KDTree.java (insert/nn/knn over
euclidean HyperRects). Host-side exact structure like VPTree; the
device-shaped bulk path remains vptree.knn_brute_force.

Port of `deeplearning4j_tpu/clustering/kdtree.py`, a copy: host numpy, the
same tree and the same answers."""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _KDNode:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index: int, axis: int):
        self.index = index
        self.axis = axis
        self.left: Optional["_KDNode"] = None
        self.right: Optional["_KDNode"] = None


class KDTree:
    def __init__(self, points):
        self.points = np.asarray(points, np.float64)
        if self.points.ndim != 2:
            raise ValueError("KDTree needs [n, d] points")
        self.dims = self.points.shape[1]
        self.root = self._build(list(range(self.points.shape[0])), 0)

    def _build(self, idx: List[int], depth: int) -> Optional[_KDNode]:
        if not idx:
            return None
        axis = depth % self.dims
        idx.sort(key=lambda i: self.points[i, axis])
        mid = len(idx) // 2
        node = _KDNode(idx[mid], axis)
        node.left = self._build(idx[:mid], depth + 1)
        node.right = self._build(idx[mid + 1:], depth + 1)
        return node

    def nn(self, target) -> Tuple[int, float]:
        """Nearest neighbor (reference KDTree.nn)."""
        idx, dist = self.knn(target, 1)
        return int(idx[0]), float(dist[0])

    def knn(self, target, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest (indices, distances) ascending (reference knn)."""
        target = np.asarray(target, np.float64).reshape(-1)
        k = min(int(k), self.points.shape[0])
        if k <= 0:
            if self.points.shape[0] == 0:
                raise ValueError("KDTree is empty")
            raise ValueError(f"k must be >= 1, got {k}")
        heap: List[Tuple[float, int]] = []  # max-heap via neg dist

        def visit(node: Optional[_KDNode]):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.index] - target))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            delta = target[node.axis] - self.points[node.index, node.axis]
            near, far = (node.left, node.right) if delta <= 0 \
                else (node.right, node.left)
            visit(near)
            # prune: cross the splitting plane only if it can hold a closer
            # point than the current k-th
            if len(heap) < k or abs(delta) < -heap[0][0]:
                visit(far)

        visit(self.root)
        pairs = sorted(((-nd, i) for nd, i in heap))
        return (np.array([i for _, i in pairs]),
                np.array([d for d, _ in pairs]))
