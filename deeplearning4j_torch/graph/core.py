"""Graph API + random walks.

Port of `deeplearning4j_tpu/graph/core.py`, unchanged: the walks come from
the same numpy generator calls, so they are identical.

Reference parity: deeplearning4j-graph graph/api/{IGraph,Vertex,Edge},
graph/graph/Graph.java (adjacency-list impl), graph/data/GraphLoader
(edge-list files), graph/iterator/RandomWalkIterator +
WeightedRandomWalkIterator.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


class Graph:
    """Adjacency-list graph over integer vertices (reference
    graph/graph/Graph.java; vertices carry optional labels like
    api/Vertex values)."""

    def __init__(self, num_vertices: int, directed: bool = False,
                 labels: Optional[Sequence[str]] = None):
        self.n = int(num_vertices)
        self.directed = directed
        self.labels = list(labels) if labels is not None else None
        self._adj: List[List[Tuple[int, float]]] = [[] for _ in range(self.n)]

    def add_edge(self, a: int, b: int, weight: float = 1.0) -> None:
        self._adj[a].append((b, float(weight)))
        if not self.directed:
            self._adj[b].append((a, float(weight)))

    def neighbors(self, v: int) -> List[int]:
        return [b for b, _ in self._adj[v]]

    def degree(self, v: int) -> int:
        return len(self._adj[v])

    def num_vertices(self) -> int:
        return self.n

    @staticmethod
    def from_edge_list(edges: Sequence[Tuple[int, int]],
                       num_vertices: Optional[int] = None,
                       directed: bool = False) -> "Graph":
        """Reference graph/data/GraphLoader.loadUndirectedGraphEdgeListFile
        (minus the file half — pass parsed pairs; load_edge_list_file
        reads the file format)."""
        if num_vertices is None:
            num_vertices = max(max(a, b) for a, b in edges) + 1
        g = Graph(num_vertices, directed)
        for a, b in edges:
            g.add_edge(a, b)
        return g

    @staticmethod
    def load_edge_list_file(path: str, delimiter: str = ",",
                            directed: bool = False) -> "Graph":
        edges = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(delimiter)[:2]
                edges.append((int(a), int(b)))
        return Graph.from_edge_list(edges, directed=directed)


class RandomWalkIterator:
    """Uniform (or degree-weighted) random walks of fixed length from
    every vertex (reference graph/iterator/RandomWalkIterator; the
    NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED behavior for dead ends)."""

    def __init__(self, graph: Graph, walk_length: int = 10,
                 seed: int = 0, weighted: bool = False):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.seed = seed
        self.weighted = weighted
        self._order: Optional[np.ndarray] = None
        self._pos = 0
        self._rng = np.random.default_rng(seed)

    def reset(self):
        self._rng = np.random.default_rng(self.seed)
        self._order = self._rng.permutation(self.graph.n)
        self._pos = 0

    def __iter__(self) -> Iterator[List[int]]:
        self.reset()
        return self

    def __next__(self) -> List[int]:
        if self._order is None:
            self.reset()
        if self._pos >= len(self._order):
            raise StopIteration
        start = int(self._order[self._pos])
        self._pos += 1
        walk = [start]
        cur = start
        for _ in range(self.walk_length - 1):
            nbrs = self.graph._adj[cur]
            if not nbrs:
                walk.append(cur)  # self-loop on dead end
                continue
            if self.weighted:
                ws = np.array([w for _, w in nbrs])
                cur = nbrs[self._rng.choice(len(nbrs),
                                            p=ws / ws.sum())][0]
            else:
                cur = nbrs[int(self._rng.integers(0, len(nbrs)))][0]
            walk.append(cur)
        return walk
