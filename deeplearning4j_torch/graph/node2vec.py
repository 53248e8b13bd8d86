"""node2vec: biased second-order random walks + skip-gram.

Reference parity: models/node2vec/ (the reference's partial impl over
graph walks; completed here per Grover & Leskovec 2016). Walks are biased
by return parameter p and in-out parameter q; embedding training reuses
the DeepWalk/word2vec batched device steps. Port of
`deeplearning4j_tpu/graph/node2vec.py`: the walks are identical.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .core import Graph
from .deepwalk import DeepWalk


class Node2VecWalker:
    """Second-order biased walks: unnormalized transition weight to
    neighbor x from edge (t → v) is 1/p if x == t, 1 if x adjacent to t,
    else 1/q."""

    def __init__(self, graph: Graph, p: float = 1.0, q: float = 1.0,
                 walk_length: int = 10, seed: int = 0):
        self.graph = graph
        self.p = float(p)
        self.q = float(q)
        self.walk_length = int(walk_length)
        self.seed = seed
        self._nbr_sets = [set(graph.neighbors(v))
                          for v in range(graph.num_vertices())]

    def walk_from(self, start: int, rng: np.random.Generator) -> List[int]:
        walk = [start]
        g = self.graph
        for _ in range(self.walk_length - 1):
            cur = walk[-1]
            nbrs = g.neighbors(cur)
            if not nbrs:
                walk.append(cur)
                continue
            if len(walk) == 1:
                walk.append(nbrs[int(rng.integers(0, len(nbrs)))])
                continue
            prev = walk[-2]
            w = np.empty(len(nbrs))
            prev_nbrs = self._nbr_sets[prev]
            for i, x in enumerate(nbrs):
                if x == prev:
                    w[i] = 1.0 / self.p
                elif x in prev_nbrs:
                    w[i] = 1.0
                else:
                    w[i] = 1.0 / self.q
            w /= w.sum()
            walk.append(nbrs[int(rng.choice(len(nbrs), p=w))])
        return walk

    def generate(self, walks_per_vertex: int) -> List[List[int]]:
        rng = np.random.default_rng(self.seed)
        walks = []
        for r in range(walks_per_vertex):
            order = rng.permutation(self.graph.num_vertices())
            for v in order:
                walks.append(self.walk_from(int(v), rng))
        return walks


class Node2Vec(DeepWalk):
    """DeepWalk facade with p/q-biased walks (BFS-ish structural vs
    DFS-ish homophilous neighborhoods)."""

    def __init__(self, p: float = 1.0, q: float = 1.0, **kw):
        super().__init__(**kw)
        self.p = float(p)
        self.q = float(q)

    def fit(self, graph: Graph, walk_length: int = 10,
            walks_per_vertex: int = 10, epochs: int = 1) -> "Node2Vec":
        if self._trainer is None:
            self.initialize(graph)
        walker = Node2VecWalker(graph, p=self.p, q=self.q,
                                walk_length=walk_length, seed=self.seed)
        walks = walker.generate(walks_per_vertex)
        return super().fit(walks, epochs=epochs)
