"""DeepWalk graph embeddings.

Reference parity: graph/models/deepwalk/DeepWalk.java — random walks fed
to skip-gram with hierarchical softmax over a vertex huffman tree
(GraphHuffman, degree-weighted codes), vectors in
embeddings/InMemoryGraphLookupTable; GraphVectorSerializer for IO.

Port of `deeplearning4j_tpu/graph/deepwalk.py`: walks generate host-side
(RandomWalkIterator); the skip-gram HS updates are the same batched device
steps as word2vec's (nlp/embeddings.py), on `device` (None: CUDA) — vertices are just tokens whose counts are their
degrees, which reproduces the reference's degree-weighted huffman tree.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..nlp.embeddings import BatchedEmbeddingTrainer
from ..nlp.vocab import VocabCache, build_huffman
from .core import Graph, RandomWalkIterator


class DeepWalk:
    """Builder-configured DeepWalk (reference DeepWalk.Builder:
    vectorSize, windowSize, learningRate; fit(GraphWalkIterator))."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, seed: int = 42,
                 negative: int = 0, batch_size: int = 1024, device=None):
        self.vector_size = int(vector_size)
        self.window_size = int(window_size)
        self.learning_rate = float(learning_rate)
        self.seed = int(seed)
        self.negative = int(negative)  # 0 → pure HS, the reference default
        self.batch_size = int(batch_size)
        self.device = device
        self._trainer: Optional[BatchedEmbeddingTrainer] = None
        self._graph: Optional[Graph] = None

    def initialize(self, graph: Graph) -> "DeepWalk":
        """Build the degree-weighted vertex vocab + huffman tree
        (reference DeepWalk.initialize → GraphHuffman over degrees)."""
        self._graph = graph
        cache = VocabCache()
        for v in range(graph.num_vertices()):
            # counts = degree (+1 so isolated vertices stay in the tree)
            cache.add_token(str(v), count=graph.degree(v) + 1)
        cache.finish(min_word_frequency=1)
        build_huffman(cache)
        self._trainer = BatchedEmbeddingTrainer(
            cache, layer_size=self.vector_size, window=self.window_size,
            negative=self.negative,
            use_hierarchic_softmax=self.negative == 0,
            learning_rate=self.learning_rate,
            batch_size=self.batch_size, seed=self.seed, device=self.device)
        return self

    def fit(self, graph_or_walks, walk_length: int = 10,
            walks_per_vertex: int = 10, epochs: int = 1) -> "DeepWalk":
        """Train on random walks (reference fit(GraphWalkIterator)); pass
        a Graph to generate walks internally, or pre-generated walks."""
        if isinstance(graph_or_walks, Graph):
            if self._trainer is None:
                self.initialize(graph_or_walks)
            walks: List[List[int]] = []
            for r in range(walks_per_vertex):
                it = RandomWalkIterator(self._graph, walk_length,
                                        seed=self.seed + r)
                walks.extend(it)
        else:
            walks = list(graph_or_walks)
            if self._trainer is None:
                raise RuntimeError("initialize(graph) before fitting on "
                                   "pre-generated walks")
        cache = self._trainer.cache
        indexed = [np.asarray([cache.index_of(str(v)) for v in w],
                              np.int32) for w in walks]
        indexed = [w[w >= 0] for w in indexed]
        self._trainer.fit_sentences([w for w in indexed if len(w) > 1],
                                    epochs=epochs)
        return self

    # -------------------------------------------------------------- queries
    def get_vertex_vector(self, v: int) -> np.ndarray:
        """Reference DeepWalk.getVertexVector."""
        i = self._trainer.cache.index_of(str(v))
        return self._trainer.vectors()[i]

    def similarity(self, a: int, b: int) -> float:
        va, vb = self.get_vertex_vector(a), self.get_vertex_vector(b)
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0

    def verticies_nearest(self, v: int, top_n: int = 10) -> List[int]:
        """Reference (sic) verticesNearest."""
        mat = self._trainer.vectors()
        i = self._trainer.cache.index_of(str(v))
        q = mat[i] / max(np.linalg.norm(mat[i]), 1e-12)
        sims = (mat / np.clip(np.linalg.norm(mat, axis=1, keepdims=True),
                              1e-12, None)) @ q
        order = np.argsort(-sims)
        out = []
        for j in order:
            if j == i:
                continue
            out.append(int(self._trainer.cache.word_for_index(int(j))))
            if len(out) >= top_n:
                break
        return out

    # ------------------------------------------------------------------- IO
    def save(self, path: str) -> None:
        """Reference GraphVectorSerializer.writeGraphVectors (vertex id +
        vector per line)."""
        mat = self._trainer.vectors()
        cache = self._trainer.cache
        with open(path, "w") as f:
            for i in range(mat.shape[0]):
                vals = " ".join(f"{x:.6g}" for x in mat[i])
                f.write(f"{cache.word_for_index(i)} {vals}\n")

    @staticmethod
    def load_vectors(path: str) -> "dict[int, np.ndarray]":
        out = {}
        with open(path) as f:
            for line in f:
                parts = line.split(" ")
                out[int(parts[0])] = np.array(parts[1:], np.float32)
        return out
