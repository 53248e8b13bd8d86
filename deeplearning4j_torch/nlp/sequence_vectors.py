"""SequenceVectors: the generic embedding engine over any element type.

Port of `deeplearning4j_tpu/nlp/sequence_vectors.py`; trains on `device`
(None: CUDA).

Reference parity: models/sequencevectors/SequenceVectors.java:187-310 —
the generic trainer over `Sequence<T extends SequenceElement>` that
Word2Vec, ParagraphVectors, and DeepWalk all specialize. Here the device
steps (nlp/embeddings.py) already operate on integer ids, so
genericity is an ID-MAPPING concern: this facade accepts sequences of
ARBITRARY hashable elements, builds the frequency vocab + huffman tree,
and trains skip-gram/CBOW with NS and/or HS. Word2Vec remains the
string-tokenized specialization; DeepWalk the vertex one.
"""
from __future__ import annotations

from typing import Hashable, Optional, Sequence

import numpy as np

from .embeddings import BatchedEmbeddingTrainer
from .vocab import VocabCache
from .word2vec import WordVectors


class SequenceVectors(WordVectors):
    """Builder-configured generic embedding trainer (reference
    SequenceVectors.Builder surface)."""

    def __init__(self, layer_size: int = 100, window_size: int = 5,
                 negative: int = 0, use_hierarchic_softmax: bool = True,
                 cbow: bool = False, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, batch_size: int = 1024,
                 min_element_frequency: int = 1, epochs: int = 1,
                 seed: int = 42, device=None):
        self.layer_size = int(layer_size)
        self.window_size = int(window_size)
        self.negative = int(negative)
        self.use_hierarchic_softmax = bool(use_hierarchic_softmax)
        self.cbow = bool(cbow)
        self.learning_rate = float(learning_rate)
        self.min_learning_rate = float(min_learning_rate)
        self.batch_size = int(batch_size)
        self.min_element_frequency = int(min_element_frequency)
        self.epochs = int(epochs)
        self.seed = int(seed)
        self.device = device
        self._trainer: Optional[BatchedEmbeddingTrainer] = None
        self.vocab: Optional[VocabCache] = None
        self._vectors = None
        self._normed = None
        self._keys: dict = {}  # element → stable vocab key (by equality)

    def _intern(self, el: Hashable) -> str:
        """Assign a stable key via the element's OWN hash/eq (repr would
        fragment value-equal instances lacking a value-based __repr__).
        Only fit() interns; lookups stay pure."""
        key = self._keys.get(el)
        if key is None:
            key = self._keys[el] = f"e{len(self._keys)}"
        return key

    def _key_of(self, el: Hashable) -> str:
        """Pure lookup — unseen elements must NOT grow (and pin into)
        the key table from the query path."""
        return self._keys.get(el, "\x00unseen")

    def fit(self, sequences: Sequence[Sequence[Hashable]]
            ) -> "SequenceVectors":
        """Train on sequences of arbitrary hashable elements (reference
        fit(): vocab scan then training passes). Reuses the word2vec
        vocab/indexing helpers over key-mapped token lists."""
        from .embeddings import sentences_to_indices
        from .vocab import VocabConstructor
        token_seqs = [[self._intern(el) for el in s] for s in sequences]
        cache = VocabConstructor(
            min_word_frequency=self.min_element_frequency).build(token_seqs)
        self.vocab = cache
        self._trainer = BatchedEmbeddingTrainer(
            cache, layer_size=self.layer_size, window=self.window_size,
            negative=self.negative,
            use_hierarchic_softmax=self.use_hierarchic_softmax,
            cbow=self.cbow, learning_rate=self.learning_rate,
            min_learning_rate=self.min_learning_rate,
            batch_size=self.batch_size, seed=self.seed, device=self.device)
        self._trainer.fit_sentences(sentences_to_indices(token_seqs, cache),
                                    epochs=self.epochs)
        self._vectors = self._trainer.vectors()
        self._normed = None
        return self

    # element-keyed lookups on top of the WordVectors string API ----------
    def element_vector(self, element: Hashable) -> Optional[np.ndarray]:
        return self.word_vector(self._key_of(element))

    def similarity_elements(self, a: Hashable, b: Hashable) -> float:
        return self.similarity(self._key_of(a), self._key_of(b))
