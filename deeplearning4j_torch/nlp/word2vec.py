"""Word2Vec facade + WordVectors query API.

Port of `deeplearning4j_tpu/nlp/word2vec.py`. The queries stay numpy on host
copies of the vectors, as in the JAX package, so ties sort the same; the
training runs on the builder's `device` (None: CUDA).

Reference parity: models/word2vec/Word2Vec.java (606 LoC Builder facade over
SequenceVectors), models/embeddings/wordvectors/WordVectors/WordVectorsImpl
(getWordVector, similarity, wordsNearest), models/embeddings/reader/impl/
BasicModelUtils (cosine nearest-neighbor search).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .embeddings import BatchedEmbeddingTrainer, sentences_to_indices
from .sentence_iterator import CollectionSentenceIterator, SentenceIterator
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor


class WordVectors:
    """Query API over a vocab + vector table (reference
    wordvectors/WordVectors interface)."""

    def __init__(self, cache: VocabCache, vectors: np.ndarray):
        self.vocab = cache
        self._vectors = np.asarray(vectors)
        self._normed: Optional[np.ndarray] = None

    # -- lookup ------------------------------------------------------------
    def has_word(self, word: str) -> bool:
        return self.vocab.contains(word)

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self._vectors[i]

    def get_word_vector_matrix(self) -> np.ndarray:
        return self._vectors

    def _norms(self):
        if self._normed is None:
            n = np.linalg.norm(self._vectors, axis=1, keepdims=True)
            self._normed = self._vectors / np.clip(n, 1e-12, None)
        return self._normed

    # -- similarity --------------------------------------------------------
    def similarity(self, w1: str, w2: str) -> float:
        a, b = self.word_vector(w1), self.word_vector(w2)
        if a is None or b is None:
            return float("nan")
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        return float(a @ b / denom) if denom else 0.0

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        """Cosine nearest neighbors (reference BasicModelUtils
        .wordsNearest)."""
        exclude = set()
        if isinstance(word_or_vec, str):
            v = self.word_vector(word_or_vec)
            if v is None:
                return []
            exclude.add(word_or_vec)
        else:
            v = np.asarray(word_or_vec)
        v = v / np.clip(np.linalg.norm(v), 1e-12, None)
        sims = self._norms() @ v
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_for_index(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out

    def words_nearest_sum(self, positive: Sequence[str],
                          negative: Sequence[str] = (),
                          top_n: int = 10) -> List[str]:
        """king - man + woman style analogy queries (reference
        wordsNearest(positive, negative, n))."""
        v = np.zeros(self._vectors.shape[1])
        for w in positive:
            wv = self.word_vector(w)
            if wv is not None:
                v = v + wv
        for w in negative:
            wv = self.word_vector(w)
            if wv is not None:
                v = v - wv
        sims_order = self.words_nearest(v, top_n + len(positive) +
                                        len(negative))
        skip = set(positive) | set(negative)
        return [w for w in sims_order if w not in skip][:top_n]


class Word2Vec(WordVectors):
    """Builder-configured trainer (reference Word2Vec.Builder surface)."""

    def __init__(self, **kw):
        self._kw = kw
        self._trainer: Optional[BatchedEmbeddingTrainer] = None
        # WordVectors state filled by fit()
        self.vocab = None
        self._vectors = None
        self._normed = None

    @staticmethod
    def builder() -> "Word2VecBuilder":
        return Word2VecBuilder()

    def fit(self) -> "Word2Vec":
        kw = self._kw
        it: SentenceIterator = kw["iterate"]
        tf: TokenizerFactory = kw.get("tokenizer_factory",
                                      DefaultTokenizerFactory())

        # Materialise the tokenised corpus ONCE: a generator-backed
        # SentenceIterator would silently yield nothing on a second pass
        # (vocab scan + training scan), so we tokenise a single time and
        # reuse the list for both (reference resets its iterator between
        # the VocabConstructor scan and training, SequenceVectors.java:187).
        tokenized = [tf.create(sentence).get_tokens() for sentence in it]

        cache = VocabConstructor(
            min_word_frequency=kw.get("min_word_frequency", 1)).build(
                tokenized)
        self.vocab = cache
        device = kw.get("device")
        if kw.get("mesh") is not None or kw.get("device_corpus"):
            # Sharded device-corpus engine (the dl4j-spark-nlp Word2Vec
            # role; see nlp/distributed.py). Skip-gram + negative
            # sampling only — loud error otherwise, same contract as
            # other documented-unsupported combinations.
            from .distributed import ShardedWord2Vec, corpus_arrays
            # loud-contract validation: HS must be EXPLICITLY disabled
            # (silently dropping the reference's HS+NS combination would
            # change training semantics without telling anyone), and
            # negative must be explicitly positive (builder default is 0)
            if kw.get("use_hierarchic_softmax", True):
                raise ValueError(
                    "the sharded device-corpus engine trains negative "
                    "sampling only; call use_hierarchic_softmax(False) "
                    "explicitly (or drop mesh()/device_corpus())")
            if kw.get("negative", 0) <= 0:
                raise ValueError(
                    "the sharded device-corpus engine needs "
                    "negative_sample(n > 0)")
            if kw.get("elements_learning_algorithm",
                      "skipgram") == "cbow":
                raise ValueError("the sharded device-corpus engine does "
                                 "not implement CBOW")
            sharded = ShardedWord2Vec(
                cache,
                layer_size=kw.get("layer_size", 100),
                window=kw.get("window_size", 5),
                negative=kw["negative"],
                learning_rate=kw.get("learning_rate", 0.025),
                min_learning_rate=kw.get("min_learning_rate", 1e-4),
                sampling=kw.get("sampling", 0.0),
                chunk=kw.get("chunk", 2048),
                seed=kw.get("seed", 42),
                mesh=kw.get("mesh"), device=device)
            toks, sids = corpus_arrays(
                sentences_to_indices(tokenized, cache))
            sharded.fit_corpus(toks, sids,
                               epochs=kw.get("epochs", 1)
                               * kw.get("iterations", 1))
            self._trainer = sharded
            self._vectors = sharded.vectors()
            self._normed = None
            return self
        # Reference defaults: useHierarchicSoftmax=true, negative=0
        # (Word2Vec.java builder defaults).
        trainer = BatchedEmbeddingTrainer(
            cache,
            layer_size=kw.get("layer_size", 100),
            window=kw.get("window_size", 5),
            negative=kw.get("negative", 0),
            use_hierarchic_softmax=kw.get("use_hierarchic_softmax", True),
            cbow=kw.get("elements_learning_algorithm", "skipgram") == "cbow",
            learning_rate=kw.get("learning_rate", 0.025),
            min_learning_rate=kw.get("min_learning_rate", 1e-4),
            batch_size=kw.get("batch_size", 1024),
            sampling=kw.get("sampling", 0.0),
            seed=kw.get("seed", 42), device=device)
        indexed = sentences_to_indices(tokenized, cache)
        trainer.fit_sentences(indexed, epochs=kw.get("epochs", 1)
                              * kw.get("iterations", 1))
        self._trainer = trainer
        self._vectors = trainer.vectors()
        self._normed = None
        return self


class Word2VecBuilder:
    """Fluent builder mirroring reference Word2Vec.Builder names."""

    def __init__(self):
        self._kw = {}

    def _set(self, k, v):
        self._kw[k] = v
        return self

    def iterate(self, it):
        if isinstance(it, (list, tuple)):
            it = CollectionSentenceIterator(it)
        return self._set("iterate", it)

    def tokenizer_factory(self, tf):
        return self._set("tokenizer_factory", tf)

    def layer_size(self, n):
        return self._set("layer_size", int(n))

    def window_size(self, n):
        return self._set("window_size", int(n))

    def min_word_frequency(self, n):
        return self._set("min_word_frequency", int(n))

    def negative_sample(self, n):
        return self._set("negative", int(n))

    def use_hierarchic_softmax(self, b=True):
        return self._set("use_hierarchic_softmax", bool(b))

    def elements_learning_algorithm(self, name):
        return self._set("elements_learning_algorithm", name.lower())

    def learning_rate(self, lr):
        return self._set("learning_rate", float(lr))

    def min_learning_rate(self, lr):
        return self._set("min_learning_rate", float(lr))

    def epochs(self, n):
        return self._set("epochs", int(n))

    def iterations(self, n):
        return self._set("iterations", int(n))

    def batch_size(self, n):
        return self._set("batch_size", int(n))

    def sampling(self, s):
        return self._set("sampling", float(s))

    def seed(self, s):
        return self._set("seed", int(s))

    def chunk(self, n):
        """Device-corpus engine chunk size (positions per step); smaller
        chunks = finer step granularity (see nlp/distributed.py)."""
        return self._set("chunk", int(n))

    def mesh(self, mesh):
        """Train data-parallel over a `parallel.mesh.Mesh` (the
        dl4j-spark-nlp Word2Vec role); implies the device-corpus
        engine."""
        return self._set("mesh", mesh)

    def device_corpus(self, b=True):
        """Use the device-resident-corpus engine on one device (device-side
        pair generation; nlp/distributed.py)."""
        return self._set("device_corpus", bool(b))

    def device(self, device):
        """Where the tables live and train: None (the default) means CUDA;
        the CPU only when named."""
        return self._set("device", device)

    def build(self) -> Word2Vec:
        if "iterate" not in self._kw:
            raise ValueError("Word2Vec.builder(): call iterate(...) first")
        return Word2Vec(**self._kw)
