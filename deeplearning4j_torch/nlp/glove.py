"""GloVe: global vectors from co-occurrence statistics.

Port of `deeplearning4j_tpu/nlp/glove.py` (reference models/glove/Glove.java,
models/glove/count/, the AdaGrad element update in learning/impl/elements/
GloVe.java):
    J = sum_ij f(X_ij) (w_i.w~_j + b_i + b~_j - log X_ij)^2,
    f(x) = (x/x_max)^alpha clipped at 1.

Counting stays on the host (the same dict scan as the JAX package); the
optimization runs batched AdaGrad steps over COO (i, j, X_ij) triples on the
device. As in the JAX package, a step's gradient is the dense per-table sum
(a row a batch names twice gets the sum of both terms before it is
squared) and AdaGrad updates every table row, the untouched ones by 0.
The init is numpy, so both packages start from the same tables.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .tokenization import DefaultTokenizerFactory
from .vocab import VocabConstructor
from ..utils.device import resolve_device
from .word2vec import WordVectors


def cooccurrence_counts(indexed_sentences, window: int = 5,
                        symmetric: bool = True,
                        distance_weighted: bool = True
                        ) -> Dict[Tuple[int, int], float]:
    """Weighted co-occurrence map (reference glove/count pipeline;
    1/distance weighting per the GloVe paper and
    AbstractCoOccurrences.java)."""
    counts: Dict[Tuple[int, int], float] = {}
    for ids in indexed_sentences:
        n = len(ids)
        for pos in range(n):
            for off in range(1, window + 1):
                j = pos + off
                if j >= n:
                    break
                w = 1.0 / off if distance_weighted else 1.0
                a, b = int(ids[pos]), int(ids[j])
                counts[(a, b)] = counts.get((a, b), 0.0) + w
                if symmetric:
                    counts[(b, a)] = counts.get((b, a), 0.0) + w
    return counts


def glove_grads(tables, rows, cols, logx, fx):
    """(loss sum, dense gradients {"W", "Wt", "b", "bt"}) of
    0.5 sum fx (w_i.w~_j + b_i + b~_j - log x)^2 over the batch's triples."""
    W, Wt = tables["W"], tables["Wt"]
    rows, cols = rows.long(), cols.long()
    wi, wj = W[rows], Wt[cols]
    diff = (wi * wj).sum(-1) + tables["b"][rows] + tables["bt"][cols] - logx
    loss = 0.5 * (fx * diff * diff).sum()
    e = fx * diff                                           # d loss / d diff
    grads = {"W": torch.zeros_like(W).index_add_(0, rows, e[:, None] * wj),
             "Wt": torch.zeros_like(Wt).index_add_(0, cols, e[:, None] * wi),
             "b": torch.zeros_like(tables["b"]).index_add_(0, rows, e),
             "bt": torch.zeros_like(tables["bt"]).index_add_(0, cols, e)}
    return loss, grads


def _glove_step(tables, accum, rows, cols, logx, fx, lr):
    """One batched AdaGrad step on COO triples, in place on `tables` =
    {"W": [V,D], "Wt": [V,D], "b": [V], "bt": [V]} and `accum` (the
    sum-of-squares state, shaped like `tables`); returns (tables, accum,
    loss / batch)."""
    loss, grads = glove_grads(tables, rows, cols, logx, fx)
    for k in tables:
        g = grads[k]
        accum[k] += g * g
        tables[k] -= lr * g / torch.sqrt(accum[k] + 1e-8)
    return tables, accum, loss / rows.shape[0]


class Glove(WordVectors):
    """Builder-configured GloVe trainer (reference Glove.Builder)."""

    def __init__(self, **kw):
        self._kw = kw
        self.vocab = None
        self._vectors = None
        self._normed = None
        self.last_loss: Optional[float] = None

    @staticmethod
    def builder() -> "GloveBuilder":
        return GloveBuilder()

    def fit(self) -> "Glove":
        kw = self._kw
        it = kw["iterate"]
        tf = kw.get("tokenizer_factory", DefaultTokenizerFactory())
        tokenized = [tf.create(s).get_tokens() for s in it]
        cache = VocabConstructor(
            min_word_frequency=kw.get("min_word_frequency", 1)).build(
                tokenized)
        self.vocab = cache
        indexed = []
        for tokens in tokenized:
            ids = [cache.index_of(t) for t in tokens]
            ids = [i for i in ids if i >= 0]
            if ids:
                indexed.append(np.asarray(ids, np.int32))

        counts = cooccurrence_counts(
            indexed, window=kw.get("window_size", 5),
            symmetric=kw.get("symmetric", True))
        if not counts:
            raise ValueError("Empty co-occurrence matrix (corpus too small)")
        coo = np.array([(i, j, x) for (i, j), x in counts.items()],
                       np.float64)
        rows = coo[:, 0].astype(np.int32)
        cols = coo[:, 1].astype(np.int32)
        xs = coo[:, 2]
        x_max = float(kw.get("x_max", 100.0))
        alpha = float(kw.get("alpha", 0.75))
        fx = np.minimum(1.0, (xs / x_max) ** alpha).astype(np.float32)
        logx = np.log(xs).astype(np.float32)

        V, D = len(cache), int(kw.get("layer_size", 100))
        rng = np.random.default_rng(kw.get("seed", 42))
        dev = resolve_device(kw.get("device"))
        put = lambda a: torch.as_tensor(a, device=dev)
        tables = {
            "W": put(rng.uniform(-0.5 / D, 0.5 / D, (V, D)).astype(np.float32)),
            "Wt": put(rng.uniform(-0.5 / D, 0.5 / D, (V, D)).astype(np.float32)),
            "b": torch.zeros((V,), dtype=torch.float32, device=dev),
            "bt": torch.zeros((V,), dtype=torch.float32, device=dev),
        }
        accum = {k: torch.zeros_like(v) for k, v in tables.items()}
        self.tables, self.accum = tables, accum

        lr = float(np.float32(kw.get("learning_rate", 0.05)))
        B = int(kw.get("batch_size", 4096))
        n = len(rows)
        # the triples cross to the device once; each batch gathers its own
        rows_d, cols_d, logx_d, fx_d = put(rows), put(cols), put(logx), put(fx)
        for _ in range(kw.get("epochs", 25)):
            order = rng.permutation(n)
            for s in range(0, n, B):
                sl = put(order[s:s + B])
                self.tables, self.accum, loss = _glove_step(
                    self.tables, self.accum, rows_d[sl], cols_d[sl], logx_d[sl],
                    fx_d[sl], lr)
            self.last_loss = float(loss)

        # Standard GloVe: final embedding = W + Wt (paper §4.2; reference
        # exposes syn0 only, lookupTable).
        self._vectors = (self.tables["W"].cpu().numpy()
                         + self.tables["Wt"].cpu().numpy())
        self._normed = None
        return self


class GloveBuilder:
    """Fluent builder mirroring reference Glove.Builder names."""

    def __init__(self):
        self._kw = {}

    def _set(self, k, v):
        self._kw[k] = v
        return self

    def iterate(self, it):
        from .sentence_iterator import CollectionSentenceIterator
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

    def learning_rate(self, lr):
        return self._set("learning_rate", float(lr))

    def epochs(self, n):
        return self._set("epochs", int(n))

    def batch_size(self, n):
        return self._set("batch_size", int(n))

    def x_max(self, x):
        return self._set("x_max", float(x))

    def alpha(self, a):
        return self._set("alpha", float(a))

    def symmetric(self, b):
        return self._set("symmetric", bool(b))

    def seed(self, s):
        return self._set("seed", int(s))

    def device(self, device):
        """Where the tables live and train: None (the default) means CUDA;
        the CPU only when named."""
        return self._set("device", device)

    def build(self) -> Glove:
        if "iterate" not in self._kw:
            raise ValueError("Glove.builder(): call iterate(...) first")
        return Glove(**self._kw)
