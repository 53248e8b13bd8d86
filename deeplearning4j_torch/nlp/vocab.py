"""Vocabulary construction: counts, subsampling stats, Huffman coding.

Port of `deeplearning4j_tpu/nlp/vocab.py`, unchanged: the word order,
the Huffman tie order (`heapq` on `(count, id)`) and the unigram table come
out identical.

Reference parity: models/word2vec/wordstore/VocabConstructor.java:32
(parallel corpus scan, min-frequency pruning, special-token handling,
Huffman tree build), models/word2vec/VocabWord, wordstore/inmemory/
AbstractCache (index <-> word maps, total counts), and the Huffman
code assignment used by hierarchical softmax (InMemoryLookupTable).

Host-side pure Python: vocab building is IO/dict work, not accelerator
work, in both designs."""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import numpy as np


@dataclass
class VocabWord:
    """Reference models/word2vec/VocabWord: word, count, huffman code."""

    word: str
    count: int = 0
    index: int = -1
    code: List[int] = field(default_factory=list)    # huffman bits
    points: List[int] = field(default_factory=list)  # inner-node indices


class VocabCache:
    """Reference wordstore/inmemory/AbstractCache."""

    def __init__(self):
        self.words: Dict[str, VocabWord] = {}
        self.index2word: List[str] = []
        self.total_word_count = 0

    def add_token(self, word: str, count: int = 1):
        vw = self.words.get(word)
        if vw is None:
            vw = VocabWord(word=word)
            self.words[word] = vw
        vw.count += count
        self.total_word_count += count

    def finish(self, min_word_frequency: int = 1):
        """Prune + index by descending frequency (reference
        VocabConstructor.buildJointVocabulary)."""
        kept = [vw for vw in self.words.values()
                if vw.count >= min_word_frequency]
        kept.sort(key=lambda v: (-v.count, v.word))
        self.words = {v.word: v for v in kept}
        self.index2word = [v.word for v in kept]
        for i, v in enumerate(kept):
            v.index = i
        self.total_word_count = sum(v.count for v in kept)
        return self

    def __len__(self):
        return len(self.index2word)

    def word_for_index(self, i: int) -> str:
        return self.index2word[i]

    def index_of(self, word: str) -> int:
        vw = self.words.get(word)
        return -1 if vw is None else vw.index

    def contains(self, word: str) -> bool:
        return word in self.words

    def word_frequency(self, word: str) -> int:
        vw = self.words.get(word)
        return 0 if vw is None else vw.count


def build_huffman(cache: VocabCache) -> None:
    """Assign Huffman codes/points (reference Huffman tree in
    InMemoryLookupTable / VocabConstructor). points index the V-1 inner
    nodes used as hierarchical-softmax classifiers."""
    V = len(cache)
    if V == 0:
        return
    # node ids: 0..V-1 leaves, V..2V-2 inner
    counts = [cache.words[w].count for w in cache.index2word]
    heap = [(c, i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = {}
    binary = {}
    next_id = V
    while len(heap) > 1:
        c1, n1 = heapq.heappop(heap)
        c2, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        binary[n1] = 0
        binary[n2] = 1
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    root = heap[0][1] if heap else None
    for i, w in enumerate(cache.index2word):
        code, points = [], []
        n = i
        while n != root and n in parent:
            code.append(binary[n])
            n = parent[n]
            points.append(n - V)  # inner-node index in [0, V-1)
        vw = cache.words[w]
        vw.code = list(reversed(code))
        vw.points = list(reversed(points))


class VocabConstructor:
    """Scan token streams into a finished VocabCache (reference
    VocabConstructor.buildJointVocabulary)."""

    def __init__(self, min_word_frequency: int = 1, build_huffman_tree: bool = True):
        self.min_word_frequency = int(min_word_frequency)
        self.build_huffman_tree = build_huffman_tree

    def build(self, token_stream: Iterable[List[str]]) -> VocabCache:
        cache = VocabCache()
        for tokens in token_stream:
            for t in tokens:
                cache.add_token(t)
        cache.finish(self.min_word_frequency)
        if self.build_huffman_tree:
            build_huffman(cache)
        return cache


def unigram_table(cache: VocabCache, table_size: int = 1 << 20,
                  power: float = 0.75) -> np.ndarray:
    """Negative-sampling distribution table (reference
    InMemoryLookupTable.makeTable: counts^0.75)."""
    V = len(cache)
    counts = np.array([cache.words[w].count for w in cache.index2word],
                      dtype=np.float64)
    probs = counts ** power
    probs /= probs.sum()
    return np.repeat(np.arange(V),
                     np.maximum(1, np.round(probs * table_size).astype(int)))
