"""Text → tensor vectorizers and NN-training text iterators.

Reference parity: bagofwords/vectorizer/{BagOfWordsVectorizer,
TfidfVectorizer}.java (document → count / tf-idf row + label),
iterator/CnnSentenceDataSetIterator.java (sentences → padded word-vector
tensors for CNN text classification), text/stopwords/StopWords.java.

Port of `deeplearning4j_tpu/nlp/vectorizers.py`: the same rows, yielded as
the port's `DataSet`s (`data/dataset.py`) by `DataSetIterator`s.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import DataSet
from ..data.iterators import DataSetIterator
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache
from .word2vec import WordVectors

# One stop-word list for the whole package (text/stopwords role) — the
# tokenization module owns it; this alias keeps the vectorizer-side name.
from .tokenization import STOP_WORDS as ENGLISH_STOP_WORDS  # noqa: E402


class BaseTextVectorizer:
    """Shared vocab-fitting half (reference BaseTextVectorizer)."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1,
                 stop_words: Optional[Sequence[str]] = None):
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = int(min_word_frequency)
        self.stop_words = frozenset(stop_words) if stop_words is not None \
            else frozenset()
        self.vocab: Optional[VocabCache] = None
        self._doc_freq: Dict[str, int] = {}
        self.n_docs = 0

    def _tokens(self, text: str) -> List[str]:
        return [t for t in self.tf.create(text).get_tokens()
                if t not in self.stop_words]

    def fit(self, documents: Sequence[str]) -> "BaseTextVectorizer":
        cache = VocabCache()
        self._doc_freq = {}
        n = 0
        for doc in documents:
            toks = self._tokens(doc)
            n += 1
            for t in toks:
                cache.add_token(t)
            for t in set(toks):
                self._doc_freq[t] = self._doc_freq.get(t, 0) + 1
        cache.finish(min_word_frequency=self.min_word_frequency)
        self.vocab = cache
        self.n_docs = n
        self._idf_vec = None  # invalidate any cached idf
        return self

    def vocab_size(self) -> int:
        return 0 if self.vocab is None else len(self.vocab)

    def _counts_row(self, text: str) -> np.ndarray:
        row = np.zeros(len(self.vocab), np.float32)
        for t in self._tokens(text):
            i = self.vocab.index_of(t)
            if i >= 0:
                row[i] += 1.0
        return row


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Document → term-count row (reference BagOfWordsVectorizer)."""

    def transform(self, text: str) -> np.ndarray:
        if self.vocab is None:
            raise RuntimeError("Call fit() first")
        return self._counts_row(text)

    def vectorize(self, text: str, label_idx: int,
                  num_labels: int) -> DataSet:
        """Reference vectorize(String, String) → DataSet."""
        x = self.transform(text)[None, :]
        y = np.zeros((1, num_labels), np.float32)
        y[0, label_idx] = 1.0
        return DataSet(x, y)


class TfidfVectorizer(BagOfWordsVectorizer):
    """Document → tf-idf row (reference TfidfVectorizer; smooth idf
    ln((1+N)/(1+df)) + 1)."""

    _idf_vec: Optional[np.ndarray] = None

    def _idf(self) -> np.ndarray:
        if self._idf_vec is None:  # constant after fit(): cache it
            idf = np.empty(len(self.vocab), np.float32)
            for i in range(len(self.vocab)):
                df = self._doc_freq.get(self.vocab.word_for_index(i), 0)
                idf[i] = math.log((1.0 + self.n_docs) / (1.0 + df)) + 1.0
            self._idf_vec = idf
        return self._idf_vec

    def transform(self, text: str) -> np.ndarray:
        counts = super().transform(text)
        total = max(counts.sum(), 1.0)
        return (counts / total) * self._idf()


class CnnSentenceDataSetIterator(DataSetIterator):
    """Sentences → [batch, max_len, embed] word-vector tensors + masks +
    one-hot labels (reference iterator/CnnSentenceDataSetIterator.java;
    RNN-style [b, t, f] layout — add a preprocessor or Conv1D on top, the
    framework's NHWC analog of the reference's CNN2D layout option)."""

    def __init__(self, word_vectors: WordVectors,
                 sentences: Sequence[Tuple[str, str]],
                 labels: Sequence[str], batch_size: int = 32,
                 max_length: Optional[int] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.wv = word_vectors
        self.data = list(sentences)  # (text, label)
        self.labels = list(labels)
        self._label_idx = {l: i for i, l in enumerate(self.labels)}
        self._batch = int(batch_size)
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.embed = word_vectors.get_word_vector_matrix().shape[1]
        if max_length is None:
            max_length = max(
                (len(self.tf.create(t).get_tokens()) for t, _ in self.data),
                default=1)
        self.max_length = int(max_length)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def batch_size(self):
        return self._batch

    def total_examples(self):
        return len(self.data)

    def __next__(self) -> DataSet:
        if self._pos >= len(self.data):
            raise StopIteration
        chunk = self.data[self._pos:self._pos + self._batch]
        self._pos += len(chunk)
        B, T, E = len(chunk), self.max_length, self.embed
        x = np.zeros((B, T, E), np.float32)
        mask = np.zeros((B, T), np.float32)
        y = np.zeros((B, len(self.labels)), np.float32)
        for b, (text, label) in enumerate(chunk):
            # Filter OOV FIRST, then truncate (reference
            # CnnSentenceDataSetIterator removes unknown words before
            # applying maxSentenceLength).
            vecs = [v for v in (self.wv.word_vector(tok) for tok in
                                self.tf.create(text).get_tokens())
                    if v is not None][:T]
            for t_out, v in enumerate(vecs):
                x[b, t_out] = v
                mask[b, t_out] = 1.0
            if not vecs:
                mask[b, 0] = 1.0  # keep the row alive (all-OOV sentence)
            y[b, self._label_idx[label]] = 1.0
        return DataSet(x, y, mask, None)


class Word2VecDataSetIterator(DataSetIterator):
    """Labelled sentences → RNN DataSets where every timestep is a word
    vector and the sentence label broadcasts over valid timesteps
    (reference iterator/Word2VecDataSetIterator.java: Word2Vec +
    LabelAwareSentenceIterator glue feeding recurrent nets; labels are
    set at each timestep with the mask marking real tokens)."""

    def __init__(self, word_vectors: WordVectors,
                 sentences: Sequence[Tuple[str, str]],
                 labels: Sequence[str], batch_size: int = 32,
                 max_length: Optional[int] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.wv = word_vectors
        self.labels = list(labels)
        self._label_idx = {l: i for i, l in enumerate(self.labels)}
        self._batch = int(batch_size)
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.embed = word_vectors.get_word_vector_matrix().shape[1]
        # tokenize ONCE: the init pass needs the lengths for max_length
        # anyway, and every epoch reuses the token lists
        self.data = [(self.tf.create(t).get_tokens(), lab)
                     for t, lab in sentences]
        if max_length is None:
            max_length = max((len(t) for t, _ in self.data), default=1)
        self.max_length = int(max_length)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def batch_size(self):
        return self._batch

    def total_examples(self):
        return len(self.data)

    def __next__(self) -> DataSet:
        if self._pos >= len(self.data):
            raise StopIteration
        chunk = self.data[self._pos:self._pos + self._batch]
        self._pos += len(chunk)
        B, T, E = len(chunk), self.max_length, self.embed
        L = len(self.labels)
        x = np.zeros((B, T, E), np.float32)
        y = np.zeros((B, T, L), np.float32)
        mask = np.zeros((B, T), np.float32)
        for b, (tokens, label) in enumerate(chunk):
            vecs = [v for v in (self.wv.word_vector(tok)
                                for tok in tokens)
                    if v is not None][:T]
            li = self._label_idx[label]
            for t_out, v in enumerate(vecs):
                x[b, t_out] = v
                y[b, t_out, li] = 1.0
                mask[b, t_out] = 1.0
            if not vecs:
                mask[b, 0] = 1.0
                y[b, 0, li] = 1.0
        return DataSet(x, y, mask, mask.copy())
